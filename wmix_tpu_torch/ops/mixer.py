"""The mix bus, device half: the saturating scatter-mix of
wmix_load_data (src/wmix.c:1639-1957) into the device-resident ring.

Port of `device_mix` of `wmix_tpu/ops/mixer.py`.  The host half there
(`build_contrib`, `load_data`: the exact rate/channel conversion, with its
C stepper helper) is host code and is not part of this module yet; tests
take contributions from the original's `build_contrib`.

Quirk reproduced: background streams are attenuated with a *truncating*
integer divide by reduceMode (src/wmix.c:1685), which `//` (a floor) is
not.
"""
from __future__ import annotations

import torch

I16_MIN, I16_MAX = -32768, 32767


def mix_frames(cur: torch.Tensor, contrib: torch.Tensor,
               rdce) -> torch.Tensor:
    """The mixer's arithmetic on gathered ring frames: int16 `cur` plus
    int16 `contrib` divided by `rdce` (an int or a broadcastable int32
    tensor) toward zero, saturated to int16."""
    q = torch.div(contrib.to(torch.int32), rdce, rounding_mode="trunc")
    return (cur.to(torch.int32) + q).clamp_(I16_MIN, I16_MAX).to(
        torch.int16)


def device_mix(ring: torch.Tensor, head_frame: int, contrib: torch.Tensor,
               rdce: int) -> torch.Tensor:
    """Saturating add of contrib [T, chn] into ring [R, chn] at
    (head_frame + t) mod R, with the truncating reduce divide.  In place;
    returns the ring.

    T must be <= R (the host chunks longer loads, as the daemon's pacing
    does naturally), so the positions are distinct."""
    T, R = contrib.shape[0], ring.shape[0]
    if T > R:
        raise ValueError(f"contribution of {T} frames exceeds the ring's "
                         f"{R}")
    pos = (int(head_frame) + torch.arange(T, device=ring.device)) % R
    ring[pos] = mix_frames(ring[pos], contrib.to(ring.device), int(rdce))
    return ring
