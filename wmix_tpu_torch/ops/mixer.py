"""The mix bus: bit-exact rebuild of wmix_load_data (src/wmix.c:1639-1957).

Port of `wmix_tpu/ops/mixer.py`.  The reference mixes each playing stream
into a 1-second ring buffer with a saturating int16 add, converting
sample-rate/channels on the fly with a float32 "div-step" pacer and a
linear-interpolation "repair" buffer for inserted frames.  Here that is:

  1. `build_contrib` (host, numpy): the exact sequence of engine frames the
     reference would emit, from the cached stepper patterns
     (data-independent, `ops/stepper.py` over its C helper) plus vectorized
     interpolation arithmetic that reproduces the C float32/int16 rounding
     bit for bit.  A copy of the reference's, with `_trunc_div` and
     `_copy_frames`.
  2. `device_mix` (torch): saturating scatter-add of those frames into the
     device-resident ring at (head + t) mod R: the part that runs per
     device step, and the part that batches across streams/engines.

`load_data` wires both together with the reference's head-placement and
tick bookkeeping against a host ring, as the daemon calls it; with
`use_device=True` the saturating mix runs through `device_mix` on the
device the caller names (the card unless it asks for the CPU).

Quirks reproduced: background streams are attenuated with a *truncating*
integer divide by reduceMode (src/wmix.c:1685), which `//` (a floor) is
not; the divide applies to repair frames at emission, not at
interpolation time (src/wmix.c:1823,1881); non-16-bit sources mix nothing
because the 8/32-bit switch arms are empty (src/wmix.c:1713-1718).
"""
from __future__ import annotations

import numpy as np
import torch

from wmix_tpu_torch.config import EngineConfig
from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.ops import stepper

I16_MIN, I16_MAX = -32768, 32767


# --------------------------------------------------------------------------
# host side: exact contribution stream
# --------------------------------------------------------------------------

def _trunc_div(v: np.ndarray, d: int) -> np.ndarray:
    """C integer division (truncate toward zero) on int32."""
    v = v.astype(np.int64)
    return np.where(v < 0, -((-v) // d), v // d)


def _copy_frames(src: np.ndarray, idx: np.ndarray, src_chn: int,
                 eng_chn: int) -> np.ndarray:
    """Channel-map gathered source frames [n, src_chn] -> [n, eng_chn].

    wmix_load_data writes the left sample to every engine channel for mono
    sources, and left/right (or left only) for stereo sources
    (src/wmix.c:1736-1745,1770-1779,1839-1848,1897-1905)."""
    g = src[idx]
    if src_chn == 1:
        return np.repeat(g, eng_chn, axis=1)
    return g[:, :eng_chn]


def build_contrib(cfg: EngineConfig, src: bytes | np.ndarray, freq: int,
                  chn: int, sample: int = 16) -> np.ndarray:
    """The exact engine frames wmix_load_data would emit for this source.

    Returns int16 [T, cfg.chn] — raw values, before the reduce divide."""
    raw = np.frombuffer(bytes(src), np.uint8) if isinstance(
        src, (bytes, bytearray)) else np.asarray(src, np.uint8)
    src_len = raw.size
    if src_len < 1:
        return np.zeros((0, cfg.chn), np.int16)
    if sample != 16:
        # the 8-bit / 32-bit switch arms are empty in the reference
        if freq == cfg.freq and chn == cfg.chn and sample == cfg.sample:
            pass  # unreachable: cfg.sample is always 16
        return np.zeros((0, cfg.chn), np.int16)

    frame_bytes = 2 * chn
    n_frames = -(-src_len // frame_bytes)
    # pad so the repair interpolation's read past the final sample is 0,
    # matching the padded oracle harness
    pcm = np.zeros((n_frames + 1) * chn, np.int16)
    usable = src_len // 2
    pcm[:usable] = raw[:usable * 2].view(np.int16)
    frames = pcm.reshape(n_frames + 1, chn)

    if freq == cfg.freq and chn == cfg.chn:
        # fast path: straight copy (src/wmix.c:1678-1702).  NB it walks in
        # engine-channel strides regardless of src length parity.
        out_samples = -(-src_len // 2)
        vals = np.zeros(((out_samples + cfg.chn - 1) // cfg.chn) * cfg.chn,
                        np.int16)
        vals[:usable] = pcm[:usable]
        return vals.reshape(-1, cfg.chn)

    if freq > cfg.freq:
        # skip direction: drop source frames (src/wmix.c:1707-1797)
        kept = stepper.load_skip_pattern(freq, cfg.freq, n_frames)
        return np.ascontiguousarray(
            _copy_frames(frames, kept, chn, cfg.chn), np.int16)

    # insert direction: interpolated repair frames (src/wmix.c:1799-1939)
    kind, si, k, dc2 = stepper.load_insert_pattern(freq, cfg.freq, n_frames)
    out = np.zeros((kind.size, cfg.chn), np.int16)
    is_copy = kind == stepper._COPY
    out[is_copy] = _copy_frames(frames, si[is_copy], chn, cfg.chn)

    ins = np.nonzero(~is_copy)[0]
    if ins.size:
        i = si[ins]
        kk = k[ins]
        d2 = dc2[ins]
        prev = frames[i - 1, 0].astype(np.int32)
        nxt = frames[i, 0].astype(np.int32)
        step = ((nxt - prev).astype(np.float32) /
                d2.astype(np.float32)).astype(np.float32)
        # repairStepSum accumulates one step per slot (src/wmix.c:1859-1864);
        # replicate the sequential float32 adds up to each slot's k
        acc = step.copy()
        val = np.where(kk == 0, acc, np.float32(0))
        for j in range(1, int(kk.max()) + 1 if kk.size else 1):
            acc = (acc + step).astype(np.float32)
            val = np.where(kk == j, acc, val)
        rep = (prev.astype(np.float32) + val).astype(np.int16)  # C trunc
        out[ins] = rep[:, None]
    return out


# --------------------------------------------------------------------------
# device side: saturating scatter-mix into the ring
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# the full wmix_load_data contract (host orchestration, device mixing)
# --------------------------------------------------------------------------

def load_data(cfg: EngineConfig, ring: np.ndarray, head_off: int,
              wmix_head_off: int, wmix_tick: int, reduce_mode: int,
              src, freq: int, chn: int, sample: int = 16, reduce: int = 0,
              tick: int = 0, use_device: bool = False, device=None):
    """Bit-exact wmix_load_data against a numpy int16 ring [R, chn].

    Returns (new_head_off_bytes, new_tick).  Mutates `ring` in place.
    With use_device=True the saturating mix runs through `device_mix` on
    `device` (None: the card), identical semantics: one copy of the ring
    there and one back."""
    raw = bytes(src) if isinstance(src, (bytes, bytearray)) else \
        np.asarray(src, np.uint8).tobytes()
    if len(raw) < 1:
        return head_off, tick

    frame_size = cfg.frame_size
    buff_size = cfg.buff_size

    # head placement (src/wmix.c:1666-1673)
    if head_off < 0 or tick < wmix_tick:
        head_off = wmix_head_off + cfg.play_correct
        tick = wmix_tick + cfg.play_correct
        if head_off >= buff_size:
            head_off = 0

    rdce = 1 if reduce == reduce_mode else reduce_mode
    contrib = build_contrib(cfg, raw, freq, chn, sample)
    tick_add = contrib.size * 2  # bytes written

    if contrib.size:
        head_frame = head_off // frame_size
        R = cfg.ring_frames
        if use_device:
            dring = torch.from_numpy(ring).to(resolve_device(device))
            for s in range(0, contrib.shape[0], R):
                blk = torch.from_numpy(np.ascontiguousarray(
                    contrib[s:s + R]))
                device_mix(dring, (head_frame + s) % R, blk, rdce)
            ring[...] = dring.cpu().numpy()
        else:
            for s in range(0, contrib.shape[0], R):
                blk = contrib[s:s + R]
                pos = (head_frame + s + np.arange(blk.shape[0])) % R
                q = _trunc_div(blk, rdce)
                ring[pos] = np.clip(ring[pos].astype(np.int64) + q,
                                    I16_MIN, I16_MAX).astype(np.int16)
        head_off = ((head_frame + contrib.shape[0]) % R) * frame_size

    # final tick bookkeeping (src/wmix.c:1942-1955)
    if tick < wmix_tick:
        head_off = wmix_head_off + tick_add
        tick_add += wmix_tick
        if head_off >= buff_size:
            head_off -= buff_size
    else:
        tick_add += tick
    return head_off, tick_add
