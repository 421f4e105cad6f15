"""The port's device rule: the card unless the caller asks for the CPU.

Every entry point that takes `device` passes it through `resolve_device`:
`None` means "cuda", and asking for a CUDA device where none is present
raises.  Nothing moves to the CPU silently; the CPU tests pass
`device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, with None meaning "cuda"; raises
    RuntimeError when a CUDA device is wanted and none is present, or
    `cuda:N` with N beyond the devices present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"wmix_tpu_torch: device '{device}' wanted (the default is the "
            "card), but no CUDA device is present; pass device=\"cpu\" to "
            "run on the CPU")
    if device.type == "cuda" and device.index is not None:
        count = torch.cuda.device_count()
        if device.index >= count:
            raise RuntimeError(
                f"wmix_tpu_torch: device '{device}' wanted, but only {count} "
                f"CUDA device(s) are present (cuda:0 to cuda:{count - 1})")
    return device

