"""The port's device rule: the card unless the caller asks for the CPU.

Every entry point that takes `device` passes it through `resolve_device`:
`None` means "cuda", and asking for a CUDA device where none is present
raises.  Nothing moves to the CPU silently; the CPU tests pass
`device="cpu"`.
"""
from __future__ import annotations

import subprocess

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


def describe(device: torch.device) -> str:
    """What a measurement ran on: for a CUDA device the card's name and
    power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (a card set below its maximum power
    runs slower under load), else the device's type."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(index)} (nvidia-smi: {e})"
    if res.returncode != 0:
        return (f"{torch.cuda.get_device_name(index)} (nvidia-smi: "
                f"{res.stderr.strip()})")
    return res.stdout.strip()
