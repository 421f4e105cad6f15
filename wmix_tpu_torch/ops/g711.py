"""G.711 A-law / mu-law codec as table lookups.

Port of `wmix_tpu/ops/g711.py`.  The reference implements the classic
ITU-T G.711 branch/shift code (src/g711codec.c:28-152).  On an accelerator
the natural form is a gather: the encode map is a 65536-entry uint8 table
over all int16 inputs and the decode map a 256-entry int16 table, both
generated here from first principles with exact integer arithmetic (a
copy of the original's generator, tested equal to it).  The device ops
gather from tables that stay resident on the input's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_SEG_END = np.array([0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF, 0x3FFF,
                     0x7FFF], np.int64)
_BIAS = 0x84


@functools.lru_cache(maxsize=None)
def _tables():
    pcm = np.arange(-32768, 32768, dtype=np.int64)

    # ---- linear -> A-law (g711codec.c:82-114) ----
    mask_a = np.where(pcm >= 0, 0xD5, 0x55)
    mag = np.where(pcm >= 0, pcm, -pcm - 8)
    seg = np.searchsorted(_SEG_END, mag, side="left")
    shift = np.where(seg < 2, 4, seg + 3)
    aval = (seg << 4) | ((mag >> shift) & 0xF)
    alaw = np.where(seg >= 8, 0x7F ^ mask_a, aval ^ mask_a).astype(np.uint8)

    # ---- linear -> mu-law (g711codec.c:120-152) ----
    mask_u = np.where(pcm < 0, 0x7F, 0xFF)
    magu = np.where(pcm < 0, _BIAS - pcm, pcm + _BIAS)
    segu = np.searchsorted(_SEG_END, magu, side="left")
    uval = (segu << 4) | ((magu >> (segu + 3)) & 0xF)
    ulaw = np.where(segu >= 8, 0x7F ^ mask_u, uval ^ mask_u).astype(np.uint8)

    # ---- A-law -> linear (g711codec.c:28-50) ----
    a = np.arange(256, dtype=np.int64) ^ 0x55
    t = (a & 0xF) << 4
    sega = (a & 0x70) >> 4
    t = np.where(sega == 0, t + 8,
                 np.where(sega == 1, t + 0x108,
                          (t + 0x108) << np.maximum(sega - 1, 0)))
    alaw_dec = np.where(a & 0x80, t, -t).astype(np.int16)

    # ---- mu-law -> linear (g711codec.c:61-76) ----
    u = (~np.arange(256, dtype=np.int64)) & 0xFF
    tu = (((u & 0xF) << 3) + _BIAS) << ((u & 0x70) >> 4)
    ulaw_dec = np.where(u & 0x80, _BIAS - tu, tu - _BIAS).astype(np.int16)

    for tab in (alaw, ulaw, alaw_dec, ulaw_dec):
        tab.setflags(write=False)     # one cached copy serves every caller
    return alaw, ulaw, alaw_dec, ulaw_dec


def tables():
    """(encode_alaw[65536], encode_ulaw[65536], decode_alaw[256],
    decode_ulaw[256]) as (read-only) numpy arrays."""
    return _tables()


# ---- device ops (gathers from device-resident tables) ----

@functools.lru_cache(maxsize=None)
def _lut(which: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_tables()[which].copy()).to(device)


def _encode(which: int, pcm: torch.Tensor) -> torch.Tensor:
    if pcm.dtype != torch.int16:
        raise ValueError(f"G.711 encodes int16 PCM, got {pcm.dtype}")
    return _lut(which, pcm.device)[pcm.to(torch.int64) + 32768]


def _decode(which: int, code: torch.Tensor) -> torch.Tensor:
    if code.dtype != torch.uint8:
        raise ValueError(f"G.711 decodes uint8 codes, got {code.dtype}")
    return _lut(which, code.device)[code.long()]


def encode_alaw(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> uint8 A-law, any shape, on the input's device."""
    return _encode(0, pcm)


def encode_ulaw(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> uint8 mu-law."""
    return _encode(1, pcm)


def decode_alaw(alaw: torch.Tensor) -> torch.Tensor:
    """uint8 A-law -> int16 PCM."""
    return _decode(2, alaw)


def decode_ulaw(ulaw: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law -> int16 PCM."""
    return _decode(3, ulaw)


# ---- numpy conveniences for host paths ----

def np_encode_alaw(pcm) -> np.ndarray:
    return _tables()[0][np.asarray(pcm, np.int64) + 32768]


def np_encode_ulaw(pcm) -> np.ndarray:
    return _tables()[1][np.asarray(pcm, np.int64) + 32768]


def np_decode_alaw(alaw) -> np.ndarray:
    return _tables()[2][np.asarray(alaw, np.int64)]


def np_decode_ulaw(ulaw) -> np.ndarray:
    return _tables()[3][np.asarray(ulaw, np.int64)]
