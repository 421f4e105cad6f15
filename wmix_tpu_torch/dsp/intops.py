"""Exact fixed-point primitives shared by the AGC and VAD.

Port of `wmix_tpu/dsp/intops.py` on torch tensors:

  * int32 values live in int32 tensors; torch's int32 arithmetic wraps
    like C's two's complement and its shifts follow XLA's (a left shift by
    >= 32 gives 0, an arithmetic right shift by >= 32 gives the sign);
  * uint32 values live in int64 tensors holding 0 .. 2**32-1, because
    torch's uint32 supports few ops;
  * C division truncates toward zero: `torch.div(..., rounding_mode=
    "trunc")`, never `//`.

The reference's bit-serial divisions exist only because TPU integer
division is inexact; torch division is exact, so they are not carried.
"""
from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
U32_MASK = 0xFFFFFFFF


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """int16 storage of an integer value (two's complement wrap), kept as
    int32 for further arithmetic."""
    return x.to(torch.int16).to(I32)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage of an int64 value (two's complement wrap)."""
    return x.to(I32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an int32 value, as int64."""
    return x.to(I64) & U32_MASK


def div_trunc(num: torch.Tensor, den) -> torch.Tensor:
    """C int32 division: truncation toward zero.  Divides in int64, so
    INT32_MIN / -1 wraps to INT32_MIN as the reference's exact division
    does, instead of trapping."""
    den = den.to(I64) if isinstance(den, torch.Tensor) else den
    return wrap32(torch.div(num.to(I64), den, rounding_mode="trunc"))


def div_w32_w16(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_DivW32W16: |num| / (|den| & 0xFFFF) truncated, sign
    restored, 0x7FFFFFFF for den == 0 (the reference's exact form)."""
    num = num.to(I64)
    den = den.to(I64)
    na = num.abs() & U32_MASK            # |INT32_MIN| = 0x80000000
    da = den.abs() & 0xFFFF
    q = torch.where(da == 0, torch.full_like(na, U32_MASK),
                    torch.div(na, da.clamp_min(1), rounding_mode="trunc"))
    qi = q.to(I32)                       # uint32 -> int32 wrap
    neg = (num < 0) ^ (den < 0)
    qi = torch.where(neg, -qi, qi)
    return torch.where(den == 0, torch.full_like(qi, 0x7FFFFFFF), qi)


def _clz_cascade(v: torch.Tensor, masks) -> torch.Tensor:
    zeros = torch.zeros_like(v)
    for m, n in masks:
        s = (v << zeros) & U32_MASK
        zeros = zeros + torch.where((s & m) == 0, n, 0)
    return zeros


def norm_w32(a: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_NormW32: redundant sign bits of an int32; 0 for a == 0."""
    a = a.to(I64)
    v = torch.where(a < 0, ~a, a) & U32_MASK
    zeros = _clz_cascade(v, ((0xFFFF8000, 16), (0xFF800000, 8),
                             (0xF8000000, 4), (0xE0000000, 2),
                             (0xC0000000, 1)))
    return torch.where(a == 0, 0, zeros).to(I32)


def norm_u32(a: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_NormU32: leading zeros of a uint32 (int64-held); 0 for
    a == 0."""
    a = a.to(I64) & U32_MASK
    zeros = _clz_cascade(a, ((0xFFFF0000, 16), (0xFF000000, 8),
                             (0xF0000000, 4), (0xC0000000, 2),
                             (0x80000000, 1)))
    return torch.where(a == 0, 0, zeros).to(I32)


def sat_w16(x: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_SatW32ToW16."""
    return x.clamp(-32768, 32767).to(I32)


def add_sat_w16(a, b) -> torch.Tensor:
    """WebRtcSpl_AddSatW16 on int16 values held in int32."""
    return (a + b).clamp(-32768, 32767).to(I32)


def add_sat_w32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_AddSatW32: int32 saturating add."""
    return (a.to(I64) + b.to(I64)).clamp(-0x80000000, 0x7FFFFFFF).to(I32)


def sqrt_floor(value: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_SqrtFloor: bitwise integer square root of an int32."""
    value = value.to(I32)
    root = torch.zeros_like(value)
    for shift in range(15, -1, -1):
        try1 = root + (1 << shift)
        t = wrap32((try1.to(I64) << shift) & U32_MASK)
        take = value >= t
        value = torch.where(take, value - t, value)
        root = torch.where(take, root | (2 << shift), root)
    return root >> 1


def div_u32_u16(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_DivU32U16 on int64-held uint32; 0xFFFFFFFF for den == 0."""
    num = num.to(I64) & U32_MASK
    den = den.to(I64) & 0xFFFF
    q = torch.div(num, den.clamp_min(1), rounding_mode="trunc")
    return torch.where(den == 0, torch.full_like(q, U32_MASK), q)
