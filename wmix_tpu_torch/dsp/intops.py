"""Exact fixed-point primitives shared by the AGC, VAD, NSX and AECM.

Port of `wmix_tpu/dsp/intops.py` on torch tensors:

  * int32 values live in int32 tensors; torch's int32 arithmetic wraps
    like C's two's complement and its shifts follow XLA's (a left shift by
    >= 32 gives 0, an arithmetic right shift by >= 32 gives the sign);
  * uint32 values live in int64 tensors holding 0 .. 2**32-1, because
    torch's uint32 supports few ops;
  * C division truncates toward zero: `torch.div(..., rounding_mode=
    "trunc")`, never `//`.

The reference's bit-serial divisions exist only because TPU integer
division is inexact; torch division is exact, so they are not carried:
the `*_exact` names divide directly.  A zero denominator is replaced
before the division and the reference's result selected after it, since
the CPU raises on an integer division by zero and the card returns an
unspecified value.

Shift counts out of range: torch gives 0 for a left shift and the sign
for a right shift by a negative count or one >= the width, as XLA does;
uint32 values held in int64 are masked to 32 bits after a left shift.
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


def downmix(x: torch.Tensor, chn: int) -> torch.Tensor:
    """The daemon wrappers' mono downmix of an interleaved package
    [B, frames * chn] -> [B, frames]: the channel sum divided by `chn` as
    C divides, truncating toward zero (src/webrtc.c:100-110, 780-790)."""
    if chn == 1:
        return x
    s = x.reshape(x.shape[0], -1, chn).sum(dim=2)
    return torch.div(s, chn, rounding_mode="trunc").to(x.dtype)


def _den_safe(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den == 0, torch.ones_like(den), den)


def div_w32_w16(num, den) -> torch.Tensor:
    """WebRtcSpl_DivW32W16: |num| / (|den| & 0xFFFF) truncated (0xFFFFFFFF
    when that is 0), the sign restored, int32 wrap; 0x7FFFFFFF for
    den == 0."""
    num = num.to(I64)
    den = den.to(I64)
    na = num.abs() & U32_MASK
    da = den.abs() & 0xFFFF
    q = torch.where(da == 0, U32_MASK,
                    torch.div(na, _den_safe(da), rounding_mode="trunc"))
    qi = wrap32(q).to(I64)
    qi = wrap32(torch.where((num < 0) ^ (den < 0), -qi, qi))
    return torch.where(den == 0, 0x7FFFFFFF, qi)


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


def shr_u32(x, n) -> torch.Tensor:
    """Logical right shift of an int64-held uint32 by a count that may be a
    tensor; a count below 0 or above 31 gives 0, as XLA's uint32 shift."""
    x = torch.as_tensor(x).to(I64) & U32_MASK
    n = torch.as_tensor(n, device=x.device).to(I64)
    return torch.where((n < 0) | (n > 31), 0, x >> n.clamp(0, 31))


def norm_w16(a: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_NormW16: redundant sign bits of an int16 value (held in
    int32, wrapped to int16 first); 0 for a == 0."""
    a = wrap16(a)
    v = torch.where(a < 0, ~a, a) & 0x7FFF
    zeros = torch.zeros_like(v)
    for m, n in ((0x7F80, 8), (0x7800, 4), (0x6000, 2), (0x4000, 1)):
        zeros = zeros + torch.where(((v << zeros) & m) == 0, n, 0)
    return torch.where(a == 0, 0, zeros).to(I32)


def shift_w32(x, c) -> torch.Tensor:
    """WEBRTC_SPL_SHIFT_W32: left shift (int32 wrap) when c >= 0, arithmetic
    right shift otherwise; the count is clipped to 31 either way."""
    x = torch.as_tensor(x).to(I32)
    c = torch.as_tensor(c, device=x.device).to(I32)
    return torch.where(c >= 0, x << c.clamp(0, 31), x >> (-c).clamp(0, 31))


def shift_u32(x, c) -> torch.Tensor:
    """WEBRTC_SPL_SHIFT_U32 on an int64-held uint32: left shift (mod 2^32)
    when c >= 0, logical right shift otherwise, the count clipped to 31."""
    x = torch.as_tensor(x).to(I64) & U32_MASK
    c = torch.as_tensor(c, device=x.device).to(I64)
    return torch.where(c >= 0, (x << c.clamp(0, 31)) & U32_MASK,
                       x >> (-c).clamp(0, 31))


def popcount32(a: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 32 bits, as int32."""
    v = a.to(I64) & U32_MASK
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & U32_MASK) >> 24).to(I32)


def mul_16_u16(a, b) -> torch.Tensor:
    """WEBRTC_SPL_MUL_16_U16: the low 32 bits of a * (b & 0xFFFF), as
    int32."""
    return wrap32((a.to(I64) & U32_MASK) * (b.to(I64) & 0xFFFF))


def div_u32_u32(num, den, zero_result: int = U32_MASK) -> torch.Tensor:
    """uint32 / uint32 (int64-held), truncating; `zero_result` for
    den == 0."""
    num = num.to(I64) & U32_MASK
    den = den.to(I64) & U32_MASK
    q = torch.div(num, _den_safe(den), rounding_mode="trunc")
    return torch.where(den == 0, zero_result & U32_MASK, q)


div_w32_w16_exact = div_w32_w16    # the reference's name at NSX/AECM sites


def div_w32_w32_exact(num, den) -> torch.Tensor:
    """C int32 / int32, truncating toward zero (INT32_MIN / -1 wraps to
    INT32_MIN); 0x7FFFFFFF for den == 0, the guard of the NSX call
    sites."""
    num = num.to(I64)
    den = den.to(I64)
    q = torch.div(num.abs(), _den_safe(den.abs()), rounding_mode="trunc")
    q = wrap32(torch.where((num < 0) ^ (den < 0), -q, q))
    return torch.where(den == 0, 0x7FFFFFFF, q)
