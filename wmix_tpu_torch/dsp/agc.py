"""Automatic gain control: the webrtc legacy AGC's digital path, batched.

Port of `wmix_tpu/dsp/agc.py` (digital_agc.c): the 32-entry compressor
gain table (host numpy, copied), and per 10 ms subpackage the AGC's own
VAD (allpass decimator, high-pass energy, fixed-point sqrt), the fast/slow
capacitor envelope, gain interpolation, speech gate, overload limiting and
the two-segment gain ramp.  All arithmetic is int32 with C wrap and shift
semantics (see `intops`); every state leaf carries a leading stream axis.

The per-sample recursions (decimator, high-pass) and the limiter's
while-loop are Python loops over [B] tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.intops import (I32, I64, add_sat_w16, div_trunc,
                                       downmix, norm_u32, norm_w32, sat_w16,
                                       wrap16)
from wmix_tpu_torch.utils.turns import read_bool

# kGenFuncTable: y = log2(1+e^x) in Q8 (digital_agc.c:40-57)
GEN_FUNC_TABLE = np.array([
    256, 485, 786, 1126, 1484, 1849, 2217, 2586,
    2955, 3324, 3693, 4063, 4432, 4801, 5171, 5540,
    5909, 6279, 6648, 7017, 7387, 7756, 8125, 8495,
    8864, 9233, 9603, 9972, 10341, 10711, 11080, 11449,
    11819, 12188, 12557, 12927, 13296, 13665, 14035, 14404,
    14773, 15143, 15512, 15881, 16251, 16620, 16989, 17359,
    17728, 18097, 18466, 18836, 19205, 19574, 19944, 20313,
    20682, 21052, 21421, 21790, 22160, 22529, 22898, 23268,
    23637, 24006, 24376, 24745, 25114, 25484, 25853, 26222,
    26592, 26961, 27330, 27700, 28069, 28438, 28808, 29177,
    29546, 29916, 30285, 30654, 31024, 31393, 31762, 32132,
    32501, 32870, 33240, 33609, 33978, 34348, 34717, 35086,
    35456, 35825, 36194, 36564, 36933, 37302, 37672, 38041,
    38410, 38780, 39149, 39518, 39888, 40257, 40626, 40996,
    41365, 41734, 42104, 42473, 42842, 43212, 43581, 43950,
    44320, 44689, 45058, 45428, 45797, 46166, 46536, 46905],
    np.int64)

AVG_DECAY_TIME = 250

# UpdateAgcThresholds constants (analog_agc.c; analog_agc.h)
DIFF_REF_TO_ANALOG = 5
ANALOG_TARGET_LEVEL = 11
ANALOG_TARGET_LEVEL_2 = 5
DIGITAL_REF_AT_0_COMP_GAIN = 4

# WebRtcSpl_DownsampleBy2 allpass coefficients (resample_by_2.c)
RESAMPLE_ALLPASS_1 = (3284, 24441, 49528)
RESAMPLE_ALLPASS_2 = (12199, 37471, 60255)


def _div_round_c(num: int, den: int) -> int:
    """C truncating division on ints (host)."""
    q = abs(num) // abs(den)
    return -q if (num < 0) != (den < 0) else q


def analog_target(compression_gain_db: int, agc_mode_fixed: bool = False
                  ) -> int:
    """analogTarget of WebRtcAgc_UpdateAgcThresholds (analog_agc.c:437)."""
    tmp16 = DIFF_REF_TO_ANALOG * compression_gain_db + ANALOG_TARGET_LEVEL_2
    tmp16 = _div_round_c(tmp16, ANALOG_TARGET_LEVEL)
    target = DIGITAL_REF_AT_0_COMP_GAIN + tmp16
    if target < DIGITAL_REF_AT_0_COMP_GAIN:
        target = DIGITAL_REF_AT_0_COMP_GAIN
    if agc_mode_fixed:
        target = compression_gain_db
    return target


def _norm_w32_host(a: int) -> int:
    if a == 0:
        return 0
    if a < 0:
        a = ~a & 0xFFFFFFFF
    zeros = 0
    for bit in range(30, -1, -1):
        if a & (1 << bit):
            break
        zeros += 1
    return zeros


def _norm_u32_host(a: int) -> int:
    if a == 0:
        return 0
    zeros = 0
    for bit in range(31, -1, -1):
        if a & (1 << bit):
            break
        zeros += 1
    return zeros


@functools.lru_cache(maxsize=None)
def gain_table(compression_gain_db: int, target_level_dbfs: int = 0,
               limiter_enable: int = 0) -> np.ndarray:
    """WebRtcAgc_CalculateGainTable (digital_agc.c:61-257), host-exact.
    Returns int64[32] in Q16."""
    a_target = analog_target(compression_gain_db)
    kLog10 = 54426
    kLog10_2 = 49321
    kLogE_1 = 23637
    kCompRatio = 3
    kSoftLimiterLeft = 1
    limiterOffset = 0

    def i16(x):
        return ((int(x) + 0x8000) & 0xFFFF) - 0x8000

    def i32(x):
        return ((int(x) + 0x80000000) & 0xFFFFFFFF) - 0x80000000

    tmp32no1 = (compression_gain_db - a_target) * (kCompRatio - 1)
    tmp16no1 = a_target - target_level_dbfs
    tmp16no1 += i16(_div_round_c(tmp32no1 + (kCompRatio >> 1), kCompRatio))
    maxGain = max(tmp16no1, a_target - target_level_dbfs)
    tmp32no1 = maxGain * kCompRatio
    zeroGainLvl = compression_gain_db
    zeroGainLvl -= i16(_div_round_c(tmp32no1 + ((kCompRatio - 1) >> 1),
                                    kCompRatio - 1))
    if compression_gain_db <= a_target and limiter_enable:
        zeroGainLvl += a_target - compression_gain_db + kSoftLimiterLeft
        limiterOffset = 0

    tmp32no1 = compression_gain_db * (kCompRatio - 1)
    diffGain = i16(_div_round_c(tmp32no1 + (kCompRatio >> 1), kCompRatio))
    if not 0 <= diffGain < len(GEN_FUNC_TABLE):
        raise ValueError(f"compression gain {compression_gain_db} dB is "
                         "outside the gain table")

    limiterLvlX = a_target - limiterOffset
    limiterIdx = 2 + i16(_div_round_c(i32(limiterLvlX << 13),
                                      kLog10_2 // 2))
    tmp16no1 = i16(_div_round_c(limiterOffset + (kCompRatio >> 1),
                                kCompRatio))
    limiterLvl = target_level_dbfs + tmp16no1

    constMaxGain = int(GEN_FUNC_TABLE[diffGain])
    constLinApprox = 22817
    den = 20 * constMaxGain

    table = np.zeros(32, np.int64)
    for i in range(32):
        tmp16 = i16((kCompRatio - 1) * (i - 1))
        tmp32 = i32(tmp16 * kLog10_2 + 1)
        inLevel = _div_round_c(tmp32, kCompRatio)
        inLevel = i32((diffGain << 14) - inLevel)
        absInLevel = abs(inLevel) & 0xFFFFFFFF

        intPart = (absInLevel >> 14) & 0xFFFF
        fracPart = absInLevel & 0x3FFF
        tmpU16 = (int(GEN_FUNC_TABLE[intPart + 1]) -
                  int(GEN_FUNC_TABLE[intPart])) & 0xFFFF
        tmpU32no1 = (tmpU16 * fracPart) & 0xFFFFFFFF
        tmpU32no1 = (tmpU32no1 + (int(GEN_FUNC_TABLE[intPart]) << 14)) \
            & 0xFFFFFFFF
        logApprox = tmpU32no1 >> 8
        if inLevel < 0:
            zeros = _norm_u32_host(absInLevel)
            zerosScale = 0
            if zeros < 15:
                tmpU32no2 = absInLevel >> (15 - zeros)
                tmpU32no2 = (tmpU32no2 * kLogE_1) & 0xFFFFFFFF
                if zeros < 9:
                    zerosScale = 9 - zeros
                    tmpU32no1 >>= zerosScale
                else:
                    tmpU32no2 >>= zeros - 9
            else:
                tmpU32no2 = (absInLevel * kLogE_1) & 0xFFFFFFFF
                tmpU32no2 >>= 6
            logApprox = 0
            if tmpU32no2 < tmpU32no1:
                logApprox = (tmpU32no1 - tmpU32no2) >> (8 - zerosScale)
        numFIX = i32((maxGain * constMaxGain) << 6)
        numFIX = i32(numFIX - i32(i32(logApprox) * diffGain))

        if numFIX > (den >> 8):
            zeros = _norm_w32_host(numFIX)
        else:
            zeros = _norm_w32_host(den) + 8
        numFIX = i32(numFIX << zeros)

        tmp32no1 = i32(den << (zeros - 8)) if zeros >= 8 else \
            den >> (8 - zeros)
        if numFIX < 0:
            numFIX -= _div_round_c(tmp32no1, 2)
        else:
            numFIX += _div_round_c(tmp32no1, 2)
        y32 = _div_round_c(numFIX, tmp32no1)
        if limiter_enable and i < limiterIdx:
            tmp32 = i32(i16(i - 1) * kLog10_2)
            tmp32 = i32(tmp32 - (limiterLvl << 14))
            y32 = _div_round_c(tmp32 + 10, 20)
        if y32 > 39000:
            tmp32 = i32((y32 >> 1) * kLog10 + 4096)
            tmp32 >>= 13
        else:
            tmp32 = i32(y32 * kLog10 + 8192)
            tmp32 >>= 14
        tmp32 += 16 << 14

        if tmp32 > 0:
            intPart = tmp32 >> 14
            fracPart = tmp32 & 0x3FFF
            if (fracPart >> 13) != 0:
                tmp16 = (2 << 14) - constLinApprox
                tmp32no2 = (1 << 14) - fracPart
                tmp32no2 = i32(tmp32no2 * tmp16)
                tmp32no2 >>= 13
                tmp32no2 = (1 << 14) - tmp32no2
            else:
                tmp16 = constLinApprox - (1 << 14)
                tmp32no2 = i32(fracPart * tmp16) >> 13
            fracPart = tmp32no2 & 0xFFFF
            shifted = (fracPart << (intPart - 14)) if intPart >= 14 \
                else (fracPart >> (14 - intPart))
            table[i] = i32((1 << intPart) + shifted)
        else:
            table[i] = 0
    return table


class AgcState(NamedTuple):
    """DigitalAgc + AgcVad state (digital_agc.h); int32 leaves [B, ...]."""
    capacitor_slow: torch.Tensor
    capacitor_fast: torch.Tensor
    gain: torch.Tensor
    gate_previous: torch.Tensor
    hp_state: torch.Tensor
    log_ratio: torch.Tensor
    mean_long_term: torch.Tensor
    variance_long_term: torch.Tensor
    std_long_term: torch.Tensor
    mean_short_term: torch.Tensor
    variance_short_term: torch.Tensor
    std_short_term: torch.Tensor
    counter: torch.Tensor
    down_state: torch.Tensor   # [B, 8]


def init_state(batch: int, device=None) -> AgcState:
    """WebRtcAgc_InitDigital + InitVad (digital_agc.c:259-282, 606-631),
    adaptive-digital mode, for B streams."""
    device = resolve_device(device)
    def s(v):
        return torch.full((batch,), v, dtype=I32, device=device)
    return AgcState(
        capacitor_slow=s(134217728), capacitor_fast=s(0), gain=s(65536),
        gate_previous=s(0), hp_state=s(0), log_ratio=s(0),
        mean_long_term=s(15 << 10), variance_long_term=s(500 << 8),
        std_long_term=s(0), mean_short_term=s(15 << 10),
        variance_short_term=s(500 << 8), std_short_term=s(0),
        counter=s(3),
        down_state=torch.zeros((batch, 8), dtype=I32, device=device))


# ---------------------------------------------------- fixed-point helpers

def _scalediff32(a, b, c):
    """AGC_SCALEDIFF32 (digital_agc.h:23)."""
    return c + (b >> 16) * a + (((b & 0xFFFF) * a) >> 16)


def _mul32(a, b):
    """AGC_MUL32 (digital_agc.h:21)."""
    return (b >> 13) * a + (((b & 0x1FFF) * a) >> 13)


def _mul_accum(a: int, b, c):
    """WEBRTC_SPL_SCALEDIFF32: the low half product in uint32 with a
    logical shift."""
    lo = (((b & 0xFFFF).to(I64) * a) >> 16).to(I32)
    return c + (b >> 16) * a + lo


def _sqrt_local(inp):
    """WebRtcSpl_SqrtLocal (spl_sqrt.c:24-70)."""
    B = div_trunc(inp, 2)
    B = B - 0x40000000
    x_half = wrap16(B >> 16)
    B = B + 0x40000000
    B = B + 0x40000000
    x2 = x_half * x_half * 2
    A = -x2
    B = B + (A >> 1)
    A = A >> 16
    A = A * A * 2
    t16 = wrap16(A >> 16)
    B = B + -20480 * t16 * 2
    A = x_half * t16 * 2
    t16 = wrap16(A >> 16)
    B = B + 28672 * t16 * 2
    t16 = wrap16(x2 >> 16)
    A = x_half * t16 * 2
    B = B + (A >> 1)
    return B + 32768


def _spl_sqrt(value):
    """WebRtcSpl_Sqrt (spl_sqrt.c:71-184), literal replication."""
    A = value.to(I32)
    sh = norm_w32(A)
    An = A << sh
    An = torch.where(An < 0x7FFFFFFF - 32767, An + 32768, 0x7FFFFFFF)
    x_norm = wrap16(An >> 16)
    nshift = div_trunc(sh, 2)
    A2 = (x_norm << 16).abs()
    A3 = _sqrt_local(A2)
    even = (2 * nshift) == sh

    t16 = wrap16(A3 >> 16)
    Ae = 23170 * t16 * 2
    Ae = Ae + 32768
    Ae = Ae & 0x7FFF0000
    Ae = Ae >> 15
    Ao = A3 >> 16

    res = torch.where(even, Ae, Ao) & 0x0000FFFF
    res = res >> nshift.clamp(0, 31)
    return torch.where(value == 0, 0, res).to(I32)


# ------------------------------------ decimator + VAD (digital_agc.c:633-771)

def _downsample_by2(samples, state):
    """WebRtcSpl_DownsampleBy2 over [B, 2n] samples, state [B, 8]; the
    recursion runs sample pair by pair."""
    s = [state[:, i] for i in range(8)]
    a1, a2 = RESAMPLE_ALLPASS_1, RESAMPLE_ALLPASS_2
    outs = []
    for p in range(samples.shape[1] // 2):
        s0, s1, s2, s3, s4, s5, s6, s7 = s
        in32 = samples[:, 2 * p] << 10
        tmp1 = _mul_accum(a2[0], in32 - s1, s0)
        s0 = in32
        tmp2 = _mul_accum(a2[1], tmp1 - s2, s1)
        s1 = tmp1
        s3 = _mul_accum(a2[2], tmp2 - s3, s2)
        s2 = tmp2
        in32 = samples[:, 2 * p + 1] << 10
        tmp1 = _mul_accum(a1[0], in32 - s5, s4)
        s4 = in32
        tmp2 = _mul_accum(a1[1], tmp1 - s6, s5)
        s5 = tmp1
        s7 = _mul_accum(a1[2], tmp2 - s7, s6)
        s6 = tmp2
        outs.append(sat_w16((s3 + s7 + 1024) >> 11))
        s = (s0, s1, s2, s3, s4, s5, s6, s7)
    return torch.stack(outs, dim=1), torch.stack(s, dim=1)


def _process_vad(st: AgcState, samples, nr_samples: int):
    """WebRtcAgc_ProcessVad (digital_agc.c:633-771), samples [B, 80|160].

    The reference walks ten subframes; the decimator and high-pass states
    carry across them and the energy is an int32 sum, so the recursions
    run over the whole block at once."""
    if nr_samples == 160:
        buf1 = (samples[:, 0::2] + samples[:, 1::2]) >> 1
    else:
        buf1 = samples
    buf2, down = _downsample_by2(buf1, st.down_state)

    hp = st.hp_state
    nrg = torch.zeros_like(hp)
    for i in range(buf2.shape[1]):
        b = buf2[:, i]
        out = b + hp
        hp = wrap16(((600 * out) >> 10) - b)
        nrg = nrg + ((out * out) >> 6)

    # leading-zeros cascade on nrg (int32 shifts wrap like C)
    zeros = torch.where((nrg & -65536) == 0, 16, 0).to(I32)
    for m, n in ((-16777216, 8), (-268435456, 4), (-1073741824, 2),
                 (-2147483648, 1)):
        zeros = zeros + torch.where(((nrg << zeros) & m) == 0, n, 0).to(I32)
    dB = wrap16((15 - zeros) << 11)

    counter = st.counter + (st.counter < AVG_DECAY_TIME).to(I32)

    mean_st = wrap16((st.mean_short_term * 15 + dB) >> 4)
    var_st = div_trunc(((dB * dB) >> 12) + st.variance_short_term * 15, 16)
    std_st = wrap16(_spl_sqrt((var_st << 12) - mean_st * mean_st))

    cnt1 = add_sat_w16(counter, 1)
    mean_lt = wrap16(div_trunc(st.mean_long_term * counter + dB, cnt1))
    var_lt = div_trunc(((dB * dB) >> 12) + st.variance_long_term * counter,
                       cnt1)
    std_lt = wrap16(_spl_sqrt((var_lt << 12) - mean_lt * mean_lt))

    tmp32 = (3 << 12) * wrap16(dB - mean_lt)
    tmp32 = div_trunc(tmp32, torch.where(std_lt == 0, 1, std_lt))
    tmp32 = torch.where(std_lt == 0, 0x7FFFFFFF, tmp32)
    tmp32 = tmp32 + ((st.log_ratio * (13 << 12)) >> 10)
    log_ratio = wrap16(tmp32 >> 6).clamp(-2048, 2048)

    st = st._replace(hp_state=hp, down_state=down, counter=counter,
                     mean_short_term=mean_st, variance_short_term=var_st,
                     std_short_term=std_st, mean_long_term=mean_lt,
                     variance_long_term=var_lt, std_long_term=std_lt,
                     log_ratio=log_ratio)
    return st, log_ratio


# --------------------------------------- ProcessDigital (digital_agc.c:294)

def process_digital(st: AgcState, frame, fs: int, table):
    """One [B, 10*L] block through the digital AGC (mono, adaptive
    digital, lowLevelSignal=0, no far-end VAD).  table: int32[32] tensor.
    Returns (state, out int32 [B, 10*L])."""
    L = 8 if fs == 8000 else 16
    L2 = 3 if fs == 8000 else 4
    out = frame.to(I32)
    Bn = out.shape[0]
    st, logratio = _process_vad(st, out, 10 * L)

    decay = torch.where(
        logratio > 1024, -65,
        torch.where(logratio < 0, 0, wrap16(((0 - logratio) * 65) >> 10)))
    std_lt = st.std_long_term
    decay = torch.where(
        std_lt < 4000, 0,
        torch.where(std_lt < 8096, wrap16(((std_lt - 4000) * decay) >> 12),
                    decay)).to(I32)

    sub = out.reshape(Bn, 10, L)
    env = (sub * sub).amax(dim=2).clamp_min(0)

    # capacitors + per-subframe gain (sequential over 10 subframes)
    fast, slow = st.capacitor_fast, st.capacitor_slow
    gains_sub, zeros_l, frac_l = [], [], []
    for k in range(10):
        e = env[:, k]
        fast = _scalediff32(-1000, fast, fast)
        fast = torch.maximum(fast, e)
        slow = torch.where(e > slow, _scalediff32(500, e - slow, slow),
                           _scalediff32(decay, slow, slow))
        cur = torch.maximum(fast, slow)
        zeros = torch.where(cur == 0, 31, norm_u32(cur))
        frac = ((cur << zeros) & 0x7FFFFFFF) >> 19
        g_hi = table[(zeros - 1).clamp(0, 31).long()]
        g_lo = table[zeros.clamp(0, 31).long()]
        gains_sub.append(g_lo + (((g_hi - g_lo) * frac) >> 12))
        zeros_l.append(zeros)
        frac_l.append(frac)
    gains = torch.stack([st.gain] + gains_sub, dim=1)

    # gate (the LAST subframe's zeros/frac)
    zeros_g = (zeros_l[9] << 9) - (frac_l[9] >> 3)
    zeros_fast = torch.where(fast == 0, 31, norm_u32(fast))
    tmp32 = (fast << zeros_fast) & 0x7FFFFFFF
    zeros_fast = (zeros_fast << 9) - (tmp32 >> 22)
    gate = wrap16(1000 + zeros_fast - zeros_g - st.std_short_term)
    gate_prev = torch.where(gate < 0, 0,
                            wrap16((gate + st.gate_previous * 7) >> 3))
    gate = torch.where(gate < 0, gate, gate_prev)

    gain_adj = torch.where(gate < 2500, (2500 - gate) >> 5, 0)[:, None]
    g0 = table[0]
    dg = gains[:, 1:] - g0
    gated = g0 + torch.where(dg > 8388608, (dg >> 8) * (178 + gain_adj),
                             (dg * (178 + gain_adj)) >> 8)
    gains = torch.where((gate > 0)[:, None],
                        torch.cat([gains[:, :1], gated], dim=1), gains)

    # overload limiting: per subframe, while the limited energy exceeds
    # the limit shrink the gain by 253/256 (z from the incoming gain)
    g = gains[:, 1:]
    z = torch.where(g > 47453132, 16 - norm_w32(g), 10)
    lim_sh = 2 * (1 - z + 10)
    lim = torch.where(lim_sh >= 0, 32767 << lim_sh.clamp_min(0),
                      32767 >> (-lim_sh).clamp_min(0))
    e12 = (env >> 12) + 1
    while True:
        gain32 = (g >> z) + 1
        over = _mul32(e12, gain32 * gain32) > lim
        if not read_bool(over.any()):
            break
        shrunk = torch.where(g > 8388607, div_trunc(g, 256) * 253,
                             div_trunc(g * 253, 256))
        g = torch.where(over, shrunk, g)
    gains = torch.cat([gains[:, :1], g], dim=1)

    # gain reductions 1 ms early: pairwise minimum with the next subframe
    gains = torch.cat([gains[:, 0:1],
                       torch.minimum(gains[:, 1:10], gains[:, 2:11]),
                       gains[:, 10:]], dim=1)
    new_gain = gains[:, 10]

    # apply the gains: first subframe with saturation checks
    n_idx = torch.arange(L, dtype=I32, device=out.device)
    delta0 = (gains[:, 1:2] - gains[:, 0:1]) << (4 - L2)
    gain32_0 = (gains[:, 0:1] << 4) + n_idx * delta0
    x0 = out[:, :L]
    out_tmp = (x0 * ((gain32_0 + 127) >> 7)) >> 16
    y0 = torch.where(out_tmp > 4095, 32767,
                     torch.where(out_tmp < -4096, -32768,
                                 wrap16((x0 * (gain32_0 >> 4)) >> 16)))
    deltas = (gains[:, 2:] - gains[:, 1:10]) << (4 - L2)
    starts = gains[:, 1:10] << 4
    g_mat = starts[:, :, None] + n_idx * deltas[:, :, None]
    xs = out[:, L:].reshape(Bn, 9, L)
    ys = wrap16((xs * (g_mat >> 4)) >> 16)

    out_new = torch.cat([y0.to(I32), ys.reshape(Bn, 9 * L)], dim=1)
    st = st._replace(capacitor_fast=fast, capacitor_slow=slow,
                     gain=new_gain,
                     gate_previous=torch.where(gate < 0, 0,
                                               gate_prev).to(I32))
    return st, out_new


# --------------------------- daemon wrapper (src/webrtc.c agc_process:767)

@functools.lru_cache(maxsize=16)
def _table_on(compression_gain_db: int, device: str) -> torch.Tensor:
    return torch.from_numpy(gain_table(compression_gain_db)).to(
        device=device, dtype=I32)


def process_pkg(st: AgcState, pkg, chn: int, freq: int,
                compression_gain_db: int):
    """One daemon package [B, frame_num * chn], interleaved: truncating
    downmix, subpackages (10 ms up to 16 kHz, 5 ms above) through the mono
    digital AGC, the result duplicated to every channel."""
    table = _table_on(compression_gain_db, str(pkg.device))
    pkg_frame = freq // 1000 * (10 if freq <= 16000 else 5)
    x = downmix(pkg.to(I32), chn)
    outs = []
    for i in range(x.shape[1] // pkg_frame):
        st, y = process_digital(st, x[:, i * pkg_frame:(i + 1) * pkg_frame],
                                freq, table)
        outs.append(y)
    out = torch.cat(outs, dim=1)
    if chn > 1:
        out = out.repeat_interleave(chn, dim=1)
    return st, wrap16(out)
