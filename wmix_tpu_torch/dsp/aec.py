"""Acoustic echo cancellation: the webrtc AEC block math, batched.

Port of `wmix_tpu/dsp/aec.py`: the constants and curve tables, the host
helpers the planner needs (the comfort-noise LCG, C integer division and
short cast), the device-state tuple `AecDev`, `time_to_frequency_pair`
(BufferFarendPartition's two transforms) and `process_block_kernel`, one
64-sample ProcessBlock + NonLinearProcessing (aec_core.c:1143-1351,
911-1141) in the reference's exact ring layout.  The engine runs start-up
and the first irregular package through it; steady packages go to the
package kernel (`engine/aec_package.py`).

Every state leaf carries a leading stream axis [B].  The gate flags and
ring positions are host values of the planner, shared by the batch, so
they arrive as Python ints and bools.

Modes (`exact=` argument, None meaning the environment's, see
`floatops`): fast mode sums with `torch.sum` and transforms with
`torch.fft`; exact mode accumulates FilterFar partition by partition in
the C order, folds the partition energies, the PSD sums and the coherence
averages left to right and transforms with the AEC's Ooura rdft, and is
bit-equal to `wmix_tpu`'s exact mode.  Every other float op is one
rounding per op in both modes.  `mult` is 1 at 8 kHz and 2 at 16 kHz.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.floatops import (cdiv, divs, fcosf, flog, fpowf, fsinf,
                                         fsqrtf, is_exact, seq_sum,
                                         seq_sum_multi)
from wmix_tpu_torch.ops.rdft import aec_rdft_traced

F32 = torch.float32
I32 = torch.int32

FRAME_LEN = 80
PART_LEN = 64
PART_LEN1 = 65
PART_LEN2 = 128
NUM_PARTITIONS = 12         # kNormalNumPartitions
BUF_SIZE_PARTITIONS = 250
FAR_PRE_BUF_SIZE = PART_LEN2 + 4 * FRAME_LEN
PREF_BAND_SIZE = 24

# nlp mode tables (aec_core.c:107-115)
TARGET_SUPP = np.array([-6.9, -11.5, -18.4], np.float32)
MIN_OVERDRIVE = np.array([1.0, 2.0, 5.0], np.float32)
SMOOTHING = {1: (np.float32(0.9), np.float32(0.1)),
             2: (np.float32(0.93), np.float32(0.07))}   # by mult
MIN_FAREND_PSD = np.float32(15.0)

SAMP_MS_NB = 8
MAX_BUF_SIZE_START = 62


@functools.lru_cache(maxsize=None)
def _sqrt_hanning() -> np.ndarray:
    """WebRtcAec_sqrtHanning (aec_core.c:54-71): sin(pi*i/128) printed to
    14 decimals."""
    return np.array([np.float32("%.14f" % math.sin(math.pi * i / 128))
                     for i in range(65)], np.float32)


@functools.lru_cache(maxsize=None)
def _weight_curve() -> np.ndarray:
    """WebRtcAec_weightCurve (aec_core.c:76-85)."""
    vals = [0.0] + [0.3 * math.sqrt(i / 63.0) + 0.1 for i in range(64)]
    return np.array([np.float32("%.4f" % v) for v in vals], np.float32)


@functools.lru_cache(maxsize=None)
def _overdrive_curve() -> np.ndarray:
    """WebRtcAec_overDriveCurve (aec_core.c:90-99)."""
    vals = [math.sqrt(i / 64.0) + 1.0 for i in range(65)]
    return np.array([np.float32("%.4f" % v) for v in vals], np.float32)


@functools.lru_cache(maxsize=8)
def _lcg_jump_tables(n: int):
    """Closed-form stepping of the WebRtcSpl LCG s' = 69069 s + 1 mod
    2^31: s_i = A_i s_0 + C_i with A_i = 69069^i, C_i = sum_{j<i} 69069^j."""
    a = np.zeros(n, np.uint64)
    c = np.zeros(n, np.uint64)
    ai, ci = 1, 0
    for i in range(n):
        ai = (ai * 69069) & 0x7FFFFFFF
        ci = (ci * 69069 + 1) & 0x7FFFFFFF
        a[i] = ai
        c[i] = ci
    return a, c


def _rand_u_array(seed: int, n: int):
    """WebRtcSpl_RandUArray (randomization_functions.c:93-115): the exact
    LCG sequence, vectorized.  Returns (int16 draws, new seed)."""
    a, c = _lcg_jump_tables(n)
    s = (a * np.uint64(seed) + c) & np.uint64(0x7FFFFFFF)
    out = ((s >> np.uint64(16)) & np.uint64(0xFFFF)).astype(
        np.uint16).astype(np.int16)
    return out, int(s[-1])


def _idiv(a: int, b: int) -> int:
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _c_short(x: float) -> int:
    """(short) cast of a double: truncate toward zero, wrap to int16."""
    t = int(x)
    return ((t + 0x8000) & 0xFFFF) - 0x8000


class AecDev(NamedTuple):
    """Device-resident AecCore state (aec_core_internal.h:60-140), [B, ...]."""
    d_buf: torch.Tensor        # [B, 128] near history
    e_buf: torch.Tensor        # [B, 128] error history
    out_buf: torch.Tensor      # [B, 64] overlap-add tail
    x_pow: torch.Tensor        # [B, 65]
    d_pow: torch.Tensor
    d_min_pow: torch.Tensor
    d_init_min_pow: torch.Tensor
    sd: torch.Tensor
    se: torch.Tensor
    sx: torch.Tensor
    sde: torch.Tensor          # [B, 65, 2]
    sxd: torch.Tensor          # [B, 65, 2]
    xf_buf: torch.Tensor       # [B, 12, 2, 65] far spectra (partition ring)
    wf_buf: torch.Tensor       # [B, 12, 2, 65] filter
    xfw_buf: torch.Tensor      # [B, 12, 2, 65] windowed far history
    delay_idx: torch.Tensor    # [B] i32
    h_nl_fb_min: torch.Tensor  # [B] f32
    h_nl_fb_local_min: torch.Tensor
    h_nl_xd_avg_min: torch.Tensor
    h_nl_new_min: torch.Tensor  # [B] i32
    h_nl_min_ctr: torch.Tensor  # [B] i32
    over_drive: torch.Tensor
    over_drive_sm: torch.Tensor
    st_near_state: torch.Tensor  # [B] i32
    echo_state: torch.Tensor     # [B] i32
    diverge_state: torch.Tensor  # [B] i32


def init_dev(batch: int, device=None) -> AecDev:
    """WebRtcAec_InitAec's device-visible parts (aec_core.c:1527-1688)."""
    device = resolve_device(device)
    def f(shape, v=0.0, dt=F32):
        return torch.full((batch,) + tuple(shape), v, dtype=dt,
                          device=device)
    return AecDev(
        d_buf=f((PART_LEN2,)), e_buf=f((PART_LEN2,)), out_buf=f((PART_LEN,)),
        x_pow=f((PART_LEN1,)), d_pow=f((PART_LEN1,)),
        d_min_pow=f((PART_LEN1,), 1.0e6), d_init_min_pow=f((PART_LEN1,)),
        sd=f((PART_LEN1,), 1.0), se=f((PART_LEN1,)),
        sx=f((PART_LEN1,), 1.0),
        sde=f((PART_LEN1, 2)), sxd=f((PART_LEN1, 2)),
        xf_buf=f((NUM_PARTITIONS, 2, PART_LEN1)),
        wf_buf=f((NUM_PARTITIONS, 2, PART_LEN1)),
        xfw_buf=f((NUM_PARTITIONS, 2, PART_LEN1)),
        delay_idx=f((), 0, I32),
        h_nl_fb_min=f((), 1.0), h_nl_fb_local_min=f((), 1.0),
        h_nl_xd_avg_min=f((), 1.0),
        h_nl_new_min=f((), 0, I32), h_nl_min_ctr=f((), 0, I32),
        over_drive=f((), 2.0), over_drive_sm=f((), 2.0),
        st_near_state=f((), 0, I32), echo_state=f((), 0, I32),
        diverge_state=f((), 0, I32))


@functools.lru_cache(maxsize=8)
def _consts_on(device: str):
    """Window and curves as device tensors."""
    win = torch.from_numpy(_sqrt_hanning()).to(device)
    return dict(win_a=win[:PART_LEN], win_b=win.flip(0)[:PART_LEN],
                wcurve=torch.from_numpy(_weight_curve()).to(device),
                wcurve_c=torch.from_numpy(
                    (np.float32(1.0) - _weight_curve()).astype(
                        np.float32)).to(device),
                odcurve=torch.from_numpy(_overdrive_curve()).to(device))


def _pack_spectrum(a):
    """rdft output [B, 128] -> (re [B, 65], im [B, 65]) (aec_core.c:831)."""
    zero = torch.zeros_like(a[..., :1])
    re = torch.cat([a[..., 0:1], a[..., 2::2], a[..., 1:2]], dim=-1)
    im = torch.cat([zero, a[..., 3::2], zero], dim=-1)
    return re, im


def _unpack_spectrum(re, im):
    """(re, im) -> rdft input packing (inverse of _pack_spectrum)."""
    pairs = torch.stack([re[..., 1:PART_LEN], im[..., 1:PART_LEN]],
                        dim=-1).flatten(-2)
    return torch.cat([re[..., 0:1], re[..., PART_LEN:PART_LEN1], pairs],
                     dim=-1)


def _windowed(buf, c):
    return torch.cat([buf[..., :PART_LEN] * c["win_a"],
                      buf[..., PART_LEN:] * c["win_b"]], dim=-1)


def time_to_frequency_pair(time_data, exact=None):
    """BufferFarendPartition's two transforms (aec_core.c:1690-1707):
    [B, 128] -> ([B, 130] plain, [B, 130] windowed), re ++ im."""
    exact = is_exact(exact)
    c = _consts_on(str(time_data.device))
    re0, im0 = _pack_spectrum(aec_rdft_traced(time_data.to(F32),
                                              exact=exact))
    re1, im1 = _pack_spectrum(aec_rdft_traced(_windowed(time_data, c),
                                              exact=exact))
    return torch.cat([re0, im0], dim=-1), torch.cat([re1, im1], dim=-1)


def _filter_far(xf_buf, wf_buf, block_pos: int, exact: bool):
    """FilterFar (aec_core.c:148-170): the echo estimate's spectrum, the
    sum over partitions i of xf[(i + block_pos) mod N] * wf[i].  Exact
    mode accumulates partition by partition in that order; fast mode is
    one reduction over the partition axis."""
    idx = [(i + block_pos) % NUM_PARTITIONS for i in range(NUM_PARTITIONS)]
    x = xf_buf[:, idx]
    xr, xi = x[:, :, 0], x[:, :, 1]
    wr, wi = wf_buf[:, :, 0], wf_buf[:, :, 1]
    return (seq_sum(xr * wr - xi * wi, 1, exact),
            seq_sum(xr * wi + xi * wr, 1, exact))


def _filter_adaptation(xf_buf, wf_buf, block_pos: int, ef_re, ef_im,
                       exact: bool):
    """FilterAdaptation (aec_core.c:222-270) for all 12 partitions."""
    idx = [(i + block_pos) % NUM_PARTITIONS for i in range(NUM_PARTITIONS)]
    x = xf_buf[:, idx]                               # [B, 12, 2, 65]
    xr, xi = x[:, :, 0], -x[:, :, 1]
    er, ei = ef_re[:, None], ef_im[:, None]
    fr = xr[..., :PART_LEN] * er[..., :PART_LEN] - \
        xi[..., :PART_LEN] * ei[..., :PART_LEN]
    fi = xr[..., :PART_LEN] * ei[..., :PART_LEN] + \
        xi[..., :PART_LEN] * er[..., :PART_LEN]
    f1 = xr[..., PART_LEN] * er[..., PART_LEN] - \
        xi[..., PART_LEN] * ei[..., PART_LEN]
    fft = torch.stack([fr, fi], dim=-1).flatten(-2).clone()  # [B, 12, 128]
    fft[..., 1] = f1
    t = aec_rdft_traced(fft, inverse=True, exact=exact)
    t = torch.cat([t[..., :PART_LEN] * (2.0 / PART_LEN2),
                   torch.zeros_like(t[..., PART_LEN:])], dim=-1)
    d_re, d_im = _pack_spectrum(aec_rdft_traced(t, exact=exact))
    # wfBuf[0] += re for all bins; wfBuf[1] += im for bins 1..63 only
    new0 = wf_buf[:, :, 0] + d_re
    new1 = torch.cat([wf_buf[:, :, 1, :1],
                      wf_buf[:, :, 1, 1:PART_LEN] + d_im[..., 1:PART_LEN],
                      wf_buf[:, :, 1, PART_LEN:]], dim=-1)
    return torch.stack([new0, new1], dim=2)


def process_block_kernel(dev: AecDev, xf130, xfw130, nearend, rand64,
                         block_pos: int, mult: int, nlp_mode: int,
                         noise_sel_init: bool, noise_gate_open: bool,
                         update_delay_idx: bool, exact=None):
    """One 64-sample ProcessBlock + NonLinearProcessing for B streams.

    xf130 / xfw130: [B, 130] far spectra read from far_buf (plain and
    windowed); nearend: [B, 64]; rand64: [64] comfort-noise uniforms (int16
    values), shared by the batch.  Returns (dev, output [B, 64] float,
    saturated)."""
    exact = is_exact(exact)

    def rdft(a, inverse=False):
        return aec_rdft_traced(a, inverse, exact)
    device = nearend.device
    c = _consts_on(str(device))
    gp0, gp1 = 0.9, 0.1
    g0, g1 = (float(v) for v in SMOOTHING[mult])
    Bn = nearend.shape[0]
    near = nearend.to(F32)

    # near fft over dBuf
    d_buf = torch.cat([dev.d_buf[:, PART_LEN:], near], dim=1)
    df_re, df_im = _pack_spectrum(rdft(d_buf))
    xf_re, xf_im = xf130[:, :PART_LEN1], xf130[:, PART_LEN1:]

    # power smoothing (aec_core.c:1207-1219)
    far_spec = xf_re * xf_re + xf_im * xf_im
    x_pow = gp0 * dev.x_pow + float(np.float32(
        np.float32(gp1) * np.float32(NUM_PARTITIONS))) * far_spec
    near_spec = df_re * df_re + df_im * df_im
    d_pow = gp0 * dev.d_pow + gp1 * near_spec

    # noise estimate (aec_core.c:1222-1248); the host counters decide
    ramp = float(np.float32(1.0002))
    lower = (d_pow + 0.1 * (dev.d_min_pow - d_pow)) * ramp
    d_min_pow = dev.d_min_pow
    if noise_gate_open:
        d_min_pow = torch.where(d_pow < d_min_pow, lower, d_min_pow * ramp)
    d_init_min_pow = dev.d_init_min_pow
    if noise_sel_init:
        d_init_min_pow = torch.where(
            d_min_pow > d_init_min_pow,
            0.999 * d_init_min_pow + 0.001 * d_min_pow, d_min_pow)
        noise_pow = d_init_min_pow
    else:
        noise_pow = d_min_pow

    # xfBuf ring: write the new partition at block_pos
    xf_buf = dev.xf_buf.clone()
    xf_buf[:, block_pos, 0] = xf_re
    xf_buf[:, block_pos, 1] = xf_im

    # FilterFar + inverse fft -> echo estimate y
    yf_re, yf_im = _filter_far(xf_buf, dev.wf_buf, block_pos, exact)
    t = rdft(_unpack_spectrum(yf_re, yf_im), inverse=True)
    e = near - t[:, PART_LEN:] * (2.0 / PART_LEN2)

    # error fft
    e_buf = torch.cat([dev.e_buf[:, PART_LEN:], e], dim=1)
    ef_re, ef_im = _pack_spectrum(rdft(
        torch.cat([torch.zeros_like(e), e], dim=1)))

    # ScaleErrorSignal (aec_core.c:172-194)
    mu = 0.6 if mult == 1 else 0.5
    err_th = float(np.float32(2e-6 if mult == 1 else 1.5e-6))
    denom = x_pow + float(np.float32(1e-10))
    ef_re = ef_re / denom
    ef_im = ef_im / denom
    abs_ef = fsqrtf(ef_re * ef_re + ef_im * ef_im)
    fac = cdiv(err_th, abs_ef + float(np.float32(1e-10)))
    big = abs_ef > err_th
    ef_re = torch.where(big, ef_re * fac, ef_re) * mu
    ef_im = torch.where(big, ef_im * fac, ef_im) * mu

    wf_buf = _filter_adaptation(xf_buf, dev.wf_buf, block_pos, ef_re, ef_im,
                                exact)

    # ---------------- NonLinearProcessing (aec_core.c:911-1141) --------
    xfw_buf = dev.xfw_buf.clone()
    xfw_buf[:, 0, 0] = xfw130[:, :PART_LEN1]
    xfw_buf[:, 0, 1] = xfw130[:, PART_LEN1:]

    # PartitionDelay (aec_core.c:295-319): first max of the partition
    # energies (torch.argmax returns the first occurrence)
    delay_idx = dev.delay_idx
    if update_delay_idx:
        en = seq_sum(wf_buf[:, :, 0] * wf_buf[:, :, 0] +
                     wf_buf[:, :, 1] * wf_buf[:, :, 1], -1, exact)
        delay_idx = torch.argmax(en, dim=1).to(I32)
    rows = torch.arange(Bn, device=device)
    xfw_d = xfw_buf[rows, delay_idx.long()]          # [B, 2, 65]
    xfw_d_re, xfw_d_im = xfw_d[:, 0], xfw_d[:, 1]

    # windowed near/error ffts (SubbandCoherence, aec_core.c:412-450)
    dfw_re, dfw_im = _pack_spectrum(rdft(_windowed(d_buf, c)))
    efw_re, efw_im = _pack_spectrum(rdft(_windowed(e_buf, c)))

    # SmoothedPSD (aec_core.c:333-386)
    sd = g0 * dev.sd + g1 * (dfw_re * dfw_re + dfw_im * dfw_im)
    se = g0 * dev.se + g1 * (efw_re * efw_re + efw_im * efw_im)
    sx = g0 * dev.sx + g1 * torch.clamp_min(
        xfw_d_re * xfw_d_re + xfw_d_im * xfw_d_im, float(MIN_FAREND_PSD))
    sde0 = g0 * dev.sde[..., 0] + g1 * (dfw_re * efw_re + dfw_im * efw_im)
    sde1 = g0 * dev.sde[..., 1] + g1 * (dfw_re * efw_im - dfw_im * efw_re)
    sxd0 = g0 * dev.sxd[..., 0] + g1 * (dfw_re * xfw_d_re +
                                        dfw_im * xfw_d_im)
    sxd1 = g0 * dev.sxd[..., 1] + g1 * (dfw_re * xfw_d_im -
                                        dfw_im * xfw_d_re)
    sd_sum, se_sum = seq_sum_multi(sd, se, exact=exact)

    diverge = torch.where(dev.diverge_state != 0, 1.05 * se_sum,
                          se_sum) > sd_sum
    efw_re = torch.where(diverge[:, None], dfw_re, efw_re)
    efw_im = torch.where(diverge[:, None], dfw_im, efw_im)
    reset_wf = se_sum > float(np.float32(19.95)) * sd_sum
    wf_buf = torch.where(reset_wf[:, None, None, None],
                         torch.zeros_like(wf_buf), wf_buf)

    eps = float(np.float32(1e-10))
    cohde = (sde0 * sde0 + sde1 * sde1) / (sd * se + eps)
    cohxd = (sxd0 * sxd0 + sxd1 * sxd1) / (sx * sd + eps)

    # NLP decision logic (aec_core.c:962-1050)
    pref_band = PREF_BAND_SIZE // mult
    min_pref = 4 // mult
    band = slice(min_pref, min_pref + pref_band)
    h_xd_avg = 1.0 - divs(seq_sum(cohxd[:, band], exact=exact),
                          float(pref_band))
    h_de_avg = divs(seq_sum(cohde[:, band], exact=exact), float(pref_band))

    xd_min_prev = dev.h_nl_xd_avg_min
    h_nl_xd_avg_min = torch.where(
        (h_xd_avg < 0.75) & (h_xd_avg < xd_min_prev), h_xd_avg, xd_min_prev)
    st_near = torch.where(
        (h_de_avg > float(np.float32(0.98))) & (h_xd_avg > 0.9), 1,
        torch.where((h_de_avg < float(np.float32(0.95))) |
                    (h_xd_avg < 0.8), 0, dev.st_near_state)).to(I32)

    min_od = float(MIN_OVERDRIVE[nlp_mode])
    one_m_cohxd = 1.0 - cohxd
    both_min = torch.minimum(cohde, one_m_cohxd)
    pref_sorted = torch.sort(both_min[:, band], dim=1).values
    q75 = int(math.floor(0.75 * (pref_band - 1)))
    q50 = int(math.floor(0.5 * (pref_band - 1)))

    is_min1 = h_nl_xd_avg_min == 1.0
    near1 = st_near == 1
    echo_state = torch.where(is_min1 | near1, 0, 1).to(I32)
    over_drive = torch.where(is_min1, min_od, dev.over_drive)

    m1, n1 = is_min1[:, None], near1[:, None]
    h_nl = torch.where(m1, torch.where(n1, cohde, one_m_cohxd),
                       torch.where(n1, cohde, both_min))
    h_fb = torch.where(is_min1, torch.where(near1, h_de_avg, h_xd_avg),
                       torch.where(near1, h_de_avg, pref_sorted[:, q75]))
    h_fb_low = torch.where(is_min1, torch.where(near1, h_de_avg, h_xd_avg),
                           torch.where(near1, h_de_avg,
                                       pref_sorted[:, q50]))

    # minimum tracking (aec_core.c:1023-1043)
    new_min = (h_fb_low < float(np.float32(0.6))) & \
        (h_fb_low < dev.h_nl_fb_local_min)
    h_fb_local_min = torch.where(new_min, h_fb_low, dev.h_nl_fb_local_min)
    h_fb_min = torch.where(new_min, h_fb_low, dev.h_nl_fb_min)
    h_new_min = torch.where(new_min, 1, dev.h_nl_new_min)
    h_min_ctr = torch.where(new_min, 0, dev.h_nl_min_ctr)
    step_local = float(np.float32(np.float32(0.0008) / np.float32(mult)))
    step_xd = float(np.float32(np.float32(0.0006) / np.float32(mult)))
    h_fb_local_min = (h_fb_local_min + step_local).clamp(max=1.0)
    h_nl_xd_avg_min = (h_nl_xd_avg_min + step_xd).clamp(max=1.0)
    h_min_ctr = torch.where(h_new_min == 1, h_min_ctr + 1, h_min_ctr)
    fire = h_min_ctr == 2
    h_new_min = torch.where(fire, 0, h_new_min).to(I32)
    h_min_ctr = torch.where(fire, 0, h_min_ctr).to(I32)
    od_cand = torch.clamp_min(
        cdiv(float(TARGET_SUPP[nlp_mode]), flog(h_fb_min + eps) + eps),
        min_od)
    over_drive = torch.where(fire, od_cand, over_drive)
    od_sm_prev = dev.over_drive_sm
    over_drive_sm = torch.where(
        over_drive < od_sm_prev,
        0.99 * od_sm_prev + 0.01 * over_drive,
        0.9 * od_sm_prev + 0.1 * over_drive)

    # OverdriveAndSuppress (aec_core.c:272-293)
    blend = c["wcurve"] * h_fb[:, None] + c["wcurve_c"] * h_nl
    h_nl = torch.where(h_nl > h_fb[:, None], blend, h_nl)
    h_nl = fpowf(h_nl, over_drive_sm[:, None] * c["odcurve"])
    efw_re = efw_re * h_nl
    efw_im = efw_im * h_nl * -1.0

    # ComfortNoise (aec_core.c:462-547), single band
    rand = torch.as_tensor(np.asarray(rand64, np.float32),
                           device=device) / 32768.0
    tmp_ang = float(np.float32(6.28318530717959)) * rand
    noise = fsqrtf(noise_pow[:, 1:])
    u_re = noise * fcosf(tmp_ang)
    u_im = -(noise * fsinf(tmp_ang))
    lam2 = fsqrtf(torch.clamp_min(1.0 - h_nl * h_nl, 0.0))
    zero = torch.zeros_like(u_re[:, :1])
    cn_re = torch.cat([zero, u_re], dim=1)
    cn_im = torch.cat([zero, u_im[:, :PART_LEN - 1], zero], dim=1)
    efw_re = efw_re + lam2 * cn_re
    efw_im = efw_im + lam2 * cn_im

    # inverse error fft + overlap-add (aec_core.c:1066-1088)
    t_out = rdft(_unpack_spectrum(efw_re, -efw_im), inverse=True)
    scale = 2.0 / PART_LEN2
    first = (t_out[:, :PART_LEN] * scale) * c["win_a"] + dev.out_buf
    out_buf = (t_out[:, PART_LEN:] * scale) * c["win_b"]
    output = first.clamp(-32768.0, 32767.0)

    # shift xfw history right by one partition (memmove,
    # aec_core.c:1138-1140); slot 0 is rewritten next block
    xfw_buf = torch.cat([xfw_buf[:, :1], xfw_buf[:, :-1]], dim=1)

    dev = dev._replace(
        d_buf=d_buf, e_buf=e_buf, out_buf=out_buf,
        x_pow=x_pow, d_pow=d_pow, d_min_pow=d_min_pow,
        d_init_min_pow=d_init_min_pow, sd=sd, se=se, sx=sx,
        sde=torch.stack([sde0, sde1], dim=2),
        sxd=torch.stack([sxd0, sxd1], dim=2),
        xf_buf=xf_buf, wf_buf=wf_buf, xfw_buf=xfw_buf,
        delay_idx=delay_idx, h_nl_fb_min=h_fb_min,
        h_nl_fb_local_min=h_fb_local_min, h_nl_xd_avg_min=h_nl_xd_avg_min,
        h_nl_new_min=h_new_min, h_nl_min_ctr=h_min_ctr,
        over_drive=over_drive, over_drive_sm=over_drive_sm,
        st_near_state=st_near, echo_state=echo_state,
        diverge_state=diverge.to(I32))
    return dev, output


# --------------------------------------------------------------------------
# daemon wrapper (src/webrtc.c aec_process2:410-483)
# --------------------------------------------------------------------------

class AecProcessor:
    """The daemon's aec handle for one stream (`wmix_tpu.dsp.aec`'s
    AecProcessor): chn/freq geometry, the 10-or-20 ms subpackage loop,
    left-channel extraction, the (int16_t) cast with NaN -> 0, the output
    duplicated to every channel.

    Runs over the engine's exact-layout step (`engine/aec_step.py`
    `AecBatch` at B = 1 on `device`, the card unless the caller asks for
    the CPU), whose host planner replays the reference's ring cursors; the
    arithmetic mode is read when the processor is built.  Packages are
    tensors [1, frames * chn] of int16 values, and so is the output (int32
    holding int16 values), on the processor's device.  The reported delay
    is the daemon's 0, which the planner assumes.  8 or 16 kHz (AecBatch
    raises otherwise)."""

    def __init__(self, chn: int, freq: int, interval_ms: int = 20,
                 device=None):
        from wmix_tpu_torch.engine.aec_step import AecBatch
        self.chn = chn
        self.freq = freq
        self.aec = AecBatch(1, freq, device=device, interval_ms=interval_ms)
        self.pkg_frame = self.aec.sub_len

    def process2(self, far: torch.Tensor, near: torch.Tensor,
                 delay_ms: int = 0) -> torch.Tensor:
        """aec_process2: BufferFarend + Process per subpackage."""
        from wmix_tpu_torch.engine.aec_step import cast_out_int16
        if delay_ms:
            raise ValueError("the planner plans the daemon's reported "
                             "delay of 0 ms")
        out = cast_out_int16(self.aec.step(far[:, ::self.chn].to(F32),
                                           near[:, ::self.chn].to(F32)))
        return out.repeat_interleave(self.chn, dim=1) if self.chn > 1 \
            else out
