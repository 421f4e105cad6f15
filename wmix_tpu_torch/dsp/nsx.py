"""NSX: the webrtc fixed-point noise suppressor, batched over streams.

Port of `wmix_tpu/dsp/nsx_jnp.py` (nsx_core.c / nsx_core_c.c ProcessCore),
the `ns_backend="nsx"` stage of the record chain:

  * the spl int16 complex FFT (complex_fft.c mode 1) of order 7 (8 kHz,
    128 points) and 8 (16 and 32 kHz, 256 points) as vectorized butterfly
    stages, and the real FFT pair around it (shared with `dsp/aecm.py`);
  * quantile noise estimation (three simultaneous log-domain estimates)
    and the start-up white/pink parametric noise model;
  * the LRT, spectral-flatness and spectral-difference features with the
    512-block histogram refresh of their thresholds;
  * speech/noise probability, the Wiener gain, the energy-ratio gain map,
    overlap-add synthesis and the time-domain gain of the high bands.

Every value is integer and every result bit-equal to the reference.
int32 values live in int32 tensors, uint32 values in int64 tensors that
hold 0 .. 2**32-1 and are masked wherever C wraps (`dsp/intops.py`).  The
state's leaves carry a leading stream axis [B]; inside a block a
per-stream scalar is a [B, 1] tensor, so that it broadcasts against the
per-bin [B, n] values as the reference's vmapped scalars do.  Every branch
that depends on the data is a `torch.where`: nothing reads the card from
the host.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp._aecm_tables import SIN_TABLE_1024, bit_reverse_perm
from wmix_tpu_torch.dsp._nsx_tables import (
    BIN_SIZE_LRT, BLOCKS_80W128, BLOCKS_160W256, COUNTER_DIV, DD_PR_SNR_Q11,
    DETERMINANT_EST_MATRIX, END_STARTUP_LONG, END_STARTUP_SHORT, FACTOR1,
    FACTOR2_AGGR1, FACTOR2_AGGR2, FACTOR2_AGGR3, FACTOR_1_LRT_DIFF,
    FACTOR_2_FLAT_Q10, FACTOR_Q16, FACTOR_Q7, FACTOR_Q7_STARTUP,
    GAMMA_NOISE_TRANS_AND_SPEECH_Q8, HIST_PAR_EST, INDICATOR_TABLE,
    K_START_BAND, LIM_PEAK_SPACE_FLAT_DIFF, LIM_PEAK_WEIGHT_FLAT_DIFF,
    LOG_INDEX, LOG_TABLE, LOG_TABLE_FRAC, MAX_DIFF, MAX_FLAT_Q10, MIN_DIFF,
    MIN_FLAT_Q10, NOISE_UPDATE_Q8, NUM_HIGH_BANDS_MAX,
    ONE_MINUS_DD_PR_SNR_Q11, ONE_MINUS_GAMMA_PAUSE_Q8,
    ONE_MINUS_PROB_RANGE_Q8, PRIOR_UPDATE_Q14, SIMULT, SPECT_DIFF_TAVG_Q8,
    SPECT_FLAT_TAVG_Q14, STAT_UPDATES, SUM_LOG_INDEX, SUM_SQUARE_LOG_INDEX,
    THRES_FLUCT_LRT, THRES_PEAK_FLAT, THRES_WEIGHT_FLAT_DIFF, WIDTH_Q8,
    _SAT_MAX)
from wmix_tpu_torch.dsp.intops import (
    U32_MASK, add_sat_w16, div_u32_u16, div_u32_u32, div_w32_w16_exact,
    div_w32_w32_exact, norm_u32, norm_w16, norm_w32, sat_w16, shift_u32,
    shift_w32, sqrt_floor, wrap16, wrap32)

I32 = torch.int32
I64 = torch.int64
M = U32_MASK
I16_MAX = 32767

# complex_fft.c; the inverse's CIFFTSFT and CIFFTRND equal these
CFFTSFT = 14
CFFTRND = 1
CFFTRND2 = 16384


# ------------------------------------------------------------- helpers

def _u(x) -> torch.Tensor:
    """The uint32 value of an integer tensor (its low 32 bits), as int64."""
    return x.to(I64) & M


def _wsum(x) -> torch.Tensor:
    """int32 wraparound sum over the last axis, kept as [..., 1]."""
    return wrap32(x.to(I64).sum(-1, keepdim=True))


def _usum(x) -> torch.Tensor:
    """uint32 sum (mod 2**32) over the last axis, kept as [..., 1]."""
    return (x.to(I64) & M).sum(-1, keepdim=True) & M


def _shr_full(x, n) -> torch.Tensor:
    """Logical right shift of a uint32: a count of 32 or more gives 0, a
    negative count shifts by 0."""
    x = _u(x)
    n = torch.as_tensor(n, device=x.device).to(I64)
    return torch.where(n >= 32, 0, x >> n.clamp(0, 31))


def _mul_round(a, b, shift: int) -> torch.Tensor:
    """WEBRTC_SPL_MUL_16_16_RSFT_WITH_ROUND in int32."""
    return (a * b + (1 << (shift - 1))) >> shift


def _full(like: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full_like(like, value)


@functools.lru_cache(maxsize=None)
def _table(name: str, device: str) -> torch.Tensor:
    tabs = {
        "log_frac": LOG_TABLE_FRAC, "log_index": LOG_INDEX,
        "log": LOG_TABLE, "counter_div": COUNTER_DIV,
        "indicator": INDICATOR_TABLE, "factor1": FACTOR1,
        "factor2_1": FACTOR2_AGGR1, "factor2_2": FACTOR2_AGGR2,
        "factor2_3": FACTOR2_AGGR3, "win128": BLOCKS_80W128,
        "win256": BLOCKS_160W256}
    return torch.as_tensor(np.asarray(tabs[name]), dtype=I32, device=device)


def _tab(name: str, like: torch.Tensor) -> torch.Tensor:
    return _table(name, str(like.device))


def _log2_frac(v) -> torch.Tensor:
    """((31 - zeros) << 8) + kLogTableFrac[frac] of a uint32 (0 gives the
    value of zeros = 0, which callers mask)."""
    v = _u(v)
    zeros = norm_u32(v)
    frac = ((v << zeros.to(I64)) & 0x7FFFFFFF) >> 23
    return ((31 - zeros) << 8) + _tab("log_frac", v)[frac]


# ------------------------------------- spl complex FFT (complex_fft.c mode 1)

@functools.lru_cache(maxsize=None)
def _perm(order: int, device: str) -> torch.Tensor:
    return torch.as_tensor(bit_reverse_perm(order), device=device)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(l: int, k: int, inverse: bool, device: str):
    j = np.arange(l) << k
    wr = SIN_TABLE_1024[j + 256]
    wi = SIN_TABLE_1024[j] if inverse else -SIN_TABLE_1024[j]
    return (torch.as_tensor(wr, dtype=I32, device=device),
            torch.as_tensor(wi, dtype=I32, device=device))


def _butterflies(re, im, order: int, inverse: bool):
    """The stages of WebRtcSpl_ComplexFFT / ComplexIFFT mode 1 over
    [..., n] int32 (bit-reversed input).  The inverse scales each stage by
    the stream's own magnitude; returns (re, im, scale [..., 1])."""
    n = 1 << order
    sh = re.shape[:-1]
    dev = str(re.device)
    scale = torch.zeros(sh + (1,), dtype=I32, device=re.device)
    l, k = 1, 9
    while l < n:
        istep = l << 1
        if inverse:
            mx = torch.maximum(re.abs().amax(-1, keepdim=True),
                               im.abs().amax(-1, keepdim=True))
            shift = (mx > 13573).to(I32) + (mx > 27146).to(I32)
            scale = scale + shift
            rnd = (_full(shift, 8192) << shift)[..., None]
            sft = (shift + CFFTSFT)[..., None]
        else:
            rnd, sft = CFFTRND2, 1 + CFFTSFT
        wr, wi = _stage_twiddles(l, k, inverse, dev)
        r = re.reshape(sh + (n // istep, istep))
        i = im.reshape(sh + (n // istep, istep))
        r_a, r_b = r[..., :l], r[..., l:]
        i_a, i_b = i[..., :l], i[..., l:]
        tr = (wr * r_b - wi * i_b + CFFTRND) >> (15 - CFFTSFT)
        ti = (wr * i_b + wi * r_b + CFFTRND) >> (15 - CFFTSFT)
        qr = r_a << CFFTSFT
        qi = i_a << CFFTSFT
        re = torch.cat([wrap16((qr + tr + rnd) >> sft),
                        wrap16((qr - tr + rnd) >> sft)], -1).reshape(
                            sh + (n,))
        im = torch.cat([wrap16((qi + ti + rnd) >> sft),
                        wrap16((qi - ti + rnd) >> sft)], -1).reshape(
                            sh + (n,))
        k -= 1
        l = istep
    return re, im, scale


def complex_fft_mode1(re, im, order: int):
    """Forward WebRtcSpl_ComplexFFT mode 1 over [..., 2**order] int32 re/im
    (already bit-reversed)."""
    re, im, _ = _butterflies(re, im, order, inverse=False)
    return re, im


def complex_ifft_mode1(re, im, order: int):
    """Inverse mode 1: (re, im, scale [..., 1]), each stage scaled by the
    stream's own magnitude."""
    return _butterflies(re, im, order, inverse=True)


def real_forward_fft(x, order: int):
    """WebRtcSpl_RealForwardFFT over [..., n] int32 real input: (re, im),
    each [..., n/2 + 1]."""
    n2 = (1 << order) // 2
    re = x[..., _perm(order, str(x.device))]
    re, im = complex_fft_mode1(re, torch.zeros_like(re), order)
    return re[..., :n2 + 1], im[..., :n2 + 1]


def real_inverse_fft(re_h, im_h, order: int):
    """WebRtcSpl_RealInverseFFT: the conjugate-symmetric expansion of
    [..., n/2 + 1] and the inverse; returns (real [..., n], scale
    [..., 1])."""
    n2 = (1 << order) // 2
    rev = torch.arange(n2 - 1, 0, -1, device=re_h.device)
    re_full = torch.cat([re_h, re_h[..., rev]], -1)
    im_full = torch.cat([im_h, -im_h[..., rev]], -1)
    perm = _perm(order, str(re_h.device))
    re, _im, scale = complex_ifft_mode1(re_full[..., perm],
                                        im_full[..., perm], order)
    return re, scale


# ------------------------------------------------------- config and state

class NsxConfig(NamedTuple):
    fs: int
    mode: int
    blk: int                  # block_len_10ms
    ana_len: int
    stages: int
    magn_len: int
    threshold_log_lrt_init: int
    max_lrt: int
    min_lrt: int
    overdrive: int
    denoise_bound: int
    gain_map: int


@functools.lru_cache(maxsize=None)
def make_config(fs: int, mode: int = 2) -> NsxConfig:
    if fs not in (8000, 16000, 32000, 48000):
        raise ValueError("NSX supports 8000/16000/32000/48000")
    if fs == 8000:
        blk, ana, st = 80, 128, 7
        thr, mx, mn = 131072, 0x0040000, 52429
    else:
        blk, ana, st = 160, 256, 8
        thr, mx, mn = 212644, 0x0080000, 104858
    od, db, gm = {0: (256, 8192, 0), 1: (256, 4096, 1),
                  2: (282, 2048, 1), 3: (320, 1475, 1)}[mode]
    return NsxConfig(fs, mode, blk, ana, st, ana // 2 + 1,
                     thr, mx, mn, od, db, gm)


class NsxState(NamedTuple):
    """Per-stream NSX core state, every leaf with a leading [B] axis; int32
    leaves in int32, uint32 leaves (marked u32) in int64.  Fields in the
    reference's order, so the leaves flatten as `jax.tree_util` flattens
    `wmix_tpu`'s."""
    analysis_buffer: torch.Tensor      # [B, ana_len]
    synthesis_buffer: torch.Tensor     # [B, ana_len]
    data_buf_hb: torch.Tensor          # [B, 2, ana_len]
    noise_est_quantile: torch.Tensor   # [B, magn_len]
    noise_est_log_quantile: torch.Tensor   # [B, 3, magn_len]
    noise_est_density: torch.Tensor        # [B, 3, magn_len]
    noise_est_counter: torch.Tensor        # [B, 3]
    noise_sup_filter: torch.Tensor     # [B, magn_len]
    prior_non_speech_prob: torch.Tensor    # [B]
    prev_magn_u16: torch.Tensor        # [B, magn_len]
    prev_noise_u32: torch.Tensor       # [B, magn_len] u32
    log_lrt_time_avg_w32: torch.Tensor     # [B, magn_len]
    avg_magn_pause: torch.Tensor       # [B, magn_len]
    init_magn_est: torch.Tensor        # [B, magn_len] u32
    threshold_log_lrt: torch.Tensor    # [B]
    threshold_spec_diff: torch.Tensor  # [B]
    threshold_spec_flat: torch.Tensor  # [B] u32
    feature_log_lrt: torch.Tensor      # [B]
    feature_spec_flat: torch.Tensor    # [B] u32
    feature_spec_diff: torch.Tensor    # [B] u32
    weight_log_lrt: torch.Tensor       # [B]
    weight_spec_flat: torch.Tensor     # [B]
    weight_spec_diff: torch.Tensor     # [B]
    cur_avg_magn_energy: torch.Tensor  # [B] u32
    time_avg_magn_energy: torch.Tensor     # [B] u32
    time_avg_magn_energy_tmp: torch.Tensor  # [B] u32
    hist_lrt: torch.Tensor             # [B, 1000]
    hist_spec_diff: torch.Tensor       # [B, 1000]
    hist_spec_flat: torch.Tensor       # [B, 1000]
    block_index: torch.Tensor          # [B]
    cnt_thres_update: torch.Tensor     # [B]
    prev_q_magn: torch.Tensor          # [B]
    q_noise: torch.Tensor              # [B]
    prev_q_noise: torch.Tensor         # [B]
    white_noise_level: torch.Tensor    # [B] u32
    pink_noise_numerator: torch.Tensor     # [B]
    pink_noise_exp: torch.Tensor       # [B]
    min_norm: torch.Tensor             # [B]


U32_FIELDS = frozenset((
    "prev_noise_u32", "init_magn_est", "threshold_spec_flat",
    "feature_spec_flat", "feature_spec_diff", "cur_avg_magn_energy",
    "time_avg_magn_energy", "time_avg_magn_energy_tmp",
    "white_noise_level"))


def init_state(batch: int, fs: int, device=None, mode: int = 2) -> NsxState:
    device = resolve_device(device)
    cfg = make_config(fs, mode)
    ml = cfg.magn_len

    def full(value, *shape):
        return torch.full((batch,) + shape, value, dtype=I32, device=device)

    vals = dict(
        analysis_buffer=full(0, cfg.ana_len),
        synthesis_buffer=full(0, cfg.ana_len),
        data_buf_hb=full(0, NUM_HIGH_BANDS_MAX, cfg.ana_len),
        noise_est_quantile=full(0, ml),
        noise_est_log_quantile=full(2048, SIMULT, ml),
        noise_est_density=full(153, SIMULT, ml),
        noise_est_counter=torch.tensor(
            [(END_STARTUP_LONG * (i + 1)) // SIMULT for i in range(SIMULT)],
            dtype=I32, device=device).repeat(batch, 1),
        noise_sup_filter=full(16384, ml),
        prior_non_speech_prob=full(8192),
        prev_magn_u16=full(0, ml),
        prev_noise_u32=full(0, ml),
        log_lrt_time_avg_w32=full(0, ml),
        avg_magn_pause=full(0, ml),
        init_magn_est=full(0, ml),
        threshold_log_lrt=full(cfg.threshold_log_lrt_init),
        threshold_spec_diff=full(50),
        threshold_spec_flat=full(20480),
        feature_log_lrt=full(cfg.threshold_log_lrt_init),
        feature_spec_flat=full(20480),
        feature_spec_diff=full(50),
        weight_log_lrt=full(6),
        weight_spec_flat=full(0),
        weight_spec_diff=full(0),
        cur_avg_magn_energy=full(0),
        time_avg_magn_energy=full(0),
        time_avg_magn_energy_tmp=full(0),
        hist_lrt=full(0, HIST_PAR_EST),
        hist_spec_diff=full(0, HIST_PAR_EST),
        hist_spec_flat=full(0, HIST_PAR_EST),
        block_index=full(-1),
        cnt_thres_update=full(0),
        prev_q_magn=full(0),
        q_noise=full(0),
        prev_q_noise=full(0),
        white_noise_level=full(0),
        pink_noise_numerator=full(0),
        pink_noise_exp=full(0),
        min_norm=full(15))
    return NsxState(**{k: v.to(I64) if k in U32_FIELDS else v
                       for k, v in vals.items()})


def _as_blocks(st: NsxState) -> NsxState:
    """Per-stream scalars [B] -> [B, 1]."""
    return NsxState(*(x[:, None] if x.dim() == 1 else x for x in st))


def _as_state(st: NsxState, like: NsxState) -> NsxState:
    """Back to the state's own shapes and dtypes."""
    return NsxState(*(x.reshape(o.shape).to(o.dtype)
                      for x, o in zip(st, like)))


# ------------------------------------------------------ spl energy helper

def _energy(vec, length: int):
    """WebRtcSpl_Energy: (energy int32 wrap-fold, scaling), each [B, 1]."""
    nbits = int(length).bit_length()       # 32 - NormU32(length)
    sabs = torch.where(vec > 0, vec, wrap16(-vec))
    smax = sabs.amax(-1, keepdim=True).clamp_min(-1)
    t = norm_w32(smax * smax)
    scaling = torch.where(smax == 0, 0,
                          torch.where(t > nbits, 0, nbits - t)).to(I32)
    return _wsum((vec * vec) >> scaling), scaling


# ------------------------------- UpdateNoiseEstimate (nsx_core.c:303-331)

def _update_noise_estimate(lq):
    """(q_noise [B, 1], quantile [B, magn_len]) from one estimate row."""
    k_exp2 = 11819
    q_noise = 14 - _mul_round(lq.amax(-1, keepdim=True), k_exp2, 21)
    t2 = lq * k_exp2
    t1 = 0x00200000 | (t2 & 0x001FFFFF)
    t16 = wrap16(t2 >> 21) - 21 + wrap16(q_noise)
    return q_noise.to(I32), sat_w16(shift_w32(t1, t16))


# -------------------------------- NoiseEstimationC (nsx_core.c:334-453)

def _noise_estimation(st: NsxState, magn, norm_data, cfg: NsxConfig):
    """(counter, log_quantile, density, quantile, q_noise, noise u32)."""
    tabind = cfg.stages - norm_data                      # [-8, 8]
    lv = _tab("log", magn)[tabind.abs()]
    logval = torch.where(tabind < 0, -lv, lv)
    lm = wrap16((_log2_frac(magn) * 22713) >> 15)
    lmagn = torch.where(magn != 0, wrap16(lm + logval), logval)

    cdiv_tab = _tab("counter_div", magn)
    q_noise, quantile = st.q_noise, st.noise_est_quantile
    rows_lq, rows_d, cnts = [], [], []
    startup_long = st.block_index < END_STARTUP_LONG
    for s in range(SIMULT):
        cnt = st.noise_est_counter[:, s:s + 1]
        count_div = cdiv_tab[cnt.clamp(0, len(COUNTER_DIV) - 1).long()]
        count_prod = wrap16(cnt * count_div)
        dens = st.noise_est_density[:, s]
        lq = st.noise_est_log_quantile[:, s]
        factor = norm_w16(dens)
        delta_hi = wrap16(_full(factor, FACTOR_Q16) >>
                          (14 - factor).clamp(0, 31))
        delta_lo = torch.where(startup_long, FACTOR_Q7_STARTUP,
                               FACTOR_Q7).to(I32)
        delta = torch.where(dens > 512, delta_hi, delta_lo)
        tmp16 = wrap16((delta * count_div) >> 14)
        lq_up = wrap16(lq + torch.div(tmp16 + 2, 4, rounding_mode="floor"))
        t2 = wrap16(torch.div(
            torch.div(tmp16 + 1, 2, rounding_mode="floor") * 3, 2,
            rounding_mode="floor"))
        lq_dn = torch.maximum(wrap16(lq - t2), logval)
        lq_new = torch.where(lmagn > lq, lq_up, lq_dn)
        near = (lmagn - lq_new).abs() < WIDTH_Q8
        d_new = wrap16(wrap16(_mul_round(dens, count_prod, 15)) +
                       wrap16(_mul_round(count_div, 21845, 15)))
        rows_lq.append(lq_new)
        rows_d.append(torch.where(near, d_new, dens))
        hit = cnt >= END_STARTUP_LONG
        cnts.append(torch.where(hit, 0, cnt) + 1)
        do_upd = hit & ~startup_long
        qn_new, quant_new = _update_noise_estimate(lq_new)
        q_noise = torch.where(do_upd, qn_new, q_noise)
        quantile = torch.where(do_upd, quant_new, quantile)

    # start-up: always refresh from the last estimate row
    qn_new, quant_new = _update_noise_estimate(rows_lq[-1])
    q_noise = torch.where(startup_long, qn_new, q_noise)
    quantile = torch.where(startup_long, quant_new, quantile)
    return (torch.cat(cnts, -1).to(I32), torch.stack(rows_lq, 1),
            torch.stack(rows_d, 1), quantile, q_noise, _u(quantile))


# ----------------- CalcParametricNoiseEstimate (nsx_core.c:586-628)

def _calc_parametric_noise(pink_exp_avg, pink_num_avg, min_norm,
                           block_index, cfg: NsxConfig):
    """(noise_estimate u32, noise_estimate_avg u32), each [B, magn_len]."""
    li = _tab("log_index", min_norm)[
        torch.arange(cfg.magn_len, device=min_norm.device).clamp_min(
            K_START_BAND)]
    t2 = (pink_exp_avg * li) >> 15
    t1 = pink_num_avg - t2 + ((min_norm - cfg.stages) << 11)
    ok = t1 > 0
    int_part = wrap16(t1 >> 11)
    frac_part = wrap16(t1 & 0x7FF)
    t_hi = 2048 - (((2048 - frac_part) * 1244) >> 10)
    t_lo = (frac_part * 804) >> 10
    t2b = torch.where((frac_part >> 10) != 0, t_hi, t_lo)
    t2b = shift_w32(t2b, int_part - 11)
    one_shl = shift_w32(_full(int_part, 1), int_part.clamp(0, 30))
    avg = _u(one_shl + t2b)
    est = (avg * _u(block_index + 1)) & M
    return torch.where(ok, est, 0), torch.where(ok, avg, 0)


# --------------- FeatureParameterExtraction (nsx_core.c:821-1016)

def _top2_peaks(hist):
    """The reference's sequential top-2 scan: peak 1 the first argmax,
    peak 2 the first argmax of the rest.  (w1, pos1, w2, pos2), [B, 1]
    each, positions in 2*i+1 units; an all-zero histogram gives zeros."""
    idx = torch.arange(hist.shape[-1], device=hist.device)
    m1 = hist.amax(-1, keepdim=True)
    i1 = hist.argmax(-1, keepdim=True)
    masked = torch.where(idx == i1, -1, hist)
    m2 = masked.amax(-1, keepdim=True)
    i2 = masked.argmax(-1, keepdim=True)
    return (torch.where(m1 > 0, m1, 0), torch.where(m1 > 0, 2 * i1 + 1, 0),
            torch.where(m2 > 0, m2, 0), torch.where(m2 > 0, 2 * i2 + 1, 0))


def _close_peaks(w1, p1, w2, p2):
    """Merge the second peak into the first when they are near."""
    close = (_u(p1 - p2) < LIM_PEAK_SPACE_FLAT_DIFF) & \
        (w2 * LIM_PEAK_WEIGHT_FLAT_DIFF > w1)
    w1f = torch.where(close, w1 + w2, w1)
    p1f = torch.where(close, _u(p1 + p2) >> 1, _u(p1))
    return w1f, wrap32(p1f)


def _feature_parameter_extraction(st: NsxState, flag, cfg: NsxConfig):
    """The updated (hist_lrt, hist_flat, hist_diff, threshold_log_lrt,
    threshold_spec_flat, threshold_spec_diff, weight_lrt, weight_flat,
    weight_diff).  Without `flag` the features go into the histograms;
    with it the thresholds and weights are refreshed from the histograms
    as they were before this block, and the histograms cleared."""
    bins = torch.arange(HIST_PAR_EST, device=flag.device)

    def one_hot_add(hist, hidx, valid):
        hidx = hidx.clamp(0, HIST_PAR_EST - 1)
        return hist + (valid & (bins == hidx)).to(I32)

    hi_lrt = _u(st.feature_log_lrt)
    h_lrt = one_hot_add(st.hist_lrt, hi_lrt, hi_lrt < HIST_PAR_EST)
    hi_flat = ((_u(st.feature_spec_flat) * 5) & M) >> 8
    h_flat = one_hot_add(st.hist_spec_flat, hi_flat, hi_flat < HIST_PAR_EST)
    num_d = ((_u(st.feature_spec_diff) * 5) & M) >> cfg.stages
    hi_diff = div_u32_u32(num_d, st.time_avg_magn_energy,
                          zero_result=HIST_PAR_EST)
    h_diff = one_hot_add(st.hist_spec_diff, hi_diff,
                         (st.time_avg_magn_energy > 0) &
                         (hi_diff < HIST_PAR_EST))

    # refresh
    j_all = (2 * bins + 1).to(I32)
    tmp32_all = st.hist_lrt * j_all
    avg_lrt = _wsum(tmp32_all[:, :BIN_SIZE_LRT])
    num_lrt = _wsum(st.hist_lrt[:, :BIN_SIZE_LRT])
    avg_compl = _wsum(tmp32_all)
    avg_sq = _wsum(tmp32_all * j_all)
    fluct = avg_sq * num_lrt - avg_lrt * avg_compl
    thres_fluct = THRES_FLUCT_LRT * num_lrt
    tmp_u32 = (FACTOR_1_LRT_DIFF * _u(avg_lrt)) & M
    bad = (fluct < thres_fluct) | (num_lrt == 0) | \
        (tmp_u32 > _u(100 * num_lrt))
    q1 = div_u32_u32((tmp_u32 << (9 + cfg.stages)) & M, _u(num_lrt),
                     zero_result=0)
    q2 = wrap32(div_u32_u16(q1, _full(q1, 25)))
    threshold_log_lrt = torch.where(bad, cfg.max_lrt,
                                    q2.clamp(cfg.min_lrt, cfg.max_lrt))
    use_diff0 = fluct >= thres_fluct

    w1f, p1f = _close_peaks(*_top2_peaks(st.hist_spec_flat))
    weak = (w1f < THRES_WEIGHT_FLAT_DIFF) | (p1f < THRES_PEAK_FLAT)
    use_flat = torch.where(weak, 0, 1).to(I32)
    thr_flat = (FACTOR_2_FLAT_Q10 * p1f).clamp(MIN_FLAT_Q10, MAX_FLAT_Q10)
    threshold_spec_flat = torch.where(weak, st.threshold_spec_flat,
                                      _u(thr_flat))

    dw1f, dp1f = _close_peaks(*_top2_peaks(st.hist_spec_diff))
    thr_diff = (FACTOR_1_LRT_DIFF * dp1f).clamp(MIN_DIFF, MAX_DIFF)
    threshold_spec_diff = torch.where(use_diff0, thr_diff,
                                      st.threshold_spec_diff)
    use_diff = (use_diff0 & (dw1f >= THRES_WEIGHT_FLAT_DIFF)).to(I32)

    feature_sum = torch.div(6, 1 + use_flat + use_diff,
                            rounding_mode="floor").to(I32)
    zero = torch.zeros_like(st.hist_lrt)
    return (
        torch.where(flag, zero, h_lrt),
        torch.where(flag, zero, h_flat),
        torch.where(flag, zero, h_diff),
        torch.where(flag, threshold_log_lrt, st.threshold_log_lrt),
        torch.where(flag, threshold_spec_flat, st.threshold_spec_flat),
        torch.where(flag, threshold_spec_diff, st.threshold_spec_diff),
        torch.where(flag, feature_sum, st.weight_log_lrt),
        torch.where(flag, use_flat * feature_sum, st.weight_spec_flat),
        torch.where(flag, use_diff * feature_sum, st.weight_spec_diff))


# ------------------- ComputeSpectralFlatness (nsx_core.c:1022-1084)

def _compute_spectral_flatness(st: NsxState, magn, sum_magn,
                               cfg: NsxConfig):
    """The new feature_spec_flat (u32 [B, 1])."""
    m = magn[:, 1:]
    has_zero = (m == 0).any(-1, keepdim=True)
    fsf = st.feature_spec_flat
    decayed = (fsf - (((fsf * SPECT_FLAT_TAVG_Q14) & M) >> 14)) & M
    avg_num = _usum(torch.where(m != 0, _u(_log2_frac(m)), 0))
    avg_den = (sum_magn - _u(magn[:, :1])) & M
    tmp32 = _log2_frac(avg_den)
    log_cur = wrap32(avg_num)
    log_cur = log_cur + ((cfg.stages - 1) << (cfg.stages + 7))
    log_cur = log_cur - (tmp32 << (cfg.stages - 1))
    log_cur = log_cur << (10 - cfg.stages)
    t32 = 0x00020000 | (log_cur.abs() & 0x0001FFFF)
    current = shift_w32(t32, -(7 - (log_cur >> 17)))
    diff = (current - wrap32(fsf)) * SPECT_FLAT_TAVG_Q14
    updated = (fsf + _u(diff >> 14)) & M
    return torch.where(has_zero, decayed, updated)


# ----------------- ComputeSpectralDifference (nsx_core.c:1091-1181)

def _compute_spectral_difference(st: NsxState, magn, sum_magn,
                                 magn_energy, norm_data, cfg: NsxConfig):
    """(feature_spec_diff u32, cur_avg_magn_energy u32), [B, 1] each."""
    amp = st.avg_magn_pause
    avg_pause = _wsum(amp) >> (cfg.stages - 1)
    max_pause = amp.amax(-1, keepdim=True)
    min_pause = amp.amin(-1, keepdim=True)
    avg_magn = wrap32(sum_magn >> (cfg.stages - 1))
    tmp32no1 = torch.maximum(max_pause - avg_pause, avg_pause - min_pause)
    n_shifts = (10 + cfg.stages - norm_w32(tmp32no1)).clamp_min(0)
    t16 = wrap16(magn - avg_magn)
    t32p = amp - avg_pause
    var_magn = _usum(t16 * t16)
    cov = _wsum(t32p * t16)
    t32s = t32p >> n_shifts
    var_pause = _usum(t32s * t32s)

    cur_avg = (st.cur_avg_magn_energy +
               _shr_full(magn_energy, 2 * norm_data + cfg.stages - 1)) & M

    have = (var_pause != 0) & (cov != 0)
    u1 = cov.to(I64).abs() & M
    norm32 = norm_u32(u1) - 16
    u1 = shift_u32(u1, norm32)
    u2 = (u1 * u1) & M
    n_sh2 = (n_shifts + norm32) << 1
    var_pause_sh = torch.where(n_sh2 < 0, _shr_full(var_pause, -n_sh2),
                               var_pause)
    q = _shr_full(div_u32_u32(u2, var_pause_sh, zero_result=0),
                  n_sh2.clamp_min(0))
    avg_diff = torch.where(
        have, torch.where(var_pause_sh > 0,
                          var_magn - torch.minimum(var_magn, q), 0),
        var_magn)

    tgt = _shr_full(avg_diff, 2 * norm_data)
    fsd = st.feature_spec_diff
    dn = ((((fsd - tgt) & M) * SPECT_DIFF_TAVG_Q8) & M) >> 8
    up = ((((tgt - fsd) & M) * SPECT_DIFF_TAVG_Q8) & M) >> 8
    new_fsd = torch.where(fsd > tgt, fsd - dn, fsd + up) & M
    return new_fsd, cur_avg


# ------- DataAnalysis (nsx_core.c:524-541 AnalysisUpdate + 1184-1419)

def _data_analysis(st: NsxState, speech_frame, cfg: NsxConfig) -> dict:
    """The block's spectrum and the state fields DataAnalysis updates."""
    n, b = cfg.ana_len, cfg.blk
    window = _tab("win128" if n == 128 else "win256", speech_frame)
    ana = torch.cat([st.analysis_buffer[:, b:n], speech_frame], -1)
    win_data = wrap16(_mul_round(window, ana, 14))

    energy_in, scale_energy_in = _energy(win_data, n)
    max_win = win_data.abs().amax(-1, keepdim=True).clamp_max(I16_MAX)
    norm_data = norm_w16(max_win)

    net_norm = cfg.stages - norm_data
    r_in_magn = norm_data - st.min_norm
    r_in_init = (-r_in_magn).clamp_min(0)
    min_norm = st.min_norm - r_in_init
    r_in_magn = r_in_magn.clamp_min(0)

    fre, fim = real_forward_fft(wrap16(win_data << norm_data), cfg.stages)
    n2 = n // 2
    im = -fim
    im[:, 0] = 0
    im[:, n2] = 0

    # magnitudes; bins 0 and n2 are pure real
    t_mid = (fre[:, 1:n2].to(I64) ** 2 + fim[:, 1:n2].to(I64) ** 2) & M
    magn = torch.cat([fre[:, :1].abs(), sqrt_floor(t_mid) & 0xFFFF,
                      fre[:, n2:n2 + 1].abs()], -1)
    magn_energy = (fre[:, :1].to(I64) ** 2 + fre[:, n2:n2 + 1].to(I64) ** 2
                   + _usum(t_mid)) & M
    sum_magn = _usum(magn)

    # start-up statistics (block_index < END_STARTUP_SHORT)
    startup = st.block_index < END_STARTUP_SHORT
    ime = (_shr_full(st.init_magn_est, r_in_init) +
           _shr_full(magn, r_in_magn)) & M
    init_magn_est = torch.where(startup, ime, st.init_magn_est)

    log2 = torch.where(magn != 0, _log2_frac(magn), 0)
    li = _tab("log_index", magn)[:cfg.magn_len]
    band = torch.arange(cfg.magn_len, device=magn.device)
    in_band = (band >= K_START_BAND) & (band < n2)
    sum_log_magn = log2[:, n2:n2 + 1] + _wsum(torch.where(in_band, log2, 0))
    sum_log_i_log = ((int(LOG_INDEX[n2]) * log2[:, n2:n2 + 1]) >> 3) + \
        _wsum(torch.where(in_band, (li * log2) >> 3, 0))

    t_u32 = ((sum_magn * cfg.overdrive) & M) >> (cfg.stages + 8)
    white_noise_level = torch.where(
        startup, (_shr_full(st.white_noise_level, r_in_init) +
                  _shr_full(t_u32, r_in_magn)) & M,
        st.white_noise_level)

    mdet = int(DETERMINANT_EST_MATRIX[K_START_BAND])
    sum_log_i = int(SUM_LOG_INDEX[K_START_BAND])
    sum_log_i_sq = int(SUM_SQUARE_LOG_INDEX[K_START_BAND])
    if cfg.fs == 8000:
        t1 = mdet
        t1 += (int(SUM_LOG_INDEX[65]) * sum_log_i) >> 9
        t1 -= (int(SUM_LOG_INDEX[65]) * int(SUM_LOG_INDEX[65])) >> 10
        t1 -= (sum_log_i_sq << 4) & 0xFFFFFFFF
        t1 -= ((cfg.magn_len - K_START_BAND) *
               int(SUM_SQUARE_LOG_INDEX[65])) >> 2
        mdet = ((t1 + 0x8000) & 0xFFFF) - 0x8000   # w16
        sum_log_i -= int(SUM_LOG_INDEX[65])
        sum_log_i_sq -= int(SUM_SQUARE_LOG_INDEX[65])

    zeros = (16 - norm_w32(sum_log_magn)).clamp_min(0)
    sum_log_magn_u16 = wrap32((_u(sum_log_magn << 1) >> zeros) & 0xFFFF)

    t2_w32 = sum_log_i_sq * sum_log_magn_u16
    t_u32no1 = _u(sum_log_i_log) >> 12
    big = (sum_log_i & M) > t_u32no1
    t_u16 = _full(zeros, (sum_log_i << 1) & 0xFFFF)
    t_u16 = torch.where(big, t_u16 >> zeros, t_u16)
    t_u32no1 = torch.where(big, t_u32no1, t_u32no1 >> zeros)
    t2_w32 = t2_w32 - wrap32(t_u32no1 * _u(t_u16))
    mdet_sh = _full(zeros, mdet) >> zeros
    t2_div = div_w32_w32_exact(t2_w32, mdet_sh) + (net_norm << 11)
    t2_div = t2_div.clamp_min(0)
    pink_num = torch.where(startup, st.pink_noise_numerator + t2_div,
                           st.pink_noise_numerator)

    t2b = sum_log_i * sum_log_magn_u16 - \
        (sum_log_i_log >> (3 + zeros)) * (cfg.magn_len - K_START_BAND)
    pe_add = div_w32_w32_exact(t2b, mdet_sh).clamp(0, 16384)
    pink_exp = torch.where(startup & (t2b > 0), st.pink_noise_exp + pe_add,
                           st.pink_noise_exp)

    return dict(magn=magn, re=fre, im=im, norm_data=norm_data,
                zero_input=max_win == 0, energy_in=energy_in,
                scale_energy_in=scale_energy_in, magn_energy=magn_energy,
                sum_magn=sum_magn, analysis_buffer=ana, min_norm=min_norm,
                init_magn_est=init_magn_est,
                white_noise_level=white_noise_level,
                pink_noise_numerator=pink_num, pink_noise_exp=pink_exp)


# -------------------------------------- SpeechNoiseProb (nsx_core_c.c)

def _indicator(tbl, frac, neg, slope_round: bool, lower_check: bool):
    """The sigmoid-table lookup shared by the three features."""
    ind = _tab("indicator", tbl)
    ci = tbl.clamp(0, 15).long()
    base = ind[ci]
    slope = ind[ci + 1] - base
    step = _mul_round(slope, frac, 14) if slope_round else \
        (slope * frac) >> 14
    interp = base + wrap16(step)
    in_tab = (tbl < 16) & (tbl >= 0) if lower_check else tbl < 16
    return torch.where(in_tab,
                       torch.where(neg, 8192 - interp, 8192 + interp),
                       torch.where(neg, 0, 16384)).to(I32)


def _speech_noise_prob(st: NsxState, prior_loc_snr, post_loc_snr,
                       cfg: NsxConfig):
    """(non_speech_prob [B, magn_len], log_lrt_time_avg_w32,
    feature_log_lrt, prior_non_speech_prob)."""
    post = _u(post_loc_snr)
    prior = _u(prior_loc_snr)

    norm_tmp = norm_u32(post)
    num = (post << norm_tmp.to(I64)) & M
    den = torch.where(norm_tmp > 10,
                      (prior << (norm_tmp - 11).clamp(0, 31).to(I64)) & M,
                      prior >> (11 - norm_tmp).clamp(0, 31).to(I64))
    q = div_u32_u32(num, den, zero_result=0)
    bessel = torch.where(den > 0, post_loc_snr - wrap32(q), 0)

    zeros = norm_u32(prior)
    frac32 = wrap32((((prior << zeros.to(I64)) & 0x7FFFFFFF) >> 19))
    t32 = (frac32 * frac32 * -43) >> 19
    t32 = t32 + ((wrap16(frac32) * 5412) >> 12)
    t32c = ((31 - zeros) << 12) + t32 + 37 - (11 << 12)
    log_tmp = (t32c * 178) >> 8
    t = log_tmp + st.log_lrt_time_avg_w32
    half = torch.where(t < 0, -torch.div(-t, 2, rounding_mode="floor"),
                       torch.div(t, 2, rounding_mode="floor"))
    log_lrt = st.log_lrt_time_avg_w32 + (bessel - half)
    lrt_sum = _wsum(log_lrt)
    feature_log_lrt = (lrt_sum * BIN_SIZE_LRT) >> (cfg.stages + 11)

    # average LRT indicator
    t32no1 = lrt_sum - st.threshold_log_lrt
    neg = t32no1 < 0
    n_shifts = torch.where(neg, 8 - cfg.stages, 7 - cfg.stages)
    t32no1 = shift_w32(torch.where(neg, -t32no1, t32no1), n_shifts)
    ind_prior = st.weight_log_lrt * _indicator(
        wrap16(t32no1 >> 14), wrap16(t32no1 & 0x3FFF), neg, False, True)

    # spectral flatness indicator
    fsf400 = (st.feature_spec_flat * 400) & M
    tsf = st.threshold_spec_flat
    flat_neg = tsf < fsf400
    diffv = torch.where(flat_neg, fsf400 - tsf, tsf - fsf400)
    n_sh = torch.where(flat_neg, 5, 4)
    q_f = div_u32_u16((diffv << n_sh) & M, _full(diffv, 25))
    tmp_ind_f = _indicator(wrap16(wrap32(q_f >> 14)),
                           wrap16(wrap32(q_f & 0x3FFF)), flat_neg, False,
                           False)
    ind_prior = torch.where(st.weight_spec_flat != 0,
                            ind_prior + st.weight_spec_flat * tmp_ind_f,
                            ind_prior)

    # spectral difference indicator
    fsd = st.feature_spec_diff
    norm_d = norm_u32(fsd).clamp_max(20 - cfg.stages)
    t_u32no1 = (fsd << norm_d.clamp(0, 31).to(I64)) & M
    t_u32no2 = _shr_full(st.time_avg_magn_energy, 20 - cfg.stages - norm_d)
    ratio = div_u32_u32(t_u32no1, t_u32no2, zero_result=0x7FFFFFFF)
    t_u32no1 = torch.where(fsd != 0, ratio, 0)
    t_u32no3 = div_u32_u16((_u(st.threshold_spec_diff) << 17) & M,
                           _full(fsd, 25))
    t_u32no2b = (t_u32no1 - t_u32no3) & M
    diff_neg = (t_u32no2b & 0x80000000) != 0
    t_u32no2b = torch.where(diff_neg, (t_u32no3 - t_u32no1) & M, t_u32no2b)
    q_d = t_u32no2b >> torch.where(diff_neg, 0, 1)
    tmp_ind_d = _indicator(wrap16(wrap32(q_d >> 14)),
                           wrap16(wrap32(q_d & 0x3FFF)), diff_neg, True,
                           False)
    ind_prior = torch.where(st.weight_spec_diff != 0,
                            ind_prior + st.weight_spec_diff * tmp_ind_d,
                            ind_prior)

    ind16 = wrap16(div_w32_w16_exact(98307 - ind_prior, _full(ind_prior, 6)))
    d16 = wrap16(ind16 - st.prior_non_speech_prob)
    prior_nsp = wrap16(st.prior_non_speech_prob +
                       wrap16((PRIOR_UPDATE_Q14 * d16) >> 14))

    # invert the prior per bin
    t32no1 = (log_lrt * 23637) >> 14
    int_part = wrap16(t32no1 >> 12).clamp_min(-8)
    fracp = wrap16(t32no1 & 0xFFF)
    t32no2 = ((fracp * fracp * 44) >> 19) + ((fracp * 84) >> 7)
    inv_lrt = shift_w32(_full(int_part, 1), 8 + int_part) + \
        shift_w32(t32no2, int_part - 4)
    norm_i = norm_w32(inv_lrt)
    one_m = wrap16(16384 - prior_nsp)
    norm_p = norm_w16(one_m)
    inv_a = inv_lrt >> (15 - norm_p - norm_i).clamp(0, 31)
    inv_lrt_a = shift_w32(inv_a * one_m, 7 - norm_i - norm_p)
    inv_lrt_b = (inv_lrt * one_m) >> 8
    inv_sel = torch.where(norm_i + norm_p < 15, inv_lrt_a, inv_lrt_b)
    den_p = prior_nsp + inv_sel
    qq = div_w32_w32_exact(prior_nsp << 8, den_p)
    qv = torch.where(den_p != 0, qq & 0xFFFF, 0)
    nsp = torch.where((prior_nsp > 0) & (log_lrt < 65300) &
                      (norm_i + norm_p >= 7), qv, 0)
    return nsp.to(I32), log_lrt, feature_log_lrt, prior_nsp


# ----- PrepareSpectrum / Denormalize / SynthesisUpdate / DataSynthesis
# (nsx_core.c:456-521, 1421-1499)

def _data_synthesis(st: NsxState, re, im, noise_sup_filter, norm_data,
                    energy_in, scale_energy_in, prior_nsp, block_index,
                    cfg: NsxConfig):
    """(out [B, blk], synthesis_buffer) of the non-zero-input path."""
    n, blk = cfg.ana_len, cfg.blk
    filt = wrap16(noise_sup_filter)
    fre = wrap16((re * filt) >> 14)
    fim = wrap16((im * filt) >> 14)
    rfft, scale = real_inverse_fft(fre, -fim, cfg.stages)
    real = sat_w16(shift_w32(rfft, scale - norm_data))

    gain_factor = 8192
    if cfg.gain_map == 1:
        energy_out, scale_out = _energy(real, n)
        cheap = (scale_out == 0) & ((energy_out & 0x7F800000) == 0)
        sh = 8 + scale_out - scale_energy_in
        eo = torch.where(cheap, shift_w32(energy_out, sh), energy_out)
        ei = torch.where(cheap, energy_in, energy_in >> (sh & 31))
        ratio = div_w32_w32_exact(eo + (ei >> 1), ei).clamp(0, 256).long()
        g1 = _tab("factor1", ratio)[ratio]
        g2 = _tab(f"factor2_{cfg.mode if cfg.mode in (1, 2, 3) else 1}",
                  ratio)[ratio]
        gmapped = wrap16(wrap16(((16384 - prior_nsp) * g1) >> 14) +
                         wrap16((prior_nsp * g2) >> 14))
        use = (block_index > END_STARTUP_LONG) & (energy_in > 0)
        gain_factor = torch.where(use, gmapped, 8192)

    window = _tab("win128" if n == 128 else "win256", real)
    t16a = wrap16(_mul_round(window, real, 14))
    synth = add_sat_w16(st.synthesis_buffer,
                        sat_w16(_mul_round(t16a, gain_factor, 13)))
    synth_new = torch.cat([synth[:, blk:n], torch.zeros_like(synth[:, :blk])],
                          -1)
    return synth[:, :blk], synth_new


# ------------------------------------ ProcessCore (nsx_core.c:1501-2118)

def _pick(zero, a, b):
    """Per stream: a where the input block was all zero, else b."""
    return torch.where(zero.reshape(zero.shape[:1] + (1,) * (a.dim() - 1)),
                       a, b)


def process_block(state: NsxState, bands, fs: int, mode: int = 2,
                  num_bands: int = 1):
    """One 10 ms block: bands [B, num_bands, blk] int32 -> (state, out
    [B, num_bands, blk] int32)."""
    cfg = make_config(fs, mode)
    blk, ml, n2 = cfg.blk, cfg.magn_len, cfg.ana_len // 2
    st = _as_blocks(state)

    d = _data_analysis(st, bands[:, 0].to(I32), cfg)
    magn = d["magn"]
    zero = d["zero_input"]
    norm_data = d["norm_data"]
    q_magn = norm_data - cfg.stages

    # ---------------- the full (non-zero-input) pipeline
    fsf_new = _compute_spectral_flatness(st, magn, d["sum_magn"], cfg)
    block_index = st.block_index + 1
    st1 = st._replace(block_index=block_index,
                      analysis_buffer=d["analysis_buffer"],
                      min_norm=d["min_norm"],
                      init_magn_est=d["init_magn_est"],
                      white_noise_level=d["white_noise_level"],
                      pink_noise_numerator=d["pink_noise_numerator"],
                      pink_noise_exp=d["pink_noise_exp"],
                      feature_spec_flat=fsf_new)
    counter, log_q, dens, quant, q_noise, noise_u32 = \
        _noise_estimation(st1, magn, norm_data, cfg)
    st1 = st1._replace(noise_est_counter=counter,
                       noise_est_log_quantile=log_q,
                       noise_est_density=dens,
                       noise_est_quantile=quant,
                       q_noise=q_noise)

    prev_noise_u16 = st.prev_noise_u32 >> 11

    # -------- start-up mixing (block_index < END_STARTUP_SHORT)
    startup_s = block_index < END_STARTUP_SHORT
    q_dom = torch.minimum(q_noise, st1.min_norm - cfg.stages)
    have_pink = st1.pink_noise_exp != 0
    pink_exp_avg = wrap16(div_w32_w16_exact(st1.pink_noise_exp,
                                            block_index + 1))
    pink_num_avg = div_w32_w16_exact(st1.pink_noise_numerator,
                                     block_index + 1)
    ne_par, nea_par = _calc_parametric_noise(
        pink_exp_avg, pink_num_avg, st1.min_norm, block_index, cfg)
    white = st1.white_noise_level
    noise_est = torch.where(have_pink, ne_par, white)
    noise_est_avg = torch.where(have_pink, nea_par,
                                div_u32_u16(white, block_index + 1))

    t_u32no1 = (noise_est * cfg.overdrive) & M
    numer = (st1.init_magn_est << 8) & M
    numer2 = (numer - t_u32no1) & M
    n_sh = norm_u32(numer2).clamp(0, 6).to(I64)
    den3 = (st1.init_magn_est >> (6 - n_sh)).clamp_min(1)
    q3 = wrap32(div_u32_u32((numer2 << n_sh) & M, den3, zero_result=0))
    nsf_tmp = torch.where((st1.init_magn_est != 0) & (numer > t_u32no1),
                          q3.clamp(cfg.denoise_bound, 16384),
                          cfg.denoise_bound)

    no1 = _shr_full(noise_u32, q_noise - q_dom)
    no2 = _shr_full(noise_est_avg, st1.min_norm - cfg.stages - q_dom)
    big = (no1 & 0xFC000000) != 0
    no1s = torch.where(big, no1 >> 6, no1)
    no2s = torch.where(big, no2 >> 6, no2)
    mixed = div_u32_u16((no1s * _u(block_index) +
                         no2s * _u(END_STARTUP_SHORT - block_index)) & M,
                        _full(no1s, END_STARTUP_SHORT))
    mixed = (mixed << torch.where(big, 6, 0)) & M
    noise_u32 = torch.where(startup_s, mixed, noise_u32)
    q_noise = torch.where(startup_s, q_dom, q_noise)

    # -------- long start-up energy average
    startup_l = block_index < END_STARTUP_LONG
    tame_tmp = (st1.time_avg_magn_energy_tmp +
                _shr_full(d["magn_energy"],
                          2 * norm_data + cfg.stages - 1)) & M
    st1 = st1._replace(
        time_avg_magn_energy_tmp=torch.where(
            startup_l, tame_tmp, st1.time_avg_magn_energy_tmp),
        time_avg_magn_energy=torch.where(
            startup_l, div_u32_u16(tame_tmp, block_index + 1),
            st1.time_avg_magn_energy))

    # -------- step 1: prior and posterior SNR
    t_u32m = _u(magn) << 6
    t_u32n = shift_u32(noise_u32, 6 + q_magn - q_noise)
    qp = div_u32_u32((t_u32m << 11) & M, t_u32n,
                     zero_result=_SAT_MAX).clamp_max(_SAT_MAX)
    gt = t_u32m > t_u32n
    post_loc_snr = torch.where(gt, wrap32(qp), 2048)
    post_loc_snr = torch.where(gt & (t_u32n == 0), _SAT_MAX,
                               post_loc_snr).to(I32)

    near_est = (_u(st.prev_magn_u16) * _u(st.noise_sup_filter)) & M
    t_u32b = _shr_full(st.prev_noise_u32,
                       5 - st.prev_q_magn + st.prev_q_noise)
    qn = div_u32_u32((near_est << 3) & M, t_u32b, zero_result=_SAT_MAX)
    prev_near_snr = torch.where(t_u32b > 0, qn.clamp_max(_SAT_MAX),
                                _SAT_MAX)
    prior_snr = (prev_near_snr * DD_PR_SNR_Q11 +
                 ((_u(post_loc_snr - 2048) * ONE_MINUS_DD_PR_SNR_Q11) & M) +
                 512) & M
    prior_loc_snr = wrap32(2048 + (prior_snr >> 10))

    # -------- step 2: features, speech/noise probability
    fsd_new, cur_avg = _compute_spectral_difference(
        st1, magn, d["sum_magn"], d["magn_energy"], norm_data, cfg)
    st1 = st1._replace(feature_spec_diff=fsd_new,
                       cur_avg_magn_energy=cur_avg)
    cnt_upd = st1.cnt_thres_update + 1
    flag = cnt_upd == (1 << STAT_UPDATES)
    (h_lrt, h_flat, h_diff, thr_lrt, thr_flat, thr_diff,
     w_lrt, w_flat, w_diff) = _feature_parameter_extraction(st1, flag, cfg)
    st1 = st1._replace(hist_lrt=h_lrt, hist_spec_flat=h_flat,
                       hist_spec_diff=h_diff, threshold_log_lrt=thr_lrt,
                       threshold_spec_flat=thr_flat,
                       threshold_spec_diff=thr_diff, weight_log_lrt=w_lrt,
                       weight_spec_flat=w_flat, weight_spec_diff=w_diff)
    tame = st1.time_avg_magn_energy
    half_e = ((st1.cur_avg_magn_energy >> STAT_UPDATES) + tame + 1) & M
    half_e = half_e >> 1
    # renormalize feature_spec_diff to the new average energy
    sh_a = (16 - norm_u32(half_e)).clamp_min(0).to(I64)
    fsd = st1.feature_spec_diff
    sh_b = (16 - norm_u32(fsd)).clamp_min(0).to(I64)
    norm32no1 = sh_a + sh_b
    qd = div_u32_u32(((half_e >> sh_a) * (fsd >> sh_b)) & M, tame,
                     zero_result=0)
    fsd_scaled = torch.where(
        norm_u32(qd) < norm32no1, 0x007FFFFF,
        ((qd << norm32no1.clamp(0, 31)) & M).clamp_max(0x007FFFFF))
    do_scale = flag & (half_e != tame) & (fsd != 0) & (tame > 0)
    st1 = st1._replace(
        feature_spec_diff=torch.where(do_scale, fsd_scaled, fsd),
        time_avg_magn_energy=torch.where(flag, half_e, tame),
        cur_avg_magn_energy=torch.where(flag, 0, st1.cur_avg_magn_energy),
        cnt_thres_update=torch.where(flag, 0, cnt_upd))

    nsp, log_lrt, feat_lrt, prior_nsp = _speech_noise_prob(
        st1, prior_loc_snr, post_loc_snr, cfg)
    st1 = st1._replace(log_lrt_time_avg_w32=log_lrt,
                       feature_log_lrt=feat_lrt,
                       prior_non_speech_prob=prior_nsp)

    # -------- noise update
    n_sh2 = st.prev_q_magn - q_magn
    t_u32no2 = shift_u32(magn, st.prev_q_noise - q_magn)
    up_pos = prev_noise_u16 <= t_u32no2
    t_u32no1 = torch.where(up_pos, t_u32no2 - prev_noise_u16,
                           prev_noise_u16 - t_u32no2)
    gamma = torch.where(nsp < ONE_MINUS_PROB_RANGE_Q8,
                        GAMMA_NOISE_TRANS_AND_SPEECH_Q8, NOISE_UPDATE_Q8)
    prev_gamma = torch.cat([_full(gamma[:, :1], NOISE_UPDATE_Q8),
                            gamma[:, :-1]], -1)
    t_u32no3 = (t_u32no1 * _u(nsp)) & M
    active = (t_u32no1 != 0) & (nsp != 0)
    big3 = (t_u32no3 & 0x7C000000) != 0
    pn = st.prev_noise_u32

    def stepped(g):
        step = torch.where(big3, ((t_u32no3 >> 5) * g) & M,
                           ((t_u32no3 * g) & M) >> 5)
        return torch.where(up_pos, pn + step, pn - step) & M

    # the step at the previous bin's gamma (the C reassigns gamma after use)
    noise_upd = torch.where(active, stepped(prev_gamma), pn)
    noise_upd = torch.where(prev_gamma != gamma,
                            torch.minimum(noise_upd, stepped(gamma)),
                            noise_upd)
    noise_u32 = noise_upd
    max_noise = noise_u32.amax(-1, keepdim=True)

    amp = st.avg_magn_pause
    amp_sh = shift_w32(amp, -n_sh2)
    d_a = (((magn - amp_sh) * ONE_MINUS_GAMMA_PAUSE_Q8) + 128) >> 8
    d_b = (shift_w32(magn, n_sh2) - amp) * ONE_MINUS_GAMMA_PAUSE_Q8
    d_b = (d_b + shift_w32(_full(n_sh2, 128), n_sh2)) >> \
        (8 + n_sh2).clamp(0, 31)
    delta_p = torch.where(n_sh2 < 0, d_a, d_b)
    st1 = st1._replace(avg_magn_pause=torch.where(
        nsp > ONE_MINUS_PROB_RANGE_Q8, amp_sh + delta_p, amp_sh))

    norm_mn = norm_u32(max_noise)

    # -------- step 3: final decision-directed SNR and Wiener filter
    n_sh3 = st.prev_q_noise + 11 - q_magn
    mg = _u(magn)
    sel_a = n_sh3 < 0
    sel_b = n_sh3 > 17
    tmp_magn = torch.where(sel_a, mg, torch.where(sel_b, (mg << 17) & M,
                                                  shift_u32(mg, n_sh3)))
    tmp_noise = torch.where(sel_a, shift_u32(noise_u32, -n_sh3),
                            torch.where(sel_b,
                                        _shr_full(noise_u32, n_sh3 - 17),
                                        noise_u32))
    diff_mn = (tmp_magn - tmp_noise) & M
    nrm = norm_u32(diff_mn).clamp_max(11).to(I64)
    num_c = (diff_mn << nrm) & M
    den_c = tmp_noise >> (11 - nrm)
    q_c = torch.where(den_c > 0, div_u32_u32(num_c, den_c, zero_result=0),
                      num_c)
    cur_near = torch.where(tmp_magn > tmp_noise, q_c.clamp_max(_SAT_MAX), 0)

    prior_f = (prev_near_snr * DD_PR_SNR_Q11 +
               cur_near * ONE_MINUS_DD_PR_SNR_Q11) & M
    od = (cfg.overdrive + (((prior_f + 8192) & M) >> 14)) & M
    gain_q = div_u32_u32((prior_f + (od >> 1)) & M, od, zero_result=0)
    nsf = wrap32(gain_q).clamp(cfg.denoise_bound, 16384)
    mix = (_u(nsf) * _u(block_index) +
           _u(nsf_tmp) * _u(END_STARTUP_SHORT - block_index)) & M
    nsf_startup = wrap32(div_u32_u16(mix, _full(mix, END_STARTUP_SHORT)) &
                         0xFFFF)
    noise_sup_filter = torch.where(startup_s, nsf_startup, nsf)

    # -------- save noise and magnitude for the next frame
    pn_next = torch.where(norm_mn > 5,
                          (noise_u32 << (norm_mn - 5).clamp(0, 31).to(I64))
                          & M,
                          noise_u32 >> (5 - norm_mn).clamp(0, 31).to(I64))
    st1 = st1._replace(noise_sup_filter=noise_sup_filter,
                       prev_q_noise=st.prev_q_noise + norm_mn - 5,
                       prev_q_magn=q_magn, prev_noise_u32=pn_next,
                       prev_magn_u16=magn)

    out_low, synth_new = _data_synthesis(
        st1, d["re"], d["im"], noise_sup_filter, norm_data,
        d["energy_in"], d["scale_energy_in"], prior_nsp, block_index, cfg)
    st1 = st1._replace(synthesis_buffer=synth_new)

    # ---------------- the zero-input path: DataAnalysis returns before its
    # min_norm update (nsx_core.c:1226-1232), only the buffers advance
    sb = st.synthesis_buffer
    st0 = st._replace(analysis_buffer=d["analysis_buffer"],
                      synthesis_buffer=torch.cat(
                          [sb[:, blk:], torch.zeros_like(sb[:, :blk])], -1))
    st_out = NsxState(*(_pick(zero, a, b) for a, b in zip(st0, st1)))
    outs = [_pick(zero, sb[:, :blk], out_low)]

    # ---------------- high bands (time-domain gain)
    if num_bands > 1:
        n = cfg.ana_len
        lo = n2 - (n2 >> 2)
        t_u16 = _wsum(nsp[:, lo:n2]) & 0xFFFF
        t_u32 = _usum(noise_sup_filter[:, lo:n2])
        avg_prob = wrap16(4096 - (t_u16 >> (cfg.stages - 7)))
        avg_gain = wrap16(wrap32(t_u32 >> (cfg.stages - 3)))
        gain_mod = avg_prob.clamp_max(3607)
        g_lo = wrap16((gain_mod << 1) + (avg_gain >> 1))
        g_hi = wrap16(wrap16((3 * avg_gain) >> 2) + gain_mod)
        g_hb = torch.where(avg_prob < 2048, g_lo, g_hi).clamp(
            int(np.int16(cfg.denoise_bound)), 16384)
        hb_new = []
        for i in range(num_bands - 1):
            buf = torch.cat([st.data_buf_hb[:, i, blk:n],
                             bands[:, i + 1].to(I32)], -1)
            hb_new.append(buf)
            outs.append(_pick(zero, buf[:, :blk],
                              wrap16((g_hb * buf[:, :blk]) >> 14)))
        for i in range(num_bands - 1, NUM_HIGH_BANDS_MAX):
            hb_new.append(st.data_buf_hb[:, i])
        st_out = st_out._replace(data_buf_hb=torch.stack(hb_new, 1))

    return _as_state(st_out, state), torch.stack(outs, 1)


# -------------------- the daemon wrapper (webrtc.c ns_process, NSX branch)

def process_pkg(st: NsxState, pkg, chn: int, freq: int, mode: int = 2):
    """One interleaved package [B, frames * chn] through the NSX branch of
    the daemon wrapper (webrtc.c:511-530): 10 ms subpackages, the channels
    passed as bands (the right channel of a stereo package gets only the
    high-band time gain), and at 32 kHz only the first 160 frames of each
    320-frame subpackage processed, the rest of the output zero.  Returns
    (state, out int32 of the package's shape)."""
    cfg = make_config(freq, mode)
    pkg_frame = freq // 1000 * 10
    x = pkg.to(I32)
    n_frames = x.shape[1] // chn
    frames = x.reshape(x.shape[0], n_frames, chn)
    out = torch.zeros_like(frames)
    for off in range(0, n_frames, pkg_frame):
        bands = frames[:, off:off + cfg.blk].transpose(1, 2)
        st, ob = process_block(st, bands, freq, mode, chn)
        out[:, off:off + cfg.blk] = ob.transpose(1, 2)
    return st, out.reshape(x.shape)


class NsxProcessor:
    """ns_init/ns_process with the NSX branch for one stream
    (`wmix_tpu.dsp.nsx`'s NsxProcessor, webrtc.c:511-530): `process_pkg`
    at B = 1 on `device` (the card unless the caller asks for the CPU),
    the output cast to int16.  Packages are tensors [1, frames * chn] of
    int16 values, and so is the output (int32)."""

    def __init__(self, chn: int, freq: int, mode: int = 2, device=None):
        if freq > 32000 or freq % 8000 != 0:
            raise ValueError("freq must be 8000/16000/32000")
        self.chn = chn
        self.freq = freq
        self.mode = mode
        self.st = init_state(1, freq, device, mode)

    def process(self, frame: torch.Tensor) -> torch.Tensor:
        self.st, out = process_pkg(self.st, frame, self.chn, self.freq,
                                   self.mode)
        return wrap16(out)
