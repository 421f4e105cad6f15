"""Noise suppression: the webrtc float NS, fast mode, batched over streams.

Port of `wmix_tpu/dsp/ns.py` (ns_core.c): quantile noise estimation, the
startup white/pink noise model, speech/noise probability from the LRT,
spectral-flatness and spectral-difference features with histogram-learned
thresholds, the decision-directed Wiener gain, overlap-add synthesis and
the gain-map factor.  Every state leaf carries a leading stream axis [B];
the per-stream selects of the reference (`_tree_select` under vmap) become
`torch.where` over that axis.

Fast mode: float32 state, the reference's double-precision libm calls in
float64 (`floatops`), released summation order.  Mono only (the daemon
feeds stereo right channels as "high bands"; not ported yet).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.floatops import fexp, flog, fpow_div, fsqrt_d, ftanh
from wmix_tpu_torch.ops.rdft import rdft_traced

F32 = torch.float32
I32 = torch.int32
f32 = np.float32

# defines.h
SIMULT = 3
END_STARTUP_LONG = 200
END_STARTUP_SHORT = 50
FACTOR = f32(40.0)
WIDTH = f32(0.01)
QUANTILE = f32(0.25)
DD_PR_SNR = f32(0.98)
LRT_TAVG = f32(0.50)
SPECT_FL_TAVG = f32(0.30)
SPECT_DIFF_TAVG = f32(0.30)
PRIOR_UPDATE = f32(0.10)
NOISE_UPDATE_G = f32(0.90)
SPEECH_UPDATE_G = f32(0.99)
WIDTH_PR_MAP = f32(4.0)
LRT_FEATURE_THR = f32(0.5)
SF_FEATURE_THR = f32(0.5)
PROB_RANGE = f32(0.20)
HIST_PAR_EST = 1000
GAMMA_PAUSE = f32(0.05)
B_LIM = f32(0.5)

# set_feature_extraction_parameters (ns_core.c:23-71), aggressiveness 2
BIN_SIZE_LRT = f32(0.1)
BIN_SIZE_SPEC_FLAT = f32(0.05)
BIN_SIZE_SPEC_DIFF = f32(0.1)
RANGE_AVG_HIST_LRT = f32(1.0)
FACTOR1_MODEL_PARS = f32(1.2)
FACTOR2_MODEL_PARS = f32(0.9)
THRES_POS_SPEC_FLAT = f32(0.6)
LIMIT_PEAK_SPACING_FLAT = f32(2 * f32(0.05))
LIMIT_PEAK_SPACING_DIFF = f32(2 * f32(0.1))
LIMIT_PEAK_WEIGHTS = f32(0.5)
THRES_FLUCT_LRT = f32(0.05)
MAX_LRT, MIN_LRT = f32(1.0), f32(0.2)
MAX_SPEC_FLAT, MIN_SPEC_FLAT = f32(0.95), f32(0.1)
MAX_SPEC_DIFF, MIN_SPEC_DIFF = f32(1.0), f32(0.16)
THRES_WEIGHT = int(0.3 * 500)  # 150
MODEL_UPDATE_WINDOW = 500

OVERDRIVE = f32(1.1)
DENOISE_BOUND = f32(0.125)
K_START_BAND = 5


def _c(x) -> float:
    """A float32 constant as the Python float torch casts back exactly."""
    return float(f32(x))


def block_len(fs: int) -> int:
    return 80 if fs == 8000 else 160


def ana_len(fs: int) -> int:
    return 128 if fs == 8000 else 256


def magn_len(fs: int) -> int:
    return ana_len(fs) // 2 + 1


@functools.lru_cache(maxsize=None)
def _window(n: int) -> np.ndarray:
    """kBlocks80w128 / kBlocks160w256 (windows_private.h), regenerated
    with the 8-decimal rounding of the printed tables."""
    ramp = n * 3 // 8
    denom = ramp * 2
    vals = [math.sin(math.pi * i / denom) for i in range(ramp)]
    vals += [1.0] * (n - 2 * ramp)
    vals += [math.sin(math.pi * (n - i) / denom) for i in range(n - ramp, n)]
    return np.array([np.float32("%.8f" % v) for v in vals], np.float32)


@functools.lru_cache(maxsize=None)
def _startup_log_consts(m: int):
    """Host f32 folds of log(i) and log(i)^2 for i in [5, m) plus the
    per-bin f32 log(i) table (ns_core.c:1093-1095)."""
    logs = np.zeros(m, np.float32)
    s1 = np.float32(0.0)
    s2 = np.float32(0.0)
    for i in range(K_START_BAND, m):
        t = np.float32(math.log(float(i)))
        logs[i] = t
        s1 = np.float32(s1 + t)
        s2 = np.float32(s2 + np.float32(t * t))
    return logs, s1, s2


@functools.lru_cache(maxsize=None)
def _bin_mids(bin_size_bits: bytes) -> np.ndarray:
    bin_size = np.frombuffer(bin_size_bits, np.float32)[0]
    i = np.arange(HIST_PAR_EST, dtype=np.float64)
    return ((i.astype(np.float32) + np.float32(0.5)) * bin_size).astype(
        np.float32)


class NsState(NamedTuple):
    """NoiseSuppressionC (ns_core.h); every leaf [B, ...]."""
    analyze_buf: torch.Tensor       # [B, A]
    data_buf: torch.Tensor          # [B, A]
    synt_buf: torch.Tensor          # [B, A]
    data_buf_hb: torch.Tensor       # [B, 1, A]
    noise: torch.Tensor             # [B, M]
    noise_prev: torch.Tensor
    magn_prev_analyze: torch.Tensor
    magn_prev_process: torch.Tensor
    magn_avg_pause: torch.Tensor
    init_magn_est: torch.Tensor
    parametric_noise: torch.Tensor
    smooth: torch.Tensor
    speech_prob: torch.Tensor
    log_lrt_time_avg: torch.Tensor
    quantile: torch.Tensor
    lquantile: torch.Tensor         # [B, SIMULT, M]
    density: torch.Tensor           # [B, SIMULT, M]
    counter: torch.Tensor           # [B, SIMULT] i32
    updates: torch.Tensor           # [B] i32
    block_ind: torch.Tensor         # [B] i32
    prior_speech_prob: torch.Tensor  # [B] f32
    feature_data: torch.Tensor      # [B, 7]
    prior_model: torch.Tensor       # [B, 7]
    update_countdown: torch.Tensor  # [B] i32
    hist_lrt: torch.Tensor          # [B, 1000] i32
    hist_spec_flat: torch.Tensor
    hist_spec_diff: torch.Tensor
    white_noise_level: torch.Tensor  # [B] f32
    pink_noise_numerator: torch.Tensor
    pink_noise_exp: torch.Tensor
    signal_energy: torch.Tensor
    sum_magn: torch.Tensor


def init_state(batch: int, fs: int, device=None) -> NsState:
    """WebRtcNs_InitCore (ns_core.c:74-214), policy 2, for B streams."""
    device = resolve_device(device)
    A, M = ana_len(fs), magn_len(fs)

    def full(shape, v, dt=F32):
        return torch.full((batch,) + tuple(shape), v, dtype=dt,
                          device=device)

    counters = torch.tensor(
        [int(math.floor(END_STARTUP_LONG * (i + 1) / SIMULT))
         for i in range(SIMULT)], dtype=I32, device=device)
    fd = torch.tensor([_c(SF_FEATURE_THR), 0, 0, _c(LRT_FEATURE_THR),
                       _c(SF_FEATURE_THR), 0, 0], dtype=F32, device=device)
    pm = torch.tensor([_c(LRT_FEATURE_THR), 0.5, 1.0, 0.5, 1.0, 0, 0],
                      dtype=F32, device=device)
    return NsState(
        analyze_buf=full((A,), 0.0), data_buf=full((A,), 0.0),
        synt_buf=full((A,), 0.0), data_buf_hb=full((1, A), 0.0),
        noise=full((M,), 0.0), noise_prev=full((M,), 0.0),
        magn_prev_analyze=full((M,), 0.0), magn_prev_process=full((M,), 0.0),
        magn_avg_pause=full((M,), 0.0), init_magn_est=full((M,), 0.0),
        parametric_noise=full((M,), 0.0),
        smooth=full((M,), 1.0), speech_prob=full((M,), 0.0),
        log_lrt_time_avg=full((M,), _c(LRT_FEATURE_THR)),
        quantile=full((M,), 0.0),
        lquantile=full((SIMULT, M), 8.0), density=full((SIMULT, M), 0.3),
        counter=counters.expand(batch, SIMULT).clone(),
        updates=full((), 0, I32), block_ind=full((), -1, I32),
        prior_speech_prob=full((), 0.5),
        feature_data=fd.expand(batch, 7).clone(),
        prior_model=pm.expand(batch, 7).clone(),
        update_countdown=full((), MODEL_UPDATE_WINDOW, I32),
        hist_lrt=full((HIST_PAR_EST,), 0, I32),
        hist_spec_flat=full((HIST_PAR_EST,), 0, I32),
        hist_spec_diff=full((HIST_PAR_EST,), 0, I32),
        white_noise_level=full((), 0.0), pink_noise_numerator=full((), 0.0),
        pink_noise_exp=full((), 0.0), signal_energy=full((), 0.0),
        sum_magn=full((), 0.0))


def select(mask: torch.Tensor, a, b):
    """Per-stream select between two state tuples (mask [B] bool)."""
    def one(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(m, x, y)
    return type(a)(*(one(x, y) for x, y in zip(a, b)))


def _set_col(mat: torch.Tensor, k: int, val: torch.Tensor) -> torch.Tensor:
    """mat[:, k] = val, out of place."""
    out = mat.clone()
    out[:, k] = val
    return out


def _fft(win: torch.Tensor):
    """FFT helper (ns_core.c:886-911): rdft + magnitude with +1 floor."""
    a = rdft_traced(win)
    n = win.shape[-1]
    M = n // 2 + 1
    zero = torch.zeros_like(a[:, :1])
    real = torch.cat([a[:, 0:1], a[:, 2::2], a[:, 1:2]], dim=1)
    imag = torch.cat([zero, a[:, 3::2], zero], dim=1)
    mid = fsqrt_d(real[:, 1:M - 1] * real[:, 1:M - 1] +
                  imag[:, 1:M - 1] * imag[:, 1:M - 1]) + 1.0
    magn = torch.cat([real[:, 0:1].abs() + 1.0, mid,
                      real[:, M - 1:M].abs() + 1.0], dim=1)
    return real, imag, magn


def _ifft(real, imag, n: int):
    """IFFT helper (ns_core.c:923-944) including the 2/n scaling."""
    pairs = torch.stack([real[:, 1:-1], imag[:, 1:-1]], dim=-1).reshape(
        real.shape[0], -1)
    a = torch.cat([real[:, 0:1], real[:, -1:], pairs], dim=1)
    return rdft_traced(a, inverse=True) * _c(f32(2.0) / f32(n))


# ------------------------------------------------ noise estimation (:217-285)

_DENS_INC = _c(f32(1.0) / f32(2.0 * float(WIDTH)))


def _noise_estimation(st: NsState, magn):
    updates = st.updates + (st.updates < END_STARTUP_LONG).to(I32)
    lmagn = flog(magn)
    lq_rows, dens_rows, ctr_rows = [], [], []
    quantile = st.quantile
    for s in range(SIMULT):
        lq_s = st.lquantile[:, s]
        dens_s = st.density[:, s]
        ctr_s = st.counter[:, s:s + 1]
        cnt1 = (ctr_s + 1).to(F32)
        delta = torch.where(dens_s > 1.0, _c(FACTOR) / dens_s,
                            torch.full_like(dens_s, _c(FACTOR)))
        up = lq_s + (_c(QUANTILE) * delta) / cnt1
        dn = lq_s - (_c(f32(1.0) - QUANTILE) * delta) / cnt1
        new_lq = torch.where(lmagn > lq_s, up, dn)
        new_dens = torch.where(
            (lmagn - new_lq).abs() < _c(WIDTH),
            (ctr_s.to(F32) * dens_s + _DENS_INC) / cnt1, dens_s)
        lq_rows.append(new_lq)
        dens_rows.append(new_dens)
        wrap = ctr_s >= END_STARTUP_LONG
        take = wrap & (updates[:, None] >= END_STARTUP_LONG)
        quantile = torch.where(take, fexp(new_lq), quantile)
        ctr_rows.append(torch.where(wrap, 0, ctr_s) + 1)
    lq = torch.stack(lq_rows, dim=1)
    quantile = torch.where((updates < END_STARTUP_LONG)[:, None],
                           fexp(lq[:, SIMULT - 1]), quantile)
    st = st._replace(lquantile=lq, density=torch.stack(dens_rows, dim=1),
                     counter=torch.cat(ctr_rows, dim=1).to(I32),
                     updates=updates, quantile=quantile)
    return st, quantile


# ------------------------------------------- feature extraction (:293-634)

def _hist_bin(value, bin_size):
    ok = (value < float(HIST_PAR_EST * bin_size)) & (value >= 0.0)
    idx = (value / _c(bin_size)).to(I32)
    return ok, idx.clamp(0, HIST_PAR_EST - 1)


def _hist_add(hist, idx, inc):
    return torch.scatter_add(hist, 1, idx[:, None].to(torch.int64),
                             inc[:, None].to(hist.dtype))


def _two_peaks(hist, bin_mids):
    """First/second histogram peak scan (ns_core.c:386-432): first-
    occurrence argmax, then argmax of the rest."""
    i1 = torch.argmax(hist, dim=1, keepdim=True)
    p1 = torch.gather(hist, 1, i1)[:, 0]
    rest = torch.where(torch.arange(hist.shape[1], device=hist.device) == i1,
                       -1, hist)
    i2 = torch.argmax(rest, dim=1, keepdim=True)
    p2 = torch.gather(rest, 1, i2)[:, 0].clamp_min(0)
    pos1 = torch.where(p1 > 0, bin_mids[i1[:, 0]], 0.0)
    pos2 = torch.where(p2 > 0, bin_mids[i2[:, 0]], 0.0)
    return p1, pos1, p2, pos2


def _mids(bin_size, device):
    return torch.from_numpy(_bin_mids(bin_size.tobytes())).to(device)


def _feature_parameter_extraction(st: NsState):
    """flag == 1 path (ns_core.c:337-517); computed every frame and
    selected by the caller on window boundaries."""
    dev = st.hist_lrt.device
    mids_lrt = _mids(BIN_SIZE_LRT, dev)
    mids_flat = _mids(BIN_SIZE_SPEC_FLAT, dev)
    mids_diff = _mids(BIN_SIZE_SPEC_DIFF, dev)
    hist_lrt_f = st.hist_lrt.to(F32)

    in_range = mids_lrt <= _c(RANGE_AVG_HIST_LRT)
    compl_terms = hist_lrt_f * mids_lrt
    avg_hist = torch.where(in_range, compl_terms, 0.0).sum(dim=1)
    avg_sq = (compl_terms * mids_lrt).sum(dim=1)
    avg_compl = compl_terms.sum(dim=1)
    num_hist = torch.where(in_range, st.hist_lrt, 0).sum(dim=1)
    avg_hist = torch.where(num_hist > 0, avg_hist / num_hist.to(F32),
                           avg_hist)
    avg_compl = avg_compl / float(MODEL_UPDATE_WINDOW)
    avg_sq = avg_sq / float(MODEL_UPDATE_WINDOW)
    fluct_lrt = avg_sq - avg_hist * avg_compl

    low_fluct = fluct_lrt < _c(THRES_FLUCT_LRT)
    thr_lrt = torch.where(
        low_fluct, _c(MAX_LRT),
        (_c(FACTOR1_MODEL_PARS) * avg_hist).clamp(_c(MIN_LRT), _c(MAX_LRT)))

    w1f, pos1f, w2f, pos2f = _two_peaks(st.hist_spec_flat, mids_flat)
    mergef = ((pos2f - pos1f).abs() < _c(LIMIT_PEAK_SPACING_FLAT)) & \
        (w2f.to(F32) > _c(LIMIT_PEAK_WEIGHTS) * w1f.to(F32))
    w1f = torch.where(mergef, w1f + w2f, w1f)
    pos1f = torch.where(mergef, 0.5 * (pos1f + pos2f), pos1f)
    use_flat = ~((w1f < THRES_WEIGHT) | (pos1f < _c(THRES_POS_SPEC_FLAT)))
    thr_flat = torch.where(
        use_flat,
        (_c(FACTOR2_MODEL_PARS) * pos1f).clamp(_c(MIN_SPEC_FLAT),
                                               _c(MAX_SPEC_FLAT)),
        st.prior_model[:, 1])

    w1d, pos1d, w2d, pos2d = _two_peaks(st.hist_spec_diff, mids_diff)
    merged = ((pos2d - pos1d).abs() < _c(LIMIT_PEAK_SPACING_DIFF)) & \
        (w2d.to(F32) > _c(LIMIT_PEAK_WEIGHTS) * w1d.to(F32))
    w1d = torch.where(merged, w1d + w2d, w1d)
    pos1d = torch.where(merged, 0.5 * (pos1d + pos2d), pos1d)
    thr_diff = (_c(FACTOR1_MODEL_PARS) * pos1d).clamp(_c(MIN_SPEC_DIFF),
                                                      _c(MAX_SPEC_DIFF))
    use_diff = ~(w1d < THRES_WEIGHT) & ~low_fluct

    feature_sum = (1 + use_flat.to(I32) + use_diff.to(I32)).to(F32)
    pm = st.prior_model.clone()
    pm[:, 0] = thr_lrt
    pm[:, 1] = thr_flat
    pm[:, 3] = thr_diff
    pm[:, 4] = 1.0 / feature_sum
    pm[:, 5] = use_flat.to(F32) / feature_sum
    pm[:, 6] = use_diff.to(F32) / feature_sum
    return st._replace(
        prior_model=pm,
        hist_lrt=torch.zeros_like(st.hist_lrt),
        hist_spec_flat=torch.zeros_like(st.hist_spec_flat),
        hist_spec_diff=torch.zeros_like(st.hist_spec_diff))


def _feature_update(st: NsState, magn, M: int):
    """FeatureUpdate (ns_core.c:755-791) with its two callees."""
    mf = float(M)
    # ComputeSpectralFlatness (:523-556); magn >= 1, so no log(0) return
    den = (st.sum_magn - magn[:, 0]) / mf
    num = flog(magn[:, 1:]).sum(dim=1) / mf
    spectral_tmp = fexp(num) / den
    fd = st.feature_data.clone()
    fd[:, 0] = fd[:, 0] + _c(SPECT_FL_TAVG) * (spectral_tmp - fd[:, 0])

    # ComputeSpectralDifference (:595-634)
    avg_pause = st.magn_avg_pause.sum(dim=1) / mf
    avg_magn = st.sum_magn / mf
    dm = magn - avg_magn[:, None]
    dp = st.magn_avg_pause - avg_pause[:, None]
    cov = (dm * dp).sum(dim=1) / mf
    var_pause = (dp * dp).sum(dim=1) / mf
    var_magn = (dm * dm).sum(dim=1) / mf
    fd[:, 6] = fd[:, 6] + st.signal_energy
    avg_diff = var_magn - (cov * cov) / (var_pause + _c(1e-4))
    avg_diff = avg_diff / (fd[:, 5] + _c(1e-4))
    fd[:, 4] = fd[:, 4] + _c(SPECT_DIFF_TAVG) * (avg_diff - fd[:, 4])
    st = st._replace(feature_data=fd)

    # histogram bookkeeping; modelUpdatePars[0] == 2 -> always on
    countdown = st.update_countdown - 1
    ok_l, i_l = _hist_bin(fd[:, 3], BIN_SIZE_LRT)
    ok_f, i_f = _hist_bin(fd[:, 0], BIN_SIZE_SPEC_FLAT)
    ok_d, i_d = _hist_bin(fd[:, 4], BIN_SIZE_SPEC_DIFF)
    update_hist = countdown > 0
    st_hist = st._replace(
        hist_lrt=_hist_add(st.hist_lrt, i_l, ok_l & update_hist),
        hist_spec_flat=_hist_add(st.hist_spec_flat, i_f,
                                 ok_f & update_hist),
        hist_spec_diff=_hist_add(st.hist_spec_diff, i_d,
                                 ok_d & update_hist),
        update_countdown=countdown)

    extracted = _feature_parameter_extraction(st_hist)
    fd2 = extracted.feature_data.clone()
    fd2[:, 6] = fd2[:, 6] / float(MODEL_UPDATE_WINDOW)
    fd2[:, 5] = 0.5 * (fd2[:, 6] + fd2[:, 5])
    fd2[:, 6] = 0.0
    extracted = extracted._replace(
        feature_data=fd2,
        update_countdown=torch.full_like(countdown, MODEL_UPDATE_WINDOW))
    return select(countdown == 0, extracted, st_hist)


# ---------------------------------------------- speech probability (:642-749)

def _speech_noise_prob(st: NsState, snr_prior, snr_post, M: int):
    t1 = 1.0 + 2.0 * snr_prior
    t2 = (2.0 * snr_prior) / (t1 + _c(1e-4))
    bessel = (snr_post + 1.0) * t2
    lrt = st.log_lrt_time_avg
    lrt = lrt + _c(LRT_TAVG) * ((bessel - flog(t1)) - lrt)
    ksum = lrt.sum(dim=1) / float(M)
    fd = _set_col(st.feature_data, 3, ksum)

    pm = st.prior_model
    thr0, thr1, sgn_map, thr2 = pm[:, 0], pm[:, 1], pm[:, 2], pm[:, 3]
    w0, w1, w2 = pm[:, 4], pm[:, 5], pm[:, 6]
    wide, narrow = _c(2.0 * WIDTH_PR_MAP), _c(WIDTH_PR_MAP)

    wp0 = torch.where(ksum < thr0, wide, narrow)
    ind0 = 0.5 * (ftanh(wp0 * (ksum - thr0)) + 1.0)
    tf = fd[:, 0]
    wp1 = torch.where((sgn_map == 1.0) & (tf > thr1), wide, narrow)
    ind1 = 0.5 * (ftanh(sgn_map * wp1 * (thr1 - tf)) + 1.0)
    td = fd[:, 4]
    wp2 = torch.where(td < thr2, wide, narrow)
    ind2 = 0.5 * (ftanh(wp2 * (td - thr2)) + 1.0)

    ind_prior = (w0 * ind0 + w1 * ind1) + w2 * ind2
    prior = st.prior_speech_prob + _c(PRIOR_UPDATE) * (
        ind_prior - st.prior_speech_prob)
    prior = prior.clamp(max=1.0).clamp(min=_c(0.01))
    gain_prior = (1.0 - prior) / (prior + _c(1e-4))
    inv_lrt = gain_prior[:, None] * fexp(-lrt)
    prob = 1.0 / (1.0 + inv_lrt)
    return st._replace(log_lrt_time_avg=lrt, feature_data=fd,
                       prior_speech_prob=prior, speech_prob=prob)


def _update_noise_estimate(st: NsState, magn, noise):
    """UpdateNoiseEstimate (ns_core.c:800-846); the gamma carried across
    bins becomes a shifted vector."""
    prob = st.speech_prob
    pn = 1.0 - prob
    gamma = torch.where(prob > _c(PROB_RANGE), _c(SPEECH_UPDATE_G),
                        _c(NOISE_UPDATE_G))
    gamma_prev = torch.cat(
        [torch.full_like(gamma[:, :1], _c(NOISE_UPDATE_G)), gamma[:, :-1]],
        dim=1)
    blend = pn * magn + prob * st.noise_prev
    noise_tmp = gamma_prev * st.noise_prev + (1.0 - gamma_prev) * blend
    pause = torch.where(prob < _c(PROB_RANGE),
                        st.magn_avg_pause + _c(GAMMA_PAUSE) * (
                            magn - st.magn_avg_pause),
                        st.magn_avg_pause)
    noise_new = gamma * st.noise_prev + (1.0 - gamma) * blend
    noise_new = torch.minimum(noise_new, noise_tmp)
    out = torch.where(gamma == gamma_prev, noise_tmp, noise_new)
    return st._replace(magn_avg_pause=pause), out


# ------------------------------------------------ AnalyzeCore (:1043-1181)

def _win(A: int, device) -> torch.Tensor:
    return torch.from_numpy(_window(A)).to(device)


def analyze(st: NsState, frame, fs: int) -> NsState:
    B, A, M = block_len(fs), ana_len(fs), magn_len(fs)
    buf = torch.cat([st.analyze_buf[:, B:], frame.to(F32)], dim=1)
    st = st._replace(analyze_buf=buf)
    win = _win(A, buf.device) * buf
    energy = (win * win).sum(dim=1)
    new = _analyze_active(st, win, M)
    return select(energy != 0.0, new, st)


def _analyze_active(st: NsState, win, M: int):
    block_ind = st.block_ind + 1
    real, imag, magn = _fft(win)
    dev = magn.device

    signal_energy = (real[:, :M] * real[:, :M] +
                     imag[:, :M] * imag[:, :M]).sum(dim=1) / float(M)
    sum_magn = magn.sum(dim=1)
    st = st._replace(signal_energy=signal_energy, sum_magn=sum_magn,
                     block_ind=block_ind)

    # startup pink/white-noise regression sums
    logs_i, sum_log_i, sum_log_i_sq = _startup_log_consts(M)
    lm = flog(magn)
    band = torch.arange(M, device=dev) >= K_START_BAND
    sum_log_magn = torch.where(band, lm, 0.0).sum(dim=1)
    sum_log_il = torch.where(band, torch.from_numpy(logs_i).to(dev) * lm,
                             0.0).sum(dim=1)

    st, noise = _noise_estimation(st, magn)

    in_short = block_ind < END_STARTUP_SHORT
    wn = st.white_noise_level + (sum_magn / float(M)) * _c(OVERDRIVE)
    # pink noise regression (ns_core.c:1113-1133); t1 is a compile-time
    # constant in C too
    t1 = _c(f32(f32(sum_log_i_sq * f32(M - K_START_BAND)) -
                f32(sum_log_i) * f32(sum_log_i)))
    t2 = _c(sum_log_i_sq) * sum_log_magn - _c(sum_log_i) * sum_log_il
    t3 = (t2 / t1).clamp_min(0.0)
    pnum = st.pink_noise_numerator + t3
    t2b = _c(sum_log_i) * sum_log_magn - float(M - K_START_BAND) * sum_log_il
    t3b = (t2b / t1).clamp(0.0, 1.0)
    pexp = st.pink_noise_exp + t3b

    bi1 = (block_ind + 1).to(F32)
    param_num = fexp(pnum / bi1) * bi1
    param_exp = pexp / bi1
    use_band = torch.arange(M, device=dev).clamp_min(K_START_BAND).to(F32)
    pnoise = torch.where((pexp == 0.0)[:, None], wn[:, None].expand(-1, M),
                         fpow_div(param_num[:, None], use_band[None, :],
                                  param_exp[:, None]))
    noise_s = noise * block_ind.to(F32)[:, None]
    tmp2 = pnoise * (END_STARTUP_SHORT - block_ind).to(F32)[:, None]
    noise_s = noise_s + tmp2 / bi1[:, None]
    noise_s = noise_s / float(END_STARTUP_SHORT)

    noise = torch.where(in_short[:, None], noise_s, noise)
    st = st._replace(
        white_noise_level=torch.where(in_short, wn, st.white_noise_level),
        pink_noise_numerator=torch.where(in_short, pnum,
                                         st.pink_noise_numerator),
        pink_noise_exp=torch.where(in_short, pexp, st.pink_noise_exp),
        parametric_noise=torch.where(in_short[:, None], pnoise,
                                     st.parametric_noise))

    # featureData[5]: average signal energy during startup (:1165-1169)
    fd = st.feature_data
    fd5 = (fd[:, 5] * block_ind.to(F32) + signal_energy) / bi1
    fd = _set_col(fd, 5, torch.where(block_ind < END_STARTUP_LONG, fd5,
                                     fd[:, 5]))
    st = st._replace(feature_data=fd)

    # ComputeSnr (:566-588)
    prev_stsa = (st.magn_prev_analyze / (st.noise_prev + _c(1e-4))) * \
        st.smooth
    snr_post = torch.where(magn > noise,
                           magn / (noise + _c(1e-4)) - 1.0, 0.0)
    snr_prior = _c(DD_PR_SNR) * prev_stsa + \
        _c(f32(1.0) - DD_PR_SNR) * snr_post

    st = _feature_update(st, magn, M)
    st = _speech_noise_prob(st, snr_prior, snr_post, M)
    st, noise = _update_noise_estimate(st, magn, noise)
    return st._replace(noise=noise, magn_prev_analyze=magn)


# ------------------------------------------------ ProcessCore (:1183-1415)

def process(st: NsState, frame, fs: int):
    """frame: [B, block] float32, the low band (mono).  Returns (state,
    out [B, block])."""
    B, A, M = block_len(fs), ana_len(fs), magn_len(fs)
    data_buf = torch.cat([st.data_buf[:, B:], frame.to(F32)], dim=1)
    st = st._replace(data_buf=data_buf)
    window = _win(A, data_buf.device)
    win = window * data_buf
    energy1 = (win * win).sum(dim=1)
    active = energy1 != 0.0

    # zero-input path (:1239-1264)
    out_zero = st.synt_buf[:, :B].clamp(-32768.0, 32767.0)
    synt_z = torch.cat([st.synt_buf[:, B:],
                        torch.zeros_like(st.synt_buf[:, :B])], dim=1)
    st_zero = st._replace(synt_buf=synt_z)

    st_act, out_act = _process_active(st, win, window, energy1, B, A)
    return (select(active, st_act, st_zero),
            torch.where(active[:, None], out_act, out_zero))


def _process_active(st: NsState, win, window, energy1, B: int, A: int):
    real, imag, magn = _fft(win)
    one_m_dd = _c(f32(1.0) - DD_PR_SNR)
    bound = _c(DENOISE_BOUND)

    in_short = (st.block_ind < END_STARTUP_SHORT)[:, None]
    init_est = torch.where(in_short, st.init_magn_est + magn,
                           st.init_magn_est)
    st = st._replace(init_magn_est=init_est)

    # ComputeDdBasedWienerFilter (:985-1007)
    prev_stsa = (st.magn_prev_process / (st.noise_prev + _c(1e-4))) * \
        st.smooth
    cur = torch.where(magn > st.noise,
                      magn / (st.noise + _c(1e-4)) - 1.0, 0.0)
    snr_prior = _c(DD_PR_SNR) * prev_stsa + one_m_dd * cur
    filt = (snr_prior / (_c(OVERDRIVE) + snr_prior)).clamp(bound, 1.0)

    # startup blend (:1285-1302)
    filt_tmp = ((init_est - _c(OVERDRIVE) * st.parametric_noise) /
                (init_est + _c(1e-4))).clamp(bound, 1.0)
    bi = st.block_ind.to(F32)[:, None]
    rest = (END_STARTUP_SHORT - st.block_ind).to(F32)[:, None]
    blended = (filt * bi + filt_tmp * rest) / float(END_STARTUP_SHORT)
    filt = torch.where(in_short, blended, filt)

    st = st._replace(smooth=filt, magn_prev_process=magn,
                     noise_prev=st.noise)
    win_data = _ifft(real * filt, imag * filt, A)

    # gain-map factor (:1314-1342)
    energy2 = (win_data * win_data).sum(dim=1)
    gain = fsqrt_d(energy2 / (energy1 + 1.0))
    f1v = 1.0 + _c(1.3) * (gain - _c(B_LIM))
    factor1 = torch.where(
        gain > _c(B_LIM),
        torch.where(gain * f1v > 1.0, 1.0 / gain, f1v), 1.0)
    g2 = torch.where(gain <= bound, bound, gain)
    factor2 = torch.where(gain < _c(B_LIM),
                          1.0 - _c(0.3) * (_c(B_LIM) - g2), 1.0)
    p = st.prior_speech_prob
    f = p * factor1 + (1.0 - p) * factor2
    factor = torch.where(st.block_ind > END_STARTUP_LONG, f, 1.0)

    synt = st.synt_buf + factor[:, None] * (window * win_data)
    fout = synt[:, :B]
    synt_new = torch.cat([synt[:, B:], torch.zeros_like(synt[:, :B])],
                         dim=1)
    st = st._replace(synt_buf=synt_new)
    return st, fout.clamp(-32768.0, 32767.0)


# --------------------------- daemon wrapper (src/webrtc.c ns_process:612-644)

def process_pkg(st: NsState, pkg, chn: int, freq: int):
    """One daemon package [B, frame_num] of int16-valued ints (mono):
    Analyze + Process per 10 ms subpackage; (int16_t) cast truncates."""
    if chn != 1 or freq == 32000:
        raise NotImplementedError("wmix_tpu_torch NS: mono 8/16 kHz only")
    B = block_len(freq)
    n_sub = pkg.shape[1] // B
    x = pkg.to(F32)
    outs = []
    for i in range(n_sub):
        seg = x[:, i * B:(i + 1) * B]
        st = analyze(st, seg, freq)
        st, out = process(st, seg, freq)
        outs.append(out)
    return st, torch.cat(outs, dim=1).to(I32)
