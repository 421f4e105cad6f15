"""Voice activity detection: the webrtc GMM VAD, batched over streams.

Port of `wmix_tpu/dsp/vad.py`: the 6-band split filterbank with
log-energy features (vad_filterbank.c), the Gaussian pair per band with
the fixed-point probability (vad_gmm.c), minimum tracking and median
smoothing (vad_sp.c), the GMM hypothesis test with model adaptation and
hangover (vad_core.c), the 16 -> 8 kHz downsampling, and the daemon
wrapper's progressive `reduce` mute (src/webrtc.c vad_process:91-151).
Aggressiveness mode 3.  int32 arithmetic with C wrap semantics; every
state leaf carries a leading stream axis.  The filter recursions are
Python loops over [B] tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.intops import (I32, div_w32_w16, norm_u32, norm_w32,
                                       u32, wrap16)

N_CH = 6
N_G = 2
TBL = N_CH * N_G

SPECTRUM_WEIGHT = np.array([6, 8, 10, 12, 14, 16], np.int32)
NOISE_UPDATE = 655      # Q15
SPEECH_UPDATE = 6554    # Q15
BACK_ETA = 154          # Q8
MIN_DIFF = np.array([544, 544, 576, 576, 576, 576], np.int32)
MAX_SPEECH = np.array([11392, 11392, 11520, 11520, 11520, 11520], np.int32)
MIN_MEAN = np.array([640, 768], np.int32)
MAX_NOISE = np.array([9216, 9088, 8960, 8832, 8704, 8576], np.int32)
NOISE_W = np.array([34, 62, 72, 66, 53, 25, 94, 66, 56, 62, 75, 103],
                   np.int32)
SPEECH_W = np.array([48, 82, 45, 87, 50, 47, 80, 46, 83, 41, 78, 81],
                    np.int32)
NOISE_MEANS0 = np.array([6738, 4892, 7065, 6715, 6771, 3369, 7646, 3863,
                         7820, 7266, 5020, 4362], np.int32)
SPEECH_MEANS0 = np.array([8306, 10085, 10078, 11823, 11843, 6309, 9473,
                          9571, 10879, 7581, 8180, 7483], np.int32)
NOISE_STDS0 = np.array([378, 1064, 493, 582, 688, 593, 474, 697, 475, 688,
                        421, 455], np.int32)
SPEECH_STDS0 = np.array([555, 505, 567, 524, 585, 1231, 509, 828, 492,
                         1540, 1079, 850], np.int32)
MAX_SPEECH_FRAMES = 6
MIN_STD = 384
MIN_ENERGY = 10
COMP_VAR = 22005
LOG2_EXP = 5909         # Q12

# mode 3 thresholds indexed by frame length {80, 160, 240}
OVER_HANG_MAX_1 = (6, 3, 2)
OVER_HANG_MAX_2 = (9, 5, 3)
LOCAL_THRESHOLD = (94, 94, 94)
GLOBAL_THRESHOLD = (1100, 1050, 1100)

LOG_CONST = 24660       # 160*log10(2) in Q9
LOG_ENERGY_INT = 14336  # 14 in Q10
HP_ZERO = (6631, -13262, 6631)     # Q14
HP_POLE = (16384, -7756, 5620)     # Q14
ALLPASS_Q15 = (20972, 5571)
OFFSET_VECTOR = (368, 368, 272, 176, 176, 176)
ALLPASS_Q13 = (5243, 1392)
SMOOTH_DOWN = 6553      # 0.2 Q15
SMOOTH_UP = 32439       # 0.99 Q15


class VadState(NamedTuple):
    """Per-stream VAD state (VadInstT + the wrapper's reduce), [B, ...]."""
    noise_means: torch.Tensor    # [B, 12] int32 (int16 semantics)
    speech_means: torch.Tensor
    noise_stds: torch.Tensor
    speech_stds: torch.Tensor
    frame_counter: torch.Tensor  # [B]
    over_hang: torch.Tensor
    num_of_speech: torch.Tensor
    index_vector: torch.Tensor   # [B, 6, 16]
    low_value_vector: torch.Tensor  # [B, 6, 16]
    mean_value: torch.Tensor     # [B, 6]
    upper_state: torch.Tensor    # [B, 5]
    lower_state: torch.Tensor    # [B, 5]
    hp_filter_state: torch.Tensor  # [B, 4]
    ds_state: torch.Tensor       # [B, 4]
    reduce: torch.Tensor         # [B], progressive mute 0..4


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def init_state(batch: int, device=None) -> VadState:
    """WebRtcVad_InitCore (vad_core.c:482-536) + wrapper reduce=4."""
    device = resolve_device(device)
    def rows(a):
        return _t(a, device).expand(batch, -1).clone()

    def full(shape, v):
        return torch.full((batch,) + shape, v, dtype=I32, device=device)
    return VadState(
        noise_means=rows(NOISE_MEANS0), speech_means=rows(SPEECH_MEANS0),
        noise_stds=rows(NOISE_STDS0), speech_stds=rows(SPEECH_STDS0),
        frame_counter=full((), 0), over_hang=full((), 0),
        num_of_speech=full((), 0),
        index_vector=full((N_CH, 16), 0),
        low_value_vector=full((N_CH, 16), 10000),
        mean_value=full((N_CH,), 1600),
        upper_state=full((5,), 0), lower_state=full((5,), 0),
        hp_filter_state=full((4,), 0), ds_state=full((4,), 0),
        reduce=full((), 4))


# ------------------------------------------------ filterbank (vad_filterbank.c)

def _allpass_pair(data, coef, state16):
    """Two AllPassFilters (vad_filterbank.c:83-108) side by side: data
    [B, 2, n], coef [2], state16 [B, 2]."""
    state32 = state16.to(I32) << 16
    outs = []
    for i in range(data.shape[2]):
        x = data[:, :, i]
        tmp16 = wrap16((state32 + coef * x) >> 16)
        state32 = ((x << 14) - coef * tmp16) << 1
        outs.append(tmp16)
    return torch.stack(outs, dim=2), wrap16(state32 >> 16)


def _split_filter(data, up16, lo16):
    """SplitFilter (vad_filterbank.c:121-142)."""
    coef = _t(ALLPASS_Q15, data.device)
    out, st = _allpass_pair(torch.stack([data[:, 0::2], data[:, 1::2]],
                                        dim=1),
                            coef, torch.stack([up16, lo16], dim=1))
    hp, lp = out[:, 0], out[:, 1]
    return wrap16(hp - lp), wrap16(lp + hp), st[:, 0], st[:, 1]


def _highpass(data, state):
    """HighPassFilter (vad_filterbank.c:41-72); state [B, 4]."""
    f0, f1, f2, f3 = (state[:, i] for i in range(4))
    outs = []
    for i in range(data.shape[1]):
        x = data[:, i]
        tmp32 = HP_ZERO[0] * x + HP_ZERO[1] * f0 + HP_ZERO[2] * f1
        f1, f0 = f0, x
        tmp32 = tmp32 - HP_POLE[1] * f2 - HP_POLE[2] * f3
        f3 = f2
        f2 = wrap16(tmp32 >> 14)
        outs.append(f2)
    return torch.stack(outs, dim=1), torch.stack([f0, f1, f2, f3], dim=1)


def _log_of_energy(data, length: int, offset: int, total_energy):
    """LogOfEnergy (vad_filterbank.c:155-244)."""
    # WebRtcSpl_GetScalingSquare: sabs wraps to int16, so -32768 stays
    # -32768 and never wins the max (a reference quirk)
    sabs = wrap16(data.abs())
    smax = sabs.amax(dim=1).clamp_min(-1)
    nbits = int(length).bit_length()
    t = norm_w32(smax * smax)
    scaling = torch.where(smax == 0, 0,
                          torch.where(t > nbits, 0, nbits - t)).to(I32)
    en = ((data * data) >> scaling[:, None]).sum(dim=1).to(I32)
    energy = u32(en)

    nonzero = energy != 0
    norm_rs = (17 - norm_u32(energy)).to(torch.int64)
    tot_rshifts = scaling + norm_rs.to(I32)
    e_norm = torch.where(norm_rs < 0,
                         (energy << (-norm_rs).clamp_min(0)) & 0xFFFFFFFF,
                         energy >> norm_rs.clamp_min(0))
    log2_energy = wrap16(LOG_ENERGY_INT + ((e_norm & 0x3FFF).to(I32) >> 4))
    log_e = wrap16(((LOG_CONST * log2_energy) >> 19) +
                   ((tot_rshifts * LOG_CONST) >> 9))
    log_e = wrap16(log_e.clamp_min(0) + offset)
    log_energy = torch.where(nonzero, log_e, offset).to(I32)

    # total_energy updates only on the nonzero path
    add = torch.where(
        tot_rshifts >= 0, MIN_ENERGY + 1,
        wrap16(energy >> (-tot_rshifts.clamp(max=0)).to(torch.int64)))
    te = torch.where(nonzero & (total_energy <= MIN_ENERGY),
                     wrap16(total_energy + add), total_energy)
    return log_energy, te


def _calculate_features(state: VadState, frame):
    """WebRtcVad_CalculateFeatures (vad_filterbank.c:246-333), frame
    [B, n] at 8 kHz.  Returns (features [B, 6], total energy, state)."""
    n = frame.shape[1]
    up, lo = state.upper_state, state.lower_state
    features = [None] * 6
    total = torch.zeros_like(frame[:, 0])
    hp120, lp120, u0, l0 = _split_filter(frame, up[:, 0], lo[:, 0])
    hp60, lp60, u1, l1 = _split_filter(hp120, up[:, 1], lo[:, 1])
    features[5], total = _log_of_energy(hp60, n // 4, OFFSET_VECTOR[5],
                                        total)
    features[4], total = _log_of_energy(lp60, n // 4, OFFSET_VECTOR[4],
                                        total)
    hp60b, lp60b, u2, l2 = _split_filter(lp120, up[:, 2], lo[:, 2])
    features[3], total = _log_of_energy(hp60b, n // 4, OFFSET_VECTOR[3],
                                        total)
    hp120b, lp120b, u3, l3 = _split_filter(lp60b, up[:, 3], lo[:, 3])
    features[2], total = _log_of_energy(hp120b, n // 8, OFFSET_VECTOR[2],
                                        total)
    hp60c, lp60c, u4, l4 = _split_filter(lp120b, up[:, 4], lo[:, 4])
    features[1], total = _log_of_energy(hp60c, n // 16, OFFSET_VECTOR[1],
                                        total)
    hp_out, hp_state = _highpass(lp60c, state.hp_filter_state)
    features[0], total = _log_of_energy(hp_out, n // 16, OFFSET_VECTOR[0],
                                        total)
    return (torch.stack(features, dim=1), total,
            state._replace(upper_state=torch.stack([u0, u1, u2, u3, u4], 1),
                           lower_state=torch.stack([l0, l1, l2, l3, l4], 1),
                           hp_filter_state=hp_state))


# ------------------------------------------------ gaussian probability

def _gaussian_probability(inp, mean, std):
    """WebRtcVad_GaussianProbability (vad_gmm.c:30-83), elementwise.
    Returns (probability, delta Q11)."""
    inv_std = wrap16(div_w32_w16(131072 + (std >> 1), std))
    tmp16 = inv_std >> 2
    inv_std2 = wrap16((tmp16 * tmp16) >> 2)
    xm = wrap16(wrap16(inp << 3) - mean)
    delta = wrap16((inv_std2 * xm) >> 10)
    expo = (delta * xm) >> 9

    t16 = wrap16(-wrap16((LOG2_EXP * expo) >> 12))
    exp_value = 0x0400 | (t16 & 0x03FF)
    t16 = (wrap16(t16 ^ 0xFFFF) >> 10) + 1
    exp_value = exp_value >> t16.clamp(0, 31)
    exp_value = torch.where(expo < COMP_VAR, exp_value, 0)
    return inv_std * exp_value, delta


# ------------------------------------------------ minimum tracking (vad_sp.c)

def _find_minimum(vals, ages, mean, frame_counter, feature):
    """WebRtcVad_FindMinimum (vad_sp.c:59-177) for all six channels:
    vals/ages [B, 6, 16], mean/feature [B, 6], frame_counter [B]."""
    idx16 = torch.arange(16, dtype=I32, device=vals.device)
    # aging loop with removal, literally (entry order matters)
    for i in range(16):
        is_removal = ages[:, :, i:i + 1] == 100
        tail = idx16 >= i
        v_shift = torch.where(tail, torch.roll(vals, -1, dims=2), vals)
        v_shift = torch.where(idx16 == 15, 10000, v_shift)
        a_shift = torch.where(tail, torch.roll(ages, -1, dims=2), ages)
        a_shift = torch.where(idx16 == 15, 101, a_shift)
        a_inc = torch.where(idx16 == i, ages + 1, ages)
        vals = torch.where(is_removal, v_shift, vals)
        ages = torch.where(is_removal, a_shift, a_inc)

    # insertion: first index with feature < vals[idx]
    f = feature[:, :, None]
    pos = (vals <= f).to(I32).sum(dim=2, keepdim=True).to(I32)
    do_insert = pos < 16
    v_shift = torch.where(idx16 > pos, torch.roll(vals, 1, dims=2), vals)
    a_shift = torch.where(idx16 > pos, torch.roll(ages, 1, dims=2), ages)
    at = idx16 == pos.clamp(0, 15)
    vals = torch.where(do_insert, torch.where(at, f, v_shift), vals)
    ages = torch.where(do_insert, torch.where(at, 1, a_shift), ages)

    fc = frame_counter[:, None]
    median = torch.where(fc > 2, vals[:, :, 2],
                         torch.where(fc > 0, vals[:, :, 0], 1600))
    alpha = torch.where(fc > 0,
                        torch.where(median < mean, SMOOTH_DOWN, SMOOTH_UP),
                        0).to(I32)
    tmp32 = (alpha + 1) * mean + (32767 - alpha) * median + 16384
    mean = wrap16(tmp32 >> 15)
    return vals.to(I32), ages.to(I32), mean


# ------------------------------------------------ GmmProbability (vad_core.c)

def _frame_index(frame_length: int) -> int:
    return {80: 0, 160: 1}.get(frame_length, 2)


def _gmm_probability(state: VadState, features, total_power,
                     frame_length: int):
    """GmmProbability (vad_core.c:124-479); features [B, 6]."""
    dev = features.device
    fi = _frame_index(frame_length)
    Bn = features.shape[0]

    def g6(x):
        return x.reshape(Bn, N_G, N_CH)

    nm, sm = g6(state.noise_means), g6(state.speech_means)
    ns, ss = g6(state.noise_stds), g6(state.speech_stds)
    w_n = _t(NOISE_W, dev).reshape(N_G, N_CH)
    w_s = _t(SPEECH_W, dev).reshape(N_G, N_CH)
    feat = features[:, None, :]

    # hypothesis test over [gaussian, channel]
    probs_n, delta_n = _gaussian_probability(feat, nm, ns)
    probs_s, delta_s = _gaussian_probability(feat, sm, ss)
    np_w = w_n * probs_n
    sp_w = w_s * probs_s
    h0 = np_w.sum(dim=1).to(I32)
    h1 = sp_w.sum(dim=1).to(I32)

    sh0 = torch.where(h0 == 0, 31, norm_w32(h0))
    sh1 = torch.where(h1 == 0, 31, norm_w32(h1))
    llr = sh0 - sh1
    sum_llr = (llr * _t(SPECTRUM_WEIGHT, dev)).sum(dim=1)
    vad_local = ((llr << 2) > LOCAL_THRESHOLD[fi]).any(dim=1)

    h0_16 = wrap16(h0 >> 12)
    h1_16 = wrap16(h1 >> 12)
    ngr0 = wrap16(div_w32_w16((np_w[:, 0] & -4096) << 2,
                              torch.where(h0_16 > 0, h0_16, 1)))
    ngprvec = torch.where((h0_16 > 0)[:, None],
                          torch.stack([ngr0, 16384 - ngr0], dim=1),
                          torch.stack([torch.full_like(ngr0, 16384),
                                       torch.zeros_like(ngr0)], dim=1))
    sgr0 = wrap16(div_w32_w16((sp_w[:, 0] & -4096) << 2,
                              torch.where(h1_16 > 0, h1_16, 1)))
    sgprvec = torch.where((h1_16 > 0)[:, None],
                          torch.stack([sgr0, 16384 - sgr0], dim=1),
                          torch.zeros_like(ngprvec))

    vadflag = torch.where(vad_local | (sum_llr >= GLOBAL_THRESHOLD[fi]),
                          1, 0)[:, None, None]

    fm_vals, fm_ages, fm_mean = _find_minimum(
        state.low_value_vector, state.index_vector, state.mean_value,
        state.frame_counter, features)
    feature_minimum = fm_mean

    # model update over [gaussian, channel]
    tmp1_16 = wrap16((nm * w_n).sum(dim=1) >> 6)[:, None, :]
    delt_n = wrap16((ngprvec * delta_n) >> 11)
    nmk2 = torch.where(vadflag == 0,
                       wrap16(nm + wrap16((delt_n * NOISE_UPDATE) >> 22)),
                       nm)
    ndelt = wrap16((feature_minimum[:, None, :] << 4) - tmp1_16)
    nmk3 = wrap16(nmk2 + wrap16((ndelt * BACK_ETA) >> 9))
    k_idx = torch.arange(N_G, dtype=I32, device=dev)[:, None]
    ch_idx = torch.arange(N_CH, dtype=I32, device=dev)[None, :]
    lo = wrap16((k_idx + 5) << 7)
    hi = wrap16((72 + k_idx - ch_idx) << 7)
    new_nm = torch.minimum(torch.maximum(nmk3, lo), hi)

    # speech model update (vadflag == 1)
    delt_s = wrap16((sgprvec * delta_s) >> 11)
    t16 = wrap16((delt_s * SPEECH_UPDATE) >> 21)
    smk2 = wrap16(sm + ((t16 + 1) >> 1))
    maxspe_seq = _t([12800] + list(MAX_SPEECH[:-1]), dev)
    smk2 = torch.minimum(torch.maximum(smk2, _t(MIN_MEAN, dev)[:, None]),
                         (maxspe_seq + 640)[None, :])
    new_sm = torch.where(vadflag == 1, smk2, sm)

    # speech std update
    t16b = wrap16(feat - ((sm + 4) >> 3))
    t32 = (delta_s * t16b) >> 3
    t32d = ((sgprvec >> 2) * (t32 - 4096)) >> 4
    q = wrap16(div_w32_w16(t32d.abs(), wrap16(ss * 10)))
    t16d = wrap16(torch.where(t32d > 0, q, wrap16(-q)) + 128)
    ssk2 = wrap16(ss + (t16d >> 8)).clamp_min(MIN_STD)
    new_ss = torch.where(vadflag == 1, ssk2, ss)

    # noise std update (vadflag == 0)
    t16e = wrap16(feat - (nm >> 3))
    t32e = ((delta_n * t16e) >> 3) - 4096
    t32g = (((ngprvec + 2) >> 2) * t32e) >> 14
    qn = wrap16(div_w32_w16(t32g.abs(), ns))
    t16g = wrap16(torch.where(t32g > 0, qn, wrap16(-qn)) + 32)
    nsk2 = wrap16(ns + (t16g >> 6)).clamp_min(MIN_STD)
    new_ns = torch.where(vadflag == 0, nsk2, ns)

    # separate models if too close (vad_core.c:402-436)
    noise_gmean2 = (new_nm * w_n).sum(dim=1)
    speech_gmean = (new_sm * w_s).sum(dim=1)
    diff = wrap16(speech_gmean >> 9) - wrap16(noise_gmean2 >> 9)
    min_diff = _t(MIN_DIFF, dev)
    too_close = diff < min_diff
    t16h = wrap16(min_diff - diff)
    up_s = wrap16((13 * t16h) >> 2)[:, None, :]
    dn_n = wrap16((3 * t16h) >> 2)[:, None, :]
    close3 = too_close[:, None, :]
    new_sm = torch.where(close3, wrap16(new_sm + up_s), new_sm)
    new_nm = torch.where(close3, wrap16(new_nm - dn_n), new_nm)
    speech_gmean = torch.where(too_close, (new_sm * w_s).sum(dim=1),
                               speech_gmean)
    noise_gmean2 = torch.where(too_close, (new_nm * w_n).sum(dim=1),
                               noise_gmean2)

    # drift control (vad_core.c:438-457)
    max_speech = _t(MAX_SPEECH, dev)
    t2 = wrap16(speech_gmean >> 7)
    over_s = (t2 - max_speech).clamp_min(0) * (t2 > max_speech)
    new_sm = wrap16(new_sm - over_s[:, None, :])
    max_noise = _t(MAX_NOISE, dev)
    t2n = wrap16(noise_gmean2 >> 7)
    over_n = (t2n - max_noise).clamp_min(0) * (t2n > max_noise)
    new_nm = wrap16(new_nm - over_n[:, None, :])

    # commit only on high-power frames
    power_ok = total_power > MIN_ENERGY

    def sel(new, old):
        m = power_ok.reshape((Bn,) + (1,) * (new.dim() - 1))
        return torch.where(m, new, old).to(I32)

    state = state._replace(
        noise_means=sel(new_nm, nm).reshape(Bn, TBL),
        speech_means=sel(new_sm, sm).reshape(Bn, TBL),
        noise_stds=sel(new_ns, ns).reshape(Bn, TBL),
        speech_stds=sel(new_ss, ss).reshape(Bn, TBL),
        low_value_vector=sel(fm_vals, state.low_value_vector),
        index_vector=sel(fm_ages, state.index_vector),
        mean_value=sel(fm_mean, state.mean_value),
        frame_counter=state.frame_counter + power_ok.to(I32))
    vadflag = torch.where(power_ok, vadflag[:, 0, 0], 0)

    # hangover smoothing (vad_core.c:462-477)
    oh, nsp = state.over_hang, state.num_of_speech
    hang_fire = (vadflag == 0) & (oh > 0)
    out_flag = torch.where(vadflag != 0, vadflag,
                           torch.where(hang_fire, 2 + oh, 0))
    new_over_hang = torch.where(
        vadflag != 0,
        torch.where(nsp + 1 > MAX_SPEECH_FRAMES, OVER_HANG_MAX_2[fi],
                    OVER_HANG_MAX_1[fi]),
        torch.where(hang_fire, oh - 1, oh))
    new_num = torch.where(vadflag != 0,
                          (nsp + 1).clamp(max=MAX_SPEECH_FRAMES), 0)
    state = state._replace(over_hang=new_over_hang.to(I32),
                           num_of_speech=new_num.to(I32))
    return state, out_flag.to(I32)


# ------------------------------------------------ downsampling (vad_sp.c)

def _downsample_by2(frame, st):
    """WebRtcVad_Downsampling (vad_sp.c:27-54); st [B, 2].  The two
    allpass branches run side by side."""
    coef = _t(ALLPASS_Q13, frame.device)
    s = st
    outs = []
    for i in range(frame.shape[1] // 2):
        x = frame[:, 2 * i:2 * i + 2]
        t = wrap16((s >> 1) + ((coef * x) >> 14))
        s = x - ((coef * t) >> 12)
        outs.append(wrap16(t[:, 0] + t[:, 1]))
    return torch.stack(outs, dim=1), s


# ------------------------------------------------ top level

def calc_vad(state: VadState, frame, fs: int):
    """WebRtcVad_CalcVad{8,16}khz (vad_core.c:598-674), frame [B, n].
    Returns (state, decision 0/1 [B])."""
    if fs == 16000:
        nb, ds_lo = _downsample_by2(frame, state.ds_state[:, :2])
        state = state._replace(
            ds_state=torch.cat([ds_lo, state.ds_state[:, 2:]], dim=1))
    elif fs == 8000:
        nb = frame
    else:
        raise NotImplementedError("wmix_tpu_torch VAD: 8 or 16 kHz only")
    features, total_power, state = _calculate_features(state, nb)
    state, flag = _gmm_probability(state, features, total_power,
                                   nb.shape[1])
    return state, (flag > 0).to(I32)


def process(state: VadState, pkg, chn: int, freq: int):
    """The daemon wrapper vad_process (src/webrtc.c:91-151) for one mono
    package [B, frame_num] of 20 ms: per-subpackage VAD + progressive
    reduce, with the first-subpackage-only mute quirk."""
    if chn != 1:
        raise NotImplementedError("wmix_tpu_torch VAD: mono only")
    pkg_frame = freq // 1000 * 20
    out = pkg.to(I32)
    for i in range(out.shape[1] // pkg_frame):
        # the C loop never advances pFrame (src/webrtc.c:120): every
        # subpackage re-processes the FIRST pkgFrame samples
        seg = out[:, :pkg_frame]
        state, flag = calc_vad(state, seg, freq)
        red = torch.where(flag == 0, (state.reduce + 1).clamp(max=4),
                          (state.reduce - 1).clamp(min=0)).to(I32)
        state = state._replace(reduce=red)
        # only the first pass's mute loop attenuates (src/webrtc.c:140)
        if i == 0:
            out = torch.cat([seg >> red[:, None], out[:, pkg_frame:]],
                            dim=1)
    return state, wrap16(out)
