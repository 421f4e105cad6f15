"""AECM: the webrtc mobile echo canceller, batched over streams.

Port of `wmix_tpu/dsp/aecm_jnp.py` (aecm_core.c / aecm_core_c.c and
utility/delay_estimator*.c), one 64-sample block for B streams:

  * TimeToFrequencyDomain with each stream's own Q scaling, over the spl
    int16 FFT of order 7 (`dsp/nsx.py`);
  * the binary-spectrum delay estimator (XOR bit counts over a 100-block
    far history, mean-threshold binarization);
  * the far/near energy VAD, NLMS channel estimation in two Q domains
    (per-bin variable shifts), the MSE arbitration between the stored and
    the adaptive channel;
  * the Wiener gain, NLP and comfort noise, overlap-add synthesis.

Every value is integer and every result bit-equal to the reference, with
the C quirks its history pinned: the int32 wrap of echoFilt's update, and
in nearFilt the int16-wrapping add and the bitwise `&` that lets the
saturation fire only on odd values.  int32 values live in int32 tensors,
uint32 intermediates in int64 tensors masked where C wraps.

What depends on the call pattern (ring cursors, the start-up counter, the
comfort-noise random sequence) comes from the host planner
(`engine/aecm_step.py`) as Python numbers; what depends on the data is a
`torch.where` over the batch.  The far history is written in place.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from wbench.reference.device import resolve_device
from wbench.reference.dsp._aecm_tables import (
    CHANNEL_VAD, ENERGY_DEV_OFFSET, ENERGY_DEV_TOL, FAR_ENERGY_DIFF,
    FAR_ENERGY_MIN, FAR_ENERGY_VAD_REGION, K_BAND_FIRST, K_BAND_LAST,
    K_CHANNEL_STORED_8K, K_CHANNEL_STORED_16K, K_COS_TABLE,
    K_MAX_BIT_COUNTS_Q9, K_NOISE_EST_INC_COUNT, K_NOISE_EST_Q_DOMAIN,
    K_PROBABILITY_LOWER_LIMIT, K_PROBABILITY_MIN_SPREAD,
    K_PROBABILITY_OFFSET, K_SHIFTS_AT_ZERO, K_SHIFTS_LINEAR_SLOPE,
    K_SIN_TABLE, K_SQRT_HANNING, MAX_BUF_LEN, MAX_DELAY, MIN_MSE_COUNT,
    MIN_MSE_DIFF, MSE_RESOLUTION, MU_DIFF, MU_MAX, MU_MIN, NLP_COMP_HIGH,
    NLP_COMP_LOW, ONE_Q14, PART_LEN, PART_LEN1, PART_LEN2, PART_LEN_SHIFT,
    RESOLUTION_CHANNEL16, RESOLUTION_CHANNEL32, RESOLUTION_SUPGAIN,
    SUPGAIN_DEFAULT, SUPGAIN_EPC_DT, SUPGAIN_ERROR_PARAM_A,
    SUPGAIN_ERROR_PARAM_B, SUPGAIN_ERROR_PARAM_D)
from wbench.reference.dsp.intops import (
    U32_MASK, add_sat_w16, add_sat_w32, div_u32_u16, div_w32_w16_exact,
    mul_16_u16, norm_u32, norm_w16, norm_w32, popcount32, shift_u32,
    shift_w32, sqrt_floor, wrap16, wrap32)
from wbench.reference.dsp.nsx import real_forward_fft as _rfft
from wbench.reference.dsp.nsx import real_inverse_fft as _irfft

I32 = torch.int32
I64 = torch.int64
M = U32_MASK
I16_MAX, I16_MIN = 32767, -32768
I32_MAX = 0x7FFFFFFF


def _u(x) -> torch.Tensor:
    return x.to(I64) & M


def _divw16(num, den: int) -> torch.Tensor:
    return div_w32_w16_exact(num, torch.full_like(num, den))


@functools.lru_cache(maxsize=None)
def _consts(device: str) -> dict:
    han = torch.as_tensor(K_SQRT_HANNING, dtype=I32, device=device)
    band = torch.zeros(PART_LEN1, dtype=torch.bool, device=device)
    band[K_BAND_FIRST:K_BAND_LAST + 1] = True
    k = np.arange(PART_LEN1)
    weights = np.where((k >= K_BAND_FIRST) & (k <= K_BAND_LAST),
                       1 << np.clip(k - K_BAND_FIRST, 0, 31), 0)
    return dict(
        han=han,
        win=torch.cat([han[:PART_LEN], han.flip(0)[:PART_LEN]]),
        han_rev=han.flip(0)[:PART_LEN],
        band=band,
        weights=torch.as_tensor(weights, dtype=I64, device=device),
        inner=torch.as_tensor((k > 0) & (k < PART_LEN), device=device),
        bin=torch.arange(PART_LEN1, dtype=I32, device=device))


def real_forward_fft(x):
    """WebRtcSpl_RealForwardFFT over [..., 128]: (re, im) [..., 65]."""
    return _rfft(x, 7)


def real_inverse_fft(re65, im65):
    """WebRtcSpl_RealInverseFFT of [..., 65]: (real [..., 128], scale
    [..., 1])."""
    return _irfft(re65, im65, 7)


# --------------------------- TimeToFrequencyDomain (aecm_core_c.c:403-474)

def time_to_freq(buf128):
    """[B, 128] int32 (int16 values) -> (re, im, abs [B, 65], sum of abs
    [B] (uint32 bits as int32), Q scaling [B])."""
    c = _consts(str(buf128.device))
    tmp = buf128.abs().amax(-1)
    scaling = torch.where(tmp != 0, norm_w16(tmp), 0).to(I32)
    fft = wrap16((wrap16(buf128 << scaling[:, None]) * c["win"]) >> 14)
    re, im = real_forward_fft(fft)
    im = -im
    im[:, 0] = 0
    im[:, PART_LEN] = 0
    absval = torch.where(
        re == 0, im.abs(),
        torch.where(im == 0, re.abs(),
                    sqrt_floor(add_sat_w32(re * re, im * im))))
    absval = torch.where(c["inner"], absval, re.abs())
    return re, im, absval, wrap32(absval.to(I64).sum(-1)), scaling


# ------------------------------ binary delay estimator (delay_estimator*.c)

def binary_spectrum(spectrum, mean, init_flag, q_domain):
    """[B, 65] spectrum -> (pattern [B] (uint32 bits as int32), new mean
    [B, 65], new init flag [B])."""
    c = _consts(str(spectrum.device))
    band = c["band"]
    sq15 = spectrum << (15 - q_domain[:, None])
    # the first call with a positive band sets mean = sq15 >> 1
    do_init = (init_flag == 0)[:, None] & band & (spectrum > 0)
    mean = torch.where(do_init, sq15 >> 1, mean)
    new_init = torch.where(do_init.any(-1), 1, init_flag)
    # MeanEstimatorFix(sq15, 6, &mean)
    diff = sq15 - mean
    diff = torch.where(diff < 0, -((-diff) >> 6), diff >> 6)
    mean = torch.where(band, mean + diff, mean)
    bits = band & (sq15 > mean)
    out = wrap32(torch.where(bits, c["weights"], 0).sum(-1))
    return out, mean, new_init


def delay_add_far(st: dict, far_spectrum, far_q) -> dict:
    b, mean_far, far_init = binary_spectrum(
        far_spectrum, st["de_mean_far"], st["de_far_init"], far_q)
    st = dict(st)
    st["de_mean_far"] = mean_far
    st["de_far_init"] = far_init
    st["de_far_hist"] = torch.cat([b[:, None], st["de_far_hist"][:, :-1]],
                                  -1)
    st["de_far_bit_counts"] = torch.cat(
        [popcount32(b)[:, None], st["de_far_bit_counts"][:, :-1]], -1)
    return st


def delay_process_near(st: dict, near_spectrum, near_q):
    """(state, last_delay [B])."""
    b, mean_near, near_init = binary_spectrum(
        near_spectrum, st["de_mean_near"], st["de_near_init"], near_q)
    st = dict(st)
    st["de_mean_near"] = mean_near
    st["de_near_init"] = near_init

    bit_counts = popcount32(st["de_far_hist"] ^ b[:, None])
    fbc = st["de_far_bit_counts"]
    shifts = K_SHIFTS_AT_ZERO - ((K_SHIFTS_LINEAR_SLOPE * fbc) >> 4)
    diff = (bit_counts << 9) - st["de_mean_bit_counts"]
    diff = torch.where(diff < 0, -((-diff) >> shifts), diff >> shifts)
    mbc = torch.where(fbc > 0, st["de_mean_bit_counts"] + diff,
                      st["de_mean_bit_counts"])
    st["de_mean_bit_counts"] = mbc

    value_best = mbc.amin(-1)
    # the first index reaching the minimum (C keeps the first)
    candidate = torch.where(
        mbc == value_best[:, None],
        torch.arange(MAX_DELAY, dtype=I32, device=mbc.device),
        MAX_DELAY).amin(-1)
    valley_depth = mbc.amax(-1) - value_best

    min_prob = st["de_min_prob"]
    thr = (value_best + K_PROBABILITY_OFFSET).clamp_min(
        K_PROBABILITY_LOWER_LIMIT)
    upd = (min_prob > K_PROBABILITY_LOWER_LIMIT) & \
        (valley_depth > K_PROBABILITY_MIN_SPREAD) & (min_prob > thr)
    min_prob = torch.where(upd, thr, min_prob)
    last_prob = st["de_last_delay_prob"] + 1
    valid = (valley_depth > K_PROBABILITY_OFFSET) & \
        ((value_best < min_prob) | (value_best < last_prob))
    last_delay = torch.where(valid, candidate, st["de_last_delay"])
    st["de_min_prob"] = min_prob
    st["de_last_delay_prob"] = torch.where(
        valid & (value_best < last_prob), value_best, last_prob)
    st["de_last_delay"] = last_delay
    return st, last_delay


# ------------------ energies, step size, channel (aecm_core.c:403-787)

def _log_of_energy_q8(energy, q_domain):
    """[B] uint32-valued energy -> its Q8 log2 (int16 wrap)."""
    e = _u(energy)
    zeros = norm_u32(e)
    frac = (shift_u32(e, zeros) & 0x7FFFFFFF) >> 23
    val = (PART_LEN_SHIFT << 7) + ((31 - zeros) << 8) + wrap32(frac) - \
        (q_domain << 8)
    return wrap16(torch.where(e > 0, val, PART_LEN_SHIFT << 7))


def _asym_filt(filt_old, in_val, step_pos: int, step_neg: int):
    ret = torch.where(filt_old > in_val,
                      filt_old - ((filt_old - in_val) >> step_neg),
                      filt_old + ((in_val - filt_old) >> step_pos))
    return torch.where((filt_old == I16_MAX) | (filt_old == I16_MIN),
                       in_val, wrap16(ret))


def _push(hist, value):
    """Newest value first: [value, hist[:-1]]."""
    return torch.cat([value[:, None], hist[:, :-1]], -1)


def calc_energies(st: dict, far_spectrum, far_q, near_ener,
                  startup0: bool):
    """aecm_core.c CalcEnergies; startup0: startupState == 0.  Returns
    (state, echo_est [B, 65])."""
    st = dict(st)
    st["near_log_energy"] = _push(
        st["near_log_energy"], _log_of_energy_q8(near_ener,
                                                 st["dfa_noisy_q"]))
    echo_est = mul_16_u16(st["channel_stored"], far_spectrum)
    tmp_far = _u(far_spectrum).sum(-1)
    tmp_adapt = ((_u(st["channel_adapt16"]) * _u(far_spectrum)) & M).sum(-1)
    tmp_stored = _u(echo_est).sum(-1)

    far_log = _log_of_energy_q8(tmp_far, far_q)
    st["far_log_energy"] = far_log
    st["echo_adapt_log"] = _push(
        st["echo_adapt_log"],
        _log_of_energy_q8(tmp_adapt, RESOLUTION_CHANNEL16 + far_q))
    st["echo_stored_log"] = _push(
        st["echo_stored_log"],
        _log_of_energy_q8(tmp_stored, RESOLUTION_CHANNEL16 + far_q))

    inc_max, inc_min, dec_min = (2, 8, 2) if startup0 else (4, 11, 3)
    active = far_log > FAR_ENERGY_MIN

    fmin = torch.where(active, _asym_filt(st["far_energy_min"], far_log,
                                          inc_min, dec_min),
                       st["far_energy_min"])
    fmax = torch.where(active, _asym_filt(st["far_energy_max"], far_log,
                                          inc_max, 11),
                       st["far_energy_max"])
    fmaxmin = torch.where(active, wrap16(fmax - fmin),
                          st["far_energy_max_min"])

    t16 = 2560 - fmin
    t16 = torch.where(t16 > 0, wrap16((t16 * FAR_ENERGY_VAD_REGION) >> 9), 0)
    t16 = t16 + FAR_ENERGY_VAD_REGION
    fev, vuc = st["far_energy_vad"], st["vad_update_count"]
    direct = (vuc > 1024) | startup0
    over = fev > far_log
    fvad = torch.where(direct, fmin + t16,
                       torch.where(over, fev + ((far_log + t16 - fev) >> 6),
                                   fev))
    vuc_new = torch.where(direct, vuc, torch.where(over, 0, vuc + 1))
    fvad = torch.where(active, fvad, fev)
    st["vad_update_count"] = torch.where(active, vuc_new, vuc)
    st["far_energy_mse"] = torch.where(active, fvad + (1 << 8),
                                       st["far_energy_mse"])
    st["far_energy_min"] = fmin
    st["far_energy_max"] = fmax
    st["far_energy_max_min"] = fmaxmin
    st["far_energy_vad"] = fvad

    loud = far_log > fvad
    vad_on = loud & ((fmaxmin > FAR_ENERGY_DIFF) | startup0)
    cvv = torch.where(loud, torch.where(vad_on, 1, st["current_vad"]), 0)
    st["current_vad"] = cvv

    # the first VAD's channel kick-down
    fire = (cvv != 0) & (st["first_vad"] != 0)
    eal0 = st["echo_adapt_log"][:, 0]
    worse = eal0 > st["near_log_energy"][:, 0]
    do_kick = fire & worse
    st["channel_adapt16"] = torch.where(
        do_kick[:, None], st["channel_adapt16"] >> 3, st["channel_adapt16"])
    st["echo_adapt_log"] = torch.cat(
        [torch.where(do_kick, eal0 - (3 << 8), eal0)[:, None],
         st["echo_adapt_log"][:, 1:]], -1)
    st["first_vad"] = torch.where(fire & ~worse, 0, st["first_vad"])
    return st, echo_est


def calc_step_size(st: dict, startup_pos: bool):
    """mu [B] (a shift count)."""
    t32 = wrap16(st["far_log_energy"] - st["far_energy_min"]) * MU_DIFF
    q = div_w32_w16_exact(t32, st["far_energy_max_min"])
    mu_mid = (MU_MIN - 1 - wrap16(q)).clamp_min(MU_MAX)
    mu = torch.where(st["far_energy_min"] >= st["far_energy_max"], MU_MIN,
                     mu_mid)
    if not startup_pos:
        mu = torch.full_like(mu, MU_MAX)
    return torch.where(st["current_vad"] == 0, 0, mu).to(I32)


def update_channel(st: dict, far_spectrum, far_q, dfa, mu, echo_est,
                   startup0: bool):
    """aecm_core.c UpdateChannel over [B, 65] bins, and the arbitration
    between the stored and the adaptive channel."""
    st = dict(st)
    c = _consts(str(dfa.device))
    ch32 = st["channel_adapt32"]
    far_i = far_spectrum
    far_qe = far_q[:, None]
    dfa_q = st["dfa_noisy_q"][:, None]

    zeros_ch = norm_u32(ch32)
    zeros_far = norm_u32(far_i)
    scf = torch.where(zeros_ch + zeros_far > 31, 0,
                      32 - zeros_ch - zeros_far)
    tmp_u32_1 = (shift_u32(ch32, -scf) * _u(far_i)) & M
    zeros_num = norm_u32(tmp_u32_1)
    zeros_dfa = torch.where(dfa != 0, norm_u32(dfa), 32)
    t16no1 = zeros_dfa - 2 + dfa_q - RESOLUTION_CHANNEL32 - far_qe + scf
    big = zeros_num > t16no1 + 1
    xfa_q = torch.where(big, t16no1, zeros_num - 2)
    dfa_q2 = torch.where(big, zeros_dfa - 2,
                         RESOLUTION_CHANNEL32 + far_qe - dfa_q - scf + xfa_q)
    t32no1 = wrap32(shift_u32(dfa, dfa_q2) - shift_u32(tmp_u32_1, xfa_q))
    zeros_num2 = norm_w32(t32no1)

    gate = (t32no1 != 0) & (far_i > (torch.full_like(far_qe, CHANNEL_VAD)
                                     << far_qe))
    shift_num = torch.where(zeros_num2 + zeros_far > 31, 0,
                            32 - zeros_num2 - zeros_far)
    mag = wrap32(shift_u32(t32no1.to(I64).abs(), -shift_num) * _u(far_i))
    t32no2 = torch.where(t32no1 > 0, mag, -mag)
    t32no2 = div_w32_w16_exact(t32no2, (c["bin"] + 1).expand_as(t32no2))
    shift2 = shift_num + scf - xfa_q - mu[:, None] - \
        ((30 - zeros_far) << 1)
    t32no2 = torch.where(norm_w32(t32no2) < shift2, I32_MAX,
                         shift_w32(t32no2, shift2))
    new_ch32 = add_sat_w32(ch32, t32no2).clamp_min(0)
    apply = gate & (mu[:, None] != 0)
    ch32 = torch.where(apply, new_ch32, ch32)
    adapt16 = torch.where(apply, ch32 >> 16, st["channel_adapt16"])

    # stored/adaptive arbitration (StoreAdaptiveChannel and the channel
    # MSE comparison)
    store_now = (st["current_vad"] != 0) & startup0
    mcc = torch.where(st["far_log_energy"] < st["far_energy_mse"], 0,
                      st["mse_channel_count"] + 1)
    evaluate = ~store_now & (mcc >= MIN_MSE_COUNT + 10)
    nle = st["near_log_energy"][:, :MIN_MSE_COUNT]
    d_stored = (st["echo_stored_log"][:, :MIN_MSE_COUNT] - nle).abs().sum(
        -1).to(I32)
    d_adapt = (st["echo_adapt_log"][:, :MIN_MSE_COUNT] - nle).abs().sum(
        -1).to(I32)
    mso, mao, thr = st["mse_stored_old"], st["mse_adapt_old"], \
        st["mse_threshold"]
    revert = evaluate & \
        ((d_stored << MSE_RESOLUTION) < MIN_MSE_DIFF * d_adapt) & \
        ((mso << MSE_RESOLUTION) < MIN_MSE_DIFF * mao)
    adopt = evaluate & ~revert & \
        (MIN_MSE_DIFF * d_stored > (d_adapt << MSE_RESOLUTION)) & \
        (d_adapt < thr) & (mao < thr)

    # revert: adaptive <- stored
    adapt16 = torch.where(revert[:, None], st["channel_stored"], adapt16)
    st["channel_adapt32"] = torch.where(revert[:, None],
                                        st["channel_stored"] << 16, ch32)
    st["channel_adapt16"] = adapt16
    # adopt, or the start-up store: stored <- adaptive
    do_store = (store_now | adopt)[:, None]
    st["channel_stored"] = torch.where(do_store, adapt16,
                                       st["channel_stored"])
    echo_est = torch.where(do_store,
                           mul_16_u16(st["channel_stored"], far_spectrum),
                           echo_est)
    thr_new = torch.where(
        thr == I32_MAX, d_adapt + mao,
        thr + (((d_adapt - _divw16(thr * 5, 8)) * 205) >> 8))
    st["mse_threshold"] = torch.where(adopt, thr_new, thr)
    st["mse_stored_old"] = torch.where(evaluate, d_stored, mso)
    st["mse_adapt_old"] = torch.where(evaluate, d_adapt, mao)
    st["mse_channel_count"] = torch.where(
        store_now, st["mse_channel_count"], torch.where(evaluate, 0, mcc))
    return st, echo_est


def calc_suppression_gain(st: dict):
    st = dict(st)
    dE = wrap16(st["near_log_energy"][:, 0] - st["echo_stored_log"][:, 0] -
                ENERGY_DEV_OFFSET).abs()
    ga = SUPGAIN_ERROR_PARAM_A - wrap16(_divw16(
        (SUPGAIN_ERROR_PARAM_A - SUPGAIN_ERROR_PARAM_B) * dE +
        (SUPGAIN_EPC_DT >> 1), SUPGAIN_EPC_DT))
    gb = SUPGAIN_ERROR_PARAM_D + wrap16(_divw16(
        (SUPGAIN_ERROR_PARAM_B - SUPGAIN_ERROR_PARAM_D) *
        (ENERGY_DEV_TOL - dE) + ((ENERGY_DEV_TOL - SUPGAIN_EPC_DT) >> 1),
        ENERGY_DEV_TOL - SUPGAIN_EPC_DT))
    g = torch.where(dE < ENERGY_DEV_TOL,
                    torch.where(dE < SUPGAIN_EPC_DT, ga, gb),
                    SUPGAIN_ERROR_PARAM_D)
    sup = torch.where(st["current_vad"] == 0, 0, g).to(I32)
    t16 = torch.maximum(sup, st["sup_gain_old"])
    st["sup_gain_old"] = sup
    st["sup_gain"] = st["sup_gain"] + wrap16((t16 - st["sup_gain"]) >> 4)
    return st, st["sup_gain"]


# ----------------------------- the block (ProcessBlock, aecm_core.c:403-787)

def make_init_state(batch: int, samp_freq: int, device=None) -> dict:
    """The state of AecmCore.init (`wmix_tpu/dsp/aecm.py`), [B, ...] int32
    leaves."""
    device = resolve_device(device)
    stored = K_CHANNEL_STORED_8K if samp_freq == 8000 else \
        K_CHANNEL_STORED_16K
    noise_est = np.zeros(PART_LEN1, np.int64)
    t32 = PART_LEN1 * PART_LEN1
    t16 = PART_LEN1
    for i in range((PART_LEN1 >> 1) - 1):
        noise_est[i] = t32 << 8
        t16 -= 1
        t32 -= (t16 << 1) + 1
    for i in range((PART_LEN1 >> 1) - 1, PART_LEN1):
        noise_est[i] = t32 << 8

    def zi(*s):
        return torch.zeros((batch,) + s, dtype=I32, device=device)

    def fill(v, *s):
        return torch.full((batch,) + s, v, dtype=I32, device=device)

    def rows(a):
        return torch.as_tensor(np.asarray(a), dtype=I32,
                               device=device).repeat(batch, 1)

    return dict(
        x_buf=zi(PART_LEN2), d_buf=zi(PART_LEN2), out_buf=zi(PART_LEN),
        far_history=zi(MAX_DELAY, PART_LEN1), far_q_domains=zi(MAX_DELAY),
        de_mean_far=zi(PART_LEN1), de_mean_near=zi(PART_LEN1),
        de_far_init=zi(), de_near_init=zi(),
        de_far_hist=zi(MAX_DELAY), de_far_bit_counts=zi(MAX_DELAY),
        de_mean_bit_counts=fill(20 << 9, MAX_DELAY),
        de_min_prob=fill(K_MAX_BIT_COUNTS_Q9),
        de_last_delay_prob=fill(K_MAX_BIT_COUNTS_Q9),
        de_last_delay=fill(-2),
        channel_stored=rows(stored), channel_adapt16=rows(stored),
        channel_adapt32=rows(np.asarray(stored) << 16),
        near_log_energy=zi(MAX_BUF_LEN), echo_adapt_log=zi(MAX_BUF_LEN),
        echo_stored_log=zi(MAX_BUF_LEN), far_log_energy=zi(),
        echo_filt=zi(PART_LEN1), near_filt=zi(PART_LEN1),
        noise_est=rows(noise_est),
        ne_too_low=zi(PART_LEN1), ne_too_high=zi(PART_LEN1),
        far_energy_min=fill(I16_MAX), far_energy_max=fill(I16_MIN),
        far_energy_max_min=zi(), far_energy_vad=fill(FAR_ENERGY_MIN),
        far_energy_mse=zi(),
        current_vad=zi(), vad_update_count=zi(), first_vad=fill(1),
        sup_gain=fill(SUPGAIN_DEFAULT), sup_gain_old=fill(SUPGAIN_DEFAULT),
        mse_adapt_old=fill(1000), mse_stored_old=fill(1000),
        mse_threshold=fill(I32_MAX), mse_channel_count=zi(),
        dfa_noisy_q=zi(), dfa_noisy_q_old=zi())


def comfort_tables(rand16: np.ndarray) -> np.ndarray:
    """The comfort noise's [2, 64] (cos, sin) table values for one block's
    RandU draws, computed on the host as the reference's gathers."""
    t16 = (359 * np.asarray(rand16, np.int64)) >> 15
    return np.stack([K_COS_TABLE[t16], K_SIN_TABLE[t16]]).astype(np.int32)


def process_block(st: dict, far64, near64, cos_sin, hist_pos: int,
                  tot_count: int, noise_ctr_lt100: bool, mult: int):
    """One 64-sample AECM block for B streams.

    far64 / near64: [B, 64] int32 (int16 values); cos_sin: [2, 64] int32 on
    the state's device, `comfort_tables` of the block's shared RandU draws;
    hist_pos (far-history slot), tot_count (start-up state machine) and
    noise_ctr_lt100 (comfort-noise tracking speed) from the planner.
    Returns (state, out [B, 64] int32)."""
    st = dict(st)
    c = _consts(str(far64.device))
    startup_state = int(tot_count >= 512) + int(tot_count >= 1024)
    startup0 = startup_state == 0
    B = far64.shape[0]
    rows = torch.arange(B, device=far64.device)

    x_buf = torch.cat([st["x_buf"][:, PART_LEN:], far64.to(I32)], 1)
    d_buf = torch.cat([st["d_buf"][:, PART_LEN:], near64.to(I32)], 1)
    _xre, _xim, xfa, _xfa_sum, far_q_new = time_to_freq(x_buf)
    dre, dim, dfa, dfa_sum, zeros_d = time_to_freq(d_buf)
    st["dfa_noisy_q_old"] = st["dfa_noisy_q"]
    st["dfa_noisy_q"] = zeros_d

    # far history (in place) and the delay estimate
    st["far_history"][:, hist_pos] = xfa
    st["far_q_domains"][:, hist_pos] = far_q_new
    st = delay_add_far(st, xfa, far_q_new)
    st, delay = delay_process_near(st, dfa, zeros_d)
    delay = torch.where(delay == -2, 0, delay)
    pos = hist_pos - delay
    pos = torch.where(pos < 0, pos + MAX_DELAY, pos).long()
    far_spectrum = st["far_history"][rows, pos]
    far_q = st["far_q_domains"][rows, pos]

    st, echo_est = calc_energies(st, far_spectrum, far_q, dfa_sum, startup0)
    mu = calc_step_size(st, startup_state > 0)
    st, echo_est = update_channel(st, far_spectrum, far_q, dfa, mu,
                                  echo_est, startup0)
    st, sup_gain = calc_suppression_gain(st)

    # ---- the Wiener gain hnl (aecm_core_c.c:291-356)
    dfa_clean_q = st["dfa_noisy_q"][:, None]
    far_qe = far_q[:, None]
    sup_e = sup_gain[:, None]

    # aecm_core_c.c:456 computes (t * 50) in int32, which wraps on loud
    # echo estimates; so does the int32 product here, and >> 8 is the C's
    # arithmetic shift of the wrapped product
    t32no1 = wrap32(echo_est.to(I64) - st["echo_filt"])
    echo_filt = st["echo_filt"] + ((t32no1 * 50) >> 8)
    st["echo_filt"] = echo_filt
    zeros32 = norm_w32(echo_filt) + 1
    zeros16 = norm_w16(sup_e) + 1
    fits = zeros32 + zeros16 > 16
    t16no1 = 17 - zeros32 - zeros16
    rd_base = 14 - RESOLUTION_CHANNEL16 - RESOLUTION_SUPGAIN + \
        dfa_clean_q - far_qe
    resolution_diff = torch.where(fits, rd_base, rd_base + t16no1)
    ef = _u(echo_filt)
    gained_b = torch.where(
        zeros32 > t16no1, (ef * shift_u32(sup_e, -t16no1)) & M,
        (_u(shift_w32(echo_filt, -t16no1)) * _u(sup_e)) & M)
    echo_est_gained = torch.where(fits, (ef * (sup_e & 0xFFFF)) & M,
                                  gained_b)

    # near_filt tracking
    nf = st["near_filt"]
    zeros16n = norm_w16(nf)
    dfa_diff = dfa_clean_q - st["dfa_noisy_q_old"][:, None]
    cond = (zeros16n < dfa_diff) & (nf != 0)
    t16a = torch.where(
        cond, wrap16(shift_w32(nf, zeros16n)),
        torch.where(dfa_diff < 0, nf >> (-dfa_diff).clamp_min(0),
                    wrap16(nf << dfa_diff.clamp_min(0))))
    q_diff = torch.where(cond, zeros16n - dfa_diff, 0)
    t16b = torch.where(cond, dfa >> (-q_diff).clamp_min(0), dfa)
    # the C smoothing add is an int16 += and wraps (aecm_core_c.c:503)
    t16no2 = wrap16(wrap16((t16b - t16a) >> 4) + t16a)
    # upstream quirk (aecm_core_c.c:505): `(tmp16no2) & (bool)` is a
    # bitwise and, so the saturation fires only when t16no2 is odd
    overflow = ((t16no2 & 1) != 0) & (-q_diff > norm_w16(t16no2))
    nf_new = torch.where(
        overflow, I16_MAX,
        torch.where(q_diff < 0, wrap16(t16no2 << (-q_diff).clamp_min(0)),
                    t16no2 >> q_diff.clamp_min(0))).to(I32)
    st["near_filt"] = nf_new

    # hnl
    ratio = div_u32_u16((echo_est_gained + _u(nf_new >> 1)) & M, nf_new)
    t32r = shift_w32(wrap32(ratio), resolution_diff)
    hnl_mid = torch.where(t32r > ONE_Q14, 0,
                          torch.where(t32r < 0, ONE_Q14,
                                      (ONE_Q14 - t32r).clamp(0, ONE_Q14)))
    hnl = torch.where(echo_est_gained == 0, ONE_Q14,
                      torch.where(nf_new == 0, 0, hnl_mid)).to(I32)
    num_pos_coef = (hnl != 0).sum(-1)

    if mult == 2:
        hnl = (hnl * hnl) >> 14
        avg = _divw16(wrap32(hnl[:, 4:25].sum(-1)), 21)[:, None]
        hnl = torch.where(c["bin"] >= 24, torch.minimum(hnl, avg), hnl)

    # NLP (nlp_flag is 1 in the daemon's wrapper)
    hnl = torch.where(hnl > NLP_COMP_HIGH, ONE_Q14,
                      torch.where(hnl < NLP_COMP_LOW, 0, hnl))
    nlp_gain = torch.where(num_pos_coef < 3, 0, ONE_Q14)[:, None]
    pass_through = (hnl == ONE_Q14) & (nlp_gain == ONE_Q14)
    hnl = torch.where(pass_through, hnl, (hnl * nlp_gain) >> 14).to(I32)
    efw_re = wrap16((dre * hnl + (1 << 13)) >> 14)
    efw_im = wrap16((dim * hnl + (1 << 13)) >> 14)

    # ---- ComfortNoise (aecm_core_c.c:583-719)
    sfn = (K_NOISE_EST_Q_DOMAIN - st["dfa_noisy_q"])[:, None]
    min_track_shift = 6 if noise_ctr_lt100 else 9
    out_l = shift_w32(dfa, sfn)
    ne = st["noise_est"]
    below = out_l < ne
    small = ne < (1 << min_track_shift)
    too_high_inc = st["ne_too_high"] + 1
    fire_high = below & small & (too_high_inc >= K_NOISE_EST_INC_COUNT)
    ne_b = torch.where(small, torch.where(fire_high, ne - 1, ne),
                       ne - shift_w32(ne - out_l, -min_track_shift))
    # below: too_low := 0, too_high counts only in the `small` branch;
    # above: too_high := 0, too_low counts only in the smallest branch
    st["ne_too_high"] = torch.where(
        below, torch.where(small, torch.where(fire_high, 0, too_high_inc),
                           st["ne_too_high"]), 0)
    big19 = (ne >> 19) > 0
    big11 = (ne >> 11) > 0
    too_low_inc = st["ne_too_low"] + 1
    fire_low = ~big19 & ~big11 & (too_low_inc >= K_NOISE_EST_INC_COUNT)
    ne_a = torch.where(
        big19, wrap32(_u(ne >> 11) * 2049),
        torch.where(big11, wrap32(_u(ne) * 2049) >> 11,
                    torch.where(fire_low, ne + ((ne >> 9) + 1), ne)))
    st["ne_too_low"] = torch.where(
        below, 0, torch.where(big19 | big11, st["ne_too_low"],
                              torch.where(fire_low, 0, too_low_inc)))
    ne_new = torch.where(below, ne_b, ne_a)
    t32 = shift_w32(ne_new, -sfn)
    clip = t32 > 32767
    t32 = torch.where(clip, 32767, t32)
    st["noise_est"] = torch.where(clip, shift_w32(t32, sfn), ne_new)
    noise_r = wrap16(((ONE_Q14 - hnl) * t32) >> 14)

    zero = torch.zeros_like(noise_r[:, :1])
    u_re = torch.cat([zero, wrap16((noise_r[:, 1:] * cos_sin[0]) >> 13)], 1)
    u_im = torch.cat([zero, wrap16((-noise_r[:, 1:] * cos_sin[1]) >> 13)], 1)
    u_im[:, PART_LEN] = 0
    efw_re = add_sat_w16(efw_re, u_re)
    efw_im = add_sat_w16(efw_im, u_im)

    # ---- InverseFFTAndWindow (aecm_core_c.c:476-531)
    ifft_out, out_cfft = real_inverse_fft(efw_re, -efw_im)
    shift_out = out_cfft - dfa_clean_q
    v = wrap16((ifft_out[:, :PART_LEN] * c["han"][:PART_LEN] +
                (1 << 13)) >> 14)
    output = (shift_w32(v, shift_out) + st["out_buf"]).clamp(I16_MIN,
                                                             I16_MAX)
    t32b = (ifft_out[:, PART_LEN:] * c["han_rev"]) >> 14
    st["out_buf"] = shift_w32(t32b, shift_out).clamp(I16_MIN, I16_MAX)
    st["x_buf"] = x_buf
    st["d_buf"] = d_buf
    return st, output.to(I32)


# --------------------------------------------------------------------------
# daemon wrapper (src/webrtc.c aec_* with MAKE_WEBRTC_AEC undefined)
# --------------------------------------------------------------------------
