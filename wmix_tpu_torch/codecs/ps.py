"""PS — Parametric Stereo decode (HE-AAC v2), float bit-exact.

Port of faad2-2.8.8's ps_syntax.c + ps_dec.c (float build, no
PS_LOW_POWER, PARAM_32KHZ off — the 48 kHz constants compile in):
IID/ICC/IPD/OPD huffman + delta decode, the 20/34-band hybrid
filterbank, the transient-ducked allpass decorrelator, and the type
A/B mixing with optional phase rotation.  All arithmetic is IEEE
float32 in the reference's association order.

Tables come from the compiled reference via oracle/gen_sbr_tables.py.
"""
from __future__ import annotations

import numpy as np

from wmix_tpu_torch.codecs import _sbr_tables as T

F32 = np.float32

NEGATE_IPD_MASK = 0x1000
NO_ALLPASS_LINKS = 3
DECAY_SLOPE = F32(0.05)

_NR_IID_PAR = [10, 20, 34, 10, 20, 34, 0, 0]
_NR_IPDOPD_PAR = [5, 11, 17, 5, 11, 17, 0, 0]
_NR_ICC_PAR = [10, 20, 34, 10, 20, 34, 0, 0]
_NUM_ENV = [[0, 1, 2, 4], [1, 2, 3, 4]]


class _Hybrid:
    """hybrid_init (ps_dec.c:195-230)."""

    def __init__(self, numTimeSlotsRate):
        self.resolution34 = [12, 8, 4, 4, 4]
        self.resolution20 = [8, 2, 2]
        self.frame_len = numTimeSlotsRate
        self.work = np.zeros((numTimeSlotsRate + 12, 2), F32)
        self.buffer = np.zeros((5, 12, 2), F32)
        self.temp = np.zeros((numTimeSlotsRate, 12, 2), F32)


class PsInfo:
    """ps_info state + ps_init (ps_dec.c:1869-1962)."""

    def __init__(self, sr_index, numTimeSlotsRate):
        self.hyb = _Hybrid(numTimeSlotsRate)
        self.numTimeSlotsRate = numTimeSlotsRate
        self.ps_data_available = 0
        self.header_read = 0
        self.use34hybrid_bands = 0
        self.enable_iid = 0
        self.enable_icc = 0
        self.enable_ext = 0
        self.enable_ipdopd = 0
        self.iid_mode = 0
        self.icc_mode = 0
        self.ipd_mode = 0
        self.nr_iid_par = 0
        self.nr_icc_par = 0
        self.nr_ipdopd_par = 0
        self.frame_class = 0
        self.num_env = 0
        self.border_position = [0] * 6
        self.iid_dt = [0] * 5
        self.icc_dt = [0] * 5
        self.ipd_dt = [0] * 5
        self.opd_dt = [0] * 5
        self.iid_index = np.zeros((6, 34), np.int64)
        self.icc_index = np.zeros((6, 34), np.int64)
        self.ipd_index = np.zeros((6, 17), np.int64)
        self.opd_index = np.zeros((6, 17), np.int64)
        self.iid_index_prev = np.zeros(34, np.int64)
        self.icc_index_prev = np.zeros(34, np.int64)
        self.ipd_index_prev = np.zeros(17, np.int64)
        self.opd_index_prev = np.zeros(17, np.int64)

        self.saved_delay = 0
        self.delay_buf_index_delay = np.zeros(64, np.int64)
        self.delay_buf_index_ser = np.zeros(NO_ALLPASS_LINKS, np.int64)
        self.num_sample_delay_ser = np.array([3, 4, 5], np.int64)
        # PARAM_32KHZ off: 48 kHz constants (ps_dec.c:1925-1940)
        short_delay_band = 35
        self.nr_allpass_bands = 22
        self.alpha_decay = F32(0.76592833836465)
        self.alpha_smooth = F32(0.25)
        self.delay_D = np.zeros(64, np.int64)
        self.delay_D[:short_delay_band] = 14
        self.delay_D[short_delay_band:] = 1

        self.delay_Qmf = np.zeros((14, 64, 2), F32)
        self.delay_SubQmf = np.zeros((2, 32, 2), F32)
        self.delay_Qmf_ser = np.zeros((NO_ALLPASS_LINKS, 5, 64, 2), F32)
        self.delay_SubQmf_ser = np.zeros((NO_ALLPASS_LINKS, 5, 32, 2),
                                         F32)

        self.P_PeakDecayNrg = np.zeros(34, F32)
        self.P_prev = np.zeros(34, F32)
        self.P_SmoothPeakDecayDiffNrg_prev = np.zeros(34, F32)

        self.h11_prev = np.zeros((50, 2), F32)
        self.h12_prev = np.zeros((50, 2), F32)
        self.h21_prev = np.zeros((50, 2), F32)
        self.h22_prev = np.zeros((50, 2), F32)
        # ps_init: RE(h11_prev)=1, IM(h12_prev)=1 (written twice in C)
        self.h11_prev[:, 0] = 1
        self.h12_prev[:, 1] = 1
        self.phase_hist = 0
        self.ipd_prev = np.zeros((20, 2, 2), F32)
        self.opd_prev = np.zeros((20, 2, 2), F32)


# --------------------------------------------------------------------------
# bitstream (ps_syntax.c)
# --------------------------------------------------------------------------

def _ps_huff_dec(ld, table):
    index = 0
    while index >= 0:
        bit = ld.get1()
        index = int(table[index][bit])
    return index + 31


def _huff_data(ld, dt, nr_par, t_huff, f_huff, par):
    if dt:
        for n in range(nr_par):
            par[n] = _ps_huff_dec(ld, t_huff)
    else:
        for n in range(nr_par):
            par[n] = _ps_huff_dec(ld, f_huff)


def _ps_extension(ps, ld, ps_extension_id, num_bits_left):
    bits = ld.processed()
    if ps_extension_id == 0:
        ps.enable_ipdopd = ld.get1()
        if ps.enable_ipdopd:
            for n in range(ps.num_env):
                ps.ipd_dt[n] = ld.get1()
                _huff_data(ld, ps.ipd_dt[n], ps.nr_ipdopd_par,
                           T.T_HUFF_IPD, T.F_HUFF_IPD, ps.ipd_index[n])
                ps.opd_dt[n] = ld.get1()
                _huff_data(ld, ps.opd_dt[n], ps.nr_ipdopd_par,
                           T.T_HUFF_OPD, T.F_HUFF_OPD, ps.opd_index[n])
        ld.get1()
    return ld.processed() - bits


def ps_data(ps, ld):
    """ps_data (ps_syntax.c); returns (bits_read, header_flag)."""
    bits = ld.processed()
    header = 0
    if ld.get1():
        header = 1
        ps.header_read = 1
        ps.use34hybrid_bands = 0
        ps.enable_iid = ld.get1()
        if ps.enable_iid:
            ps.iid_mode = ld.get(3)
            ps.nr_iid_par = _NR_IID_PAR[ps.iid_mode]
            ps.nr_ipdopd_par = _NR_IPDOPD_PAR[ps.iid_mode]
            if ps.iid_mode in (2, 5):
                ps.use34hybrid_bands = 1
            ps.ipd_mode = ps.iid_mode
        ps.enable_icc = ld.get1()
        if ps.enable_icc:
            ps.icc_mode = ld.get(3)
            ps.nr_icc_par = _NR_ICC_PAR[ps.icc_mode]
            if ps.icc_mode in (2, 5):
                ps.use34hybrid_bands = 1
        ps.enable_ext = ld.get1()
    if ps.header_read == 0:
        ps.ps_data_available = 0
        return 1, header
    ps.frame_class = ld.get1()
    tmp = ld.get(2)
    ps.num_env = _NUM_ENV[ps.frame_class][tmp]
    if ps.frame_class:
        for n in range(1, ps.num_env + 1):
            ps.border_position[n] = ld.get(5) + 1
    if ps.enable_iid:
        for n in range(ps.num_env):
            ps.iid_dt[n] = ld.get1()
            if ps.iid_mode < 3:
                _huff_data(ld, ps.iid_dt[n], ps.nr_iid_par,
                           T.T_HUFF_IID_DEF, T.F_HUFF_IID_DEF,
                           ps.iid_index[n])
            else:
                _huff_data(ld, ps.iid_dt[n], ps.nr_iid_par,
                           T.T_HUFF_IID_FINE, T.F_HUFF_IID_FINE,
                           ps.iid_index[n])
    if ps.enable_icc:
        for n in range(ps.num_env):
            ps.icc_dt[n] = ld.get1()
            _huff_data(ld, ps.icc_dt[n], ps.nr_icc_par, T.T_HUFF_ICC,
                       T.F_HUFF_ICC, ps.icc_index[n])
    if ps.enable_ext:
        cnt = ld.get(4)
        if cnt == 15:
            cnt += ld.get(8)
        num_bits_left = 8 * cnt
        while num_bits_left > 7:
            ps_extension_id = ld.get(2)
            num_bits_left -= 2
            num_bits_left -= _ps_extension(ps, ld, ps_extension_id,
                                           num_bits_left)
        ld.get(num_bits_left)
    ps.ps_data_available = 1
    return ld.processed() - bits, header


# --------------------------------------------------------------------------
# hybrid filterbank (ps_dec.c:261-605)
# --------------------------------------------------------------------------

def _channel_filter2(frame_len, filt, buf, temp):
    i = np.arange(frame_len)
    r = [buf[i + k, 0] for k in range(13)]
    im = [buf[i + k, 1] for k in range(13)]
    r0 = filt[0] * (r[0] + r[12])
    r1 = filt[1] * (r[1] + r[11])
    r2 = filt[2] * (r[2] + r[10])
    r3 = filt[3] * (r[3] + r[9])
    r4 = filt[4] * (r[4] + r[8])
    r5 = filt[5] * (r[5] + r[7])
    r6 = filt[6] * r[6]
    i0 = filt[0] * (im[0] + im[12])
    i1 = filt[1] * (im[1] + im[11])
    i2 = filt[2] * (im[2] + im[10])
    i3 = filt[3] * (im[3] + im[9])
    i4 = filt[4] * (im[4] + im[8])
    i5 = filt[5] * (im[5] + im[7])
    i6 = filt[6] * im[6]
    temp[i, 0, 0] = r0 + r1 + r2 + r3 + r4 + r5 + r6
    temp[i, 0, 1] = i0 + i1 + i2 + i3 + i4 + i5 + i6
    temp[i, 1, 0] = r0 - r1 + r2 - r3 + r4 - r5 + r6
    temp[i, 1, 1] = i0 - i1 + i2 - i3 + i4 - i5 + i6


_SQ05 = F32(0.70710678118655)


def _channel_filter4(frame_len, filt, buf, temp):
    i = np.arange(frame_len)
    r = [buf[i + k, 0] for k in range(13)]
    im = [buf[i + k, 1] for k in range(13)]
    in_re1_0 = -(filt[2] * (r[2] + r[10])) + filt[6] * r[6]
    in_re1_1 = F32(-0.70710678118655) * (
        filt[1] * (r[1] + r[11]) + filt[3] * (r[3] + r[9]) -
        filt[5] * (r[5] + r[7]))
    in_im1_0 = filt[0] * (im[0] - im[12]) - filt[4] * (im[4] - im[8])
    in_im1_1 = _SQ05 * (filt[1] * (im[1] - im[11]) -
                        filt[3] * (im[3] - im[9]) -
                        filt[5] * (im[5] - im[7]))
    in_re2_0 = filt[0] * (r[0] - r[12]) - filt[4] * (r[4] - r[8])
    in_re2_1 = _SQ05 * (filt[1] * (r[1] - r[11]) -
                        filt[3] * (r[3] - r[9]) -
                        filt[5] * (r[5] - r[7]))
    in_im2_0 = -(filt[2] * (im[2] + im[10])) + filt[6] * im[6]
    in_im2_1 = F32(-0.70710678118655) * (
        filt[1] * (im[1] + im[11]) + filt[3] * (im[3] + im[9]) -
        filt[5] * (im[5] + im[7]))
    temp[i, 0, 0] = in_re1_0 + in_re1_1 + in_im1_0 + in_im1_1
    temp[i, 0, 1] = -in_re2_0 - in_re2_1 + in_im2_0 + in_im2_1
    temp[i, 1, 0] = in_re1_0 - in_re1_1 - in_im1_0 + in_im1_1
    temp[i, 1, 1] = in_re2_0 - in_re2_1 + in_im2_0 - in_im2_1
    temp[i, 2, 0] = in_re1_0 - in_re1_1 + in_im1_0 - in_im1_1
    temp[i, 2, 1] = -in_re2_0 + in_re2_1 + in_im2_0 - in_im2_1
    temp[i, 3, 0] = in_re1_0 + in_re1_1 - in_im1_0 - in_im1_1
    temp[i, 3, 1] = in_re2_0 + in_re2_1 + in_im2_0 + in_im2_1


def _dct3_4(x0, x1, x2, x3):
    f0 = x2 * F32(0.7071067811865476)
    f1 = x0 - f0
    f2 = x0 + f0
    f3 = x1 + x3
    f4 = x1 * F32(1.3065629648763766)
    f5 = f3 * F32(-0.9238795325112866)
    f6 = x3 * F32(-0.5411961001461967)
    f7 = f4 + f5
    f8 = f6 - f5
    return (f2 + f8, f1 + f7, f1 - f7, f2 - f8)  # y0, y1, y2, y3


def _channel_filter8(frame_len, filt, buf, temp):
    i = np.arange(frame_len)
    r = [buf[i + k, 0] for k in range(13)]
    im = [buf[i + k, 1] for k in range(13)]
    in_re1 = [filt[6] * r[6],
              filt[5] * (r[5] + r[7]),
              -(filt[0] * (r[0] + r[12])) + filt[4] * (r[4] + r[8]),
              -(filt[1] * (r[1] + r[11])) + filt[3] * (r[3] + r[9])]
    in_im1 = [filt[5] * (im[7] - im[5]),
              filt[0] * (im[12] - im[0]) + filt[4] * (im[8] - im[4]),
              filt[1] * (im[11] - im[1]) + filt[3] * (im[9] - im[3]),
              filt[2] * (im[10] - im[2])]
    x = [in_re1[n] - in_im1[3 - n] for n in range(4)]
    y = _dct3_4(*x)
    temp[i, 7, 0] = y[0]
    temp[i, 5, 0] = y[2]
    temp[i, 3, 0] = y[3]
    temp[i, 1, 0] = y[1]
    x = [in_re1[n] + in_im1[3 - n] for n in range(4)]
    y = _dct3_4(*x)
    temp[i, 6, 0] = y[1]
    temp[i, 4, 0] = y[3]
    temp[i, 2, 0] = y[2]
    temp[i, 0, 0] = y[0]
    in_im2 = [filt[6] * im[6],
              filt[5] * (im[5] + im[7]),
              -(filt[0] * (im[0] + im[12])) + filt[4] * (im[4] + im[8]),
              -(filt[1] * (im[1] + im[11])) + filt[3] * (im[3] + im[9])]
    in_re2 = [filt[5] * (r[7] - r[5]),
              filt[0] * (r[12] - r[0]) + filt[4] * (r[8] - r[4]),
              filt[1] * (r[11] - r[1]) + filt[3] * (r[9] - r[3]),
              filt[2] * (r[10] - r[2])]
    x = [in_im2[n] + in_re2[3 - n] for n in range(4)]
    y = _dct3_4(*x)
    temp[i, 7, 1] = y[0]
    temp[i, 5, 1] = y[2]
    temp[i, 3, 1] = y[3]
    temp[i, 1, 1] = y[1]
    x = [in_im2[n] - in_re2[3 - n] for n in range(4)]
    y = _dct3_4(*x)
    temp[i, 6, 1] = y[1]
    temp[i, 4, 1] = y[3]
    temp[i, 2, 1] = y[2]
    temp[i, 0, 1] = y[0]


def _dct3_6(x):
    f0 = x[3] * _SQ05
    f1 = x[0] + f0
    f2 = x[0] - f0
    f3 = (x[1] - x[5]) * _SQ05
    f4 = x[2] * F32(0.86602540378444) + x[4] * F32(0.5)
    f5 = f4 - x[4]
    f6 = x[1] * F32(0.96592582628907) + x[5] * F32(0.25881904510252)
    f7 = f6 - f3
    y = [None] * 6
    y[0] = f1 + f6 + f4
    y[1] = f2 + f3 - x[4]
    y[2] = f7 + f2 - f5
    y[3] = f1 - f7 - f5
    y[4] = f1 - f3 - x[4]
    y[5] = f2 - f6 + f4
    return y


def _channel_filter12(frame_len, filt, buf, temp):
    i = np.arange(frame_len)
    r = [buf[i + k, 0] for k in range(13)]
    im = [buf[i + k, 1] for k in range(13)]
    in_re1 = [None] * 6
    in_re2 = [None] * 6
    in_im1 = [None] * 6
    in_im2 = [None] * 6
    for n in range(6):
        if n == 0:
            in_re1[0] = r[6] * filt[6]
            in_re2[0] = im[6] * filt[6]
        else:
            in_re1[6 - n] = (r[n] + r[12 - n]) * filt[n]
            in_re2[6 - n] = (im[n] + im[12 - n]) * filt[n]
        in_im2[n] = (r[n] - r[12 - n]) * filt[n]
        in_im1[n] = (im[n] - im[12 - n]) * filt[n]
    out_re1 = _dct3_6(in_re1)
    out_re2 = _dct3_6(in_re2)
    out_im1 = _dct3_6(in_im1)
    out_im2 = _dct3_6(in_im2)
    for n in range(0, 6, 2):
        temp[i, n, 0] = out_re1[n] - out_im1[n]
        temp[i, n, 1] = out_re2[n] + out_im2[n]
        temp[i, n + 1, 0] = out_re1[n + 1] + out_im1[n + 1]
        temp[i, n + 1, 1] = out_re2[n + 1] - out_im2[n + 1]
        temp[i, 10 - n, 0] = out_re1[n + 1] - out_im1[n + 1]
        temp[i, 10 - n, 1] = out_re2[n + 1] + out_im2[n + 1]
        temp[i, 11 - n, 0] = out_re1[n] + out_im1[n]
        temp[i, 11 - n, 1] = out_re2[n] - out_im2[n]


def hybrid_analysis(hyb, X, X_hybrid, use34, numTimeSlotsRate):
    qmf_bands = 5 if use34 else 3
    resolution = hyb.resolution34 if use34 else hyb.resolution20
    offset = 0
    for band in range(qmf_bands):
        hyb.work[:12] = hyb.buffer[band]
        for n in range(hyb.frame_len):
            hyb.work[12 + n, 0] = X[n + 6, band, 0]
            hyb.work[12 + n, 1] = X[n + 6, band, 1]
        hyb.buffer[band] = hyb.work[hyb.frame_len:hyb.frame_len + 12]
        res = resolution[band]
        if res == 2:
            _channel_filter2(hyb.frame_len, T.P2_13_20, hyb.work,
                             hyb.temp)
        elif res == 4:
            _channel_filter4(hyb.frame_len, T.P4_13_34, hyb.work,
                             hyb.temp)
        elif res == 8:
            _channel_filter8(hyb.frame_len,
                             T.P8_13_34 if use34 else T.P8_13_20,
                             hyb.work, hyb.temp)
        elif res == 12:
            _channel_filter12(hyb.frame_len, T.P12_13_34, hyb.work,
                              hyb.temp)
        X_hybrid[:hyb.frame_len, offset:offset + res] = \
            hyb.temp[:hyb.frame_len, :res]
        offset += res
    if not use34:
        n = np.arange(numTimeSlotsRate)
        X_hybrid[n, 3] = X_hybrid[n, 3] + X_hybrid[n, 4]
        X_hybrid[n, 4] = 0
        X_hybrid[n, 2] = X_hybrid[n, 2] + X_hybrid[n, 5]
        X_hybrid[n, 5] = 0


def hybrid_synthesis(hyb, X, X_hybrid, use34, numTimeSlotsRate):
    qmf_bands = 5 if use34 else 3
    resolution = hyb.resolution34 if use34 else hyb.resolution20
    offset = 0
    for band in range(qmf_bands):
        res = resolution[band]
        for n in range(hyb.frame_len):
            acc_r = F32(0)
            acc_i = F32(0)
            for k in range(res):
                acc_r = F32(acc_r + X_hybrid[n, offset + k, 0])
                acc_i = F32(acc_i + X_hybrid[n, offset + k, 1])
            X[n, band, 0] = acc_r
            X[n, band, 1] = acc_i
        offset += res


# --------------------------------------------------------------------------
# parameter decode (ps_dec.c:607-1030)
# --------------------------------------------------------------------------

def _delta_clip(i, lo, hi):
    return lo if i < lo else (hi if i > hi else i)


def _delta_decode(enable, index, index_prev, dt_flag, nr_par, stride,
                  min_index, max_index):
    if enable == 1:
        if dt_flag == 0:
            index[0] = _delta_clip(int(index[0]), min_index, max_index)
            for i in range(1, nr_par):
                index[i] = _delta_clip(int(index[i - 1]) + int(index[i]),
                                       min_index, max_index)
        else:
            for i in range(nr_par):
                index[i] = _delta_clip(
                    int(index_prev[i * stride]) + int(index[i]),
                    min_index, max_index)
    else:
        index[:nr_par] = 0
    if stride == 2:
        for i in range((nr_par << 1) - 1, 0, -1):
            index[i] = index[i >> 1]


def _delta_modulo_decode(enable, index, index_prev, dt_flag, nr_par,
                         stride, and_modulo):
    if enable == 1:
        if dt_flag == 0:
            index[0] = int(index[0]) & and_modulo
            for i in range(1, nr_par):
                index[i] = (int(index[i - 1]) + int(index[i])) & \
                    and_modulo
        else:
            for i in range(nr_par):
                index[i] = (int(index_prev[i * stride]) +
                            int(index[i])) & and_modulo
    else:
        index[:nr_par] = 0
    if stride == 2:
        index[0] = 0
        for i in range((nr_par << 1) - 1, 0, -1):
            index[i] = index[i >> 1]


def _map20indexto34(index, bins):
    index[0] = index[0]
    index[1] = (int(index[0]) + int(index[1])) // 2
    index[2] = index[1]
    index[3] = index[2]
    index[4] = (int(index[2]) + int(index[3])) // 2
    index[5] = index[3]
    index[6] = index[4]
    index[7] = index[4]
    index[8] = index[5]
    index[9] = index[5]
    index[10] = index[6]
    index[11] = index[7]
    index[12] = index[8]
    index[13] = index[8]
    index[14] = index[9]
    index[15] = index[9]
    index[16] = index[10]
    if bins == 34:
        index[17] = index[11]
        index[18] = index[12]
        index[19] = index[13]
        index[20] = index[14]
        index[21] = index[14]
        index[22] = index[15]
        index[23] = index[15]
        index[24] = index[16]
        index[25] = index[16]
        index[26] = index[17]
        index[27] = index[17]
        index[28] = index[18]
        index[29] = index[18]
        index[30] = index[18]
        index[31] = index[18]
        index[32] = index[19]
        index[33] = index[19]


def ps_data_decode(ps):
    """ps_data_decode (ps_dec.c:801-1030)."""
    if ps.ps_data_available == 0:
        ps.num_env = 0
    for env in range(ps.num_env):
        num_iid_steps = 7 if ps.iid_mode < 3 else 15
        if env == 0:
            iid_prev = ps.iid_index_prev
            icc_prev = ps.icc_index_prev
            ipd_prev = ps.ipd_index_prev
            opd_prev = ps.opd_index_prev
        else:
            iid_prev = ps.iid_index[env - 1]
            icc_prev = ps.icc_index[env - 1]
            ipd_prev = ps.ipd_index[env - 1]
            opd_prev = ps.opd_index[env - 1]
        _delta_decode(ps.enable_iid, ps.iid_index[env], iid_prev,
                      ps.iid_dt[env], ps.nr_iid_par,
                      2 if ps.iid_mode in (0, 3) else 1,
                      -num_iid_steps, num_iid_steps)
        _delta_decode(ps.enable_icc, ps.icc_index[env], icc_prev,
                      ps.icc_dt[env], ps.nr_icc_par,
                      2 if ps.icc_mode in (0, 3) else 1, 0, 7)
        _delta_modulo_decode(ps.enable_ipdopd, ps.ipd_index[env],
                             ipd_prev, ps.ipd_dt[env], ps.nr_ipdopd_par,
                             1, 7)
        _delta_modulo_decode(ps.enable_ipdopd, ps.opd_index[env],
                             opd_prev, ps.opd_dt[env], ps.nr_ipdopd_par,
                             1, 7)
    if ps.num_env == 0:
        ps.num_env = 1
        if ps.enable_iid:
            ps.iid_index[0][:] = ps.iid_index_prev
        else:
            ps.iid_index[0][:] = 0
        if ps.enable_icc:
            ps.icc_index[0][:] = ps.icc_index_prev
        else:
            ps.icc_index[0][:] = 0
        if ps.enable_ipdopd:
            ps.ipd_index[0][:] = ps.ipd_index_prev
            ps.opd_index[0][:] = ps.opd_index_prev
        else:
            ps.ipd_index[0][:] = 0
            ps.opd_index[0][:] = 0
    ps.iid_index_prev[:] = ps.iid_index[ps.num_env - 1]
    ps.icc_index_prev[:] = ps.icc_index[ps.num_env - 1]
    ps.ipd_index_prev[:] = ps.ipd_index[ps.num_env - 1]
    ps.opd_index_prev[:] = ps.opd_index[ps.num_env - 1]
    ps.ps_data_available = 0
    if ps.frame_class == 0:
        ps.border_position[0] = 0
        for env in range(1, ps.num_env):
            ps.border_position[env] = \
                (env * ps.numTimeSlotsRate) // ps.num_env
        ps.border_position[ps.num_env] = ps.numTimeSlotsRate
    else:
        ps.border_position[0] = 0
        if ps.border_position[ps.num_env] < ps.numTimeSlotsRate:
            ps.iid_index[ps.num_env][:] = ps.iid_index[ps.num_env - 1]
            ps.icc_index[ps.num_env][:] = ps.icc_index[ps.num_env - 1]
            ps.ipd_index[ps.num_env][:] = ps.ipd_index[ps.num_env - 1]
            ps.opd_index[ps.num_env][:] = ps.opd_index[ps.num_env - 1]
            ps.num_env += 1
            ps.border_position[ps.num_env] = ps.numTimeSlotsRate
        for env in range(1, ps.num_env):
            thr = ps.numTimeSlotsRate - (ps.num_env - env)
            if ps.border_position[env] > thr:
                ps.border_position[env] = thr
            else:
                thr = ps.border_position[env - 1] + 1
                if ps.border_position[env] < thr:
                    ps.border_position[env] = thr
    if ps.use34hybrid_bands:
        for env in range(ps.num_env):
            if ps.iid_mode not in (2, 5):
                _map20indexto34(ps.iid_index[env], 34)
            if ps.icc_mode not in (2, 5):
                _map20indexto34(ps.icc_index[env], 34)
            if ps.ipd_mode not in (2, 5):
                _map20indexto34(ps.ipd_index[env], 17)
                _map20indexto34(ps.opd_index[env], 17)


# --------------------------------------------------------------------------
# decorrelation (ps_dec.c:1033-1382)
# --------------------------------------------------------------------------

def ps_decorrelate(ps, X_left, X_right, X_hybrid_left, X_hybrid_right):
    if ps.use34hybrid_bands:
        phi_fract_sub = T.PHI_FRACT_SUBQMF34
        q_fract_sub = T.Q_FRACT_ALLPASS_SUBQMF34
    else:
        phi_fract_sub = T.PHI_FRACT_SUBQMF20
        q_fract_sub = T.Q_FRACT_ALLPASS_SUBQMF20

    P = np.zeros((32, 34), F32)
    G_TransientRatio = np.zeros((32, 34), F32)
    n0 = ps.border_position[0]
    n1 = ps.border_position[ps.num_env]

    # energy per parameter band (accumulation order: per (gr, sb), over
    # n — addition order within P[n][bk] follows the C loop nest: for
    # each n the contributions accumulate in gr/sb order)
    for gr in range(ps.num_groups):
        bk = (~NEGATE_IPD_MASK) & int(ps.map_group2bk[gr])
        maxsb = int(ps.group_border[gr]) + 1 \
            if gr < ps.num_hybrid_groups else int(ps.group_border[gr + 1])
        for sb in range(int(ps.group_border[gr]), maxsb):
            for n in range(n0, n1):
                if gr < ps.num_hybrid_groups:
                    re = X_hybrid_left[n, sb, 0]
                    im = X_hybrid_left[n, sb, 1]
                else:
                    re = X_left[n, sb, 0]
                    im = X_left[n, sb, 1]
                P[n, bk] = F32(P[n, bk] +
                               F32(F32(re * re) + F32(im * im)))

    for bk in range(ps.nr_par_bands):
        for n in range(n0, n1):
            gamma = F32(1.5)
            ps.P_PeakDecayNrg[bk] = F32(ps.P_PeakDecayNrg[bk] *
                                        ps.alpha_decay)
            if ps.P_PeakDecayNrg[bk] < P[n, bk]:
                ps.P_PeakDecayNrg[bk] = P[n, bk]
            smooth = ps.P_SmoothPeakDecayDiffNrg_prev[bk]
            smooth = F32(smooth + F32(
                F32(F32(ps.P_PeakDecayNrg[bk] - P[n, bk]) - smooth) *
                ps.alpha_smooth))
            ps.P_SmoothPeakDecayDiffNrg_prev[bk] = smooth
            nrg = ps.P_prev[bk]
            nrg = F32(nrg + F32(F32(P[n, bk] - nrg) * ps.alpha_smooth))
            ps.P_prev[bk] = nrg
            if F32(smooth * gamma) <= nrg:
                G_TransientRatio[n, bk] = F32(1.0)
            else:
                G_TransientRatio[n, bk] = F32(nrg / F32(smooth * gamma))

    for gr in range(ps.num_groups):
        maxsb = int(ps.group_border[gr]) + 1 \
            if gr < ps.num_hybrid_groups else int(ps.group_border[gr + 1])
        for sb in range(int(ps.group_border[gr]), maxsb):
            if gr < ps.num_hybrid_groups or sb <= ps.decay_cutoff:
                g_DecaySlope = F32(1.0)
            else:
                decay = ps.decay_cutoff - sb
                if decay <= -20:
                    g_DecaySlope = F32(0)
                else:
                    g_DecaySlope = F32(F32(1.0) + DECAY_SLOPE * decay)
            g_filt = [F32(g_DecaySlope * T.FILTER_A[m])
                      for m in range(NO_ALLPASS_LINKS)]
            temp_delay = ps.saved_delay
            temp_delay_ser = [int(v) for v in ps.delay_buf_index_ser]
            for n in range(n0, n1):
                if gr < ps.num_hybrid_groups:
                    in_re = X_hybrid_left[n, sb, 0]
                    in_im = X_hybrid_left[n, sb, 1]
                else:
                    in_re = X_left[n, sb, 0]
                    in_im = X_left[n, sb, 1]
                if sb > ps.nr_allpass_bands and \
                        gr >= ps.num_hybrid_groups:
                    di = ps.delay_buf_index_delay[sb]
                    r0_re = ps.delay_Qmf[di, sb, 0]
                    r0_im = ps.delay_Qmf[di, sb, 1]
                    ps.delay_Qmf[di, sb, 0] = in_re
                    ps.delay_Qmf[di, sb, 1] = in_im
                else:
                    if gr < ps.num_hybrid_groups:
                        t0_re = ps.delay_SubQmf[temp_delay, sb, 0]
                        t0_im = ps.delay_SubQmf[temp_delay, sb, 1]
                        ps.delay_SubQmf[temp_delay, sb, 0] = in_re
                        ps.delay_SubQmf[temp_delay, sb, 1] = in_im
                        ph_re = phi_fract_sub[sb, 0]
                        ph_im = phi_fract_sub[sb, 1]
                    else:
                        t0_re = ps.delay_Qmf[temp_delay, sb, 0]
                        t0_im = ps.delay_Qmf[temp_delay, sb, 1]
                        ps.delay_Qmf[temp_delay, sb, 0] = in_re
                        ps.delay_Qmf[temp_delay, sb, 1] = in_im
                        ph_re = T.PHI_FRACT_QMF[sb, 0]
                        ph_im = T.PHI_FRACT_QMF[sb, 1]
                    # ComplexMult(re, im) = (x1*c1 + x2*c2,
                    #                        x2*c1 - x1*c2)
                    t_re = F32(F32(t0_re * ph_re) + F32(t0_im * ph_im))
                    t_im = F32(F32(t0_im * ph_re) - F32(t0_re * ph_im))
                    r0_re = t_re
                    r0_im = t_im
                    for m in range(NO_ALLPASS_LINKS):
                        if gr < ps.num_hybrid_groups:
                            t0_re = ps.delay_SubQmf_ser[
                                m, temp_delay_ser[m], sb, 0]
                            t0_im = ps.delay_SubQmf_ser[
                                m, temp_delay_ser[m], sb, 1]
                            q_re = q_fract_sub[sb, m, 0]
                            q_im = q_fract_sub[sb, m, 1]
                        else:
                            t0_re = ps.delay_Qmf_ser[
                                m, temp_delay_ser[m], sb, 0]
                            t0_im = ps.delay_Qmf_ser[
                                m, temp_delay_ser[m], sb, 1]
                            q_re = T.Q_FRACT_ALLPASS_QMF[sb, m, 0]
                            q_im = T.Q_FRACT_ALLPASS_QMF[sb, m, 1]
                        t_re = F32(F32(t0_re * q_re) + F32(t0_im * q_im))
                        t_im = F32(F32(t0_im * q_re) - F32(t0_re * q_im))
                        t_re = F32(t_re + -F32(g_filt[m] * r0_re))
                        t_im = F32(t_im + -F32(g_filt[m] * r0_im))
                        t2_re = F32(r0_re + F32(g_filt[m] * t_re))
                        t2_im = F32(r0_im + F32(g_filt[m] * t_im))
                        if gr < ps.num_hybrid_groups:
                            ps.delay_SubQmf_ser[
                                m, temp_delay_ser[m], sb, 0] = t2_re
                            ps.delay_SubQmf_ser[
                                m, temp_delay_ser[m], sb, 1] = t2_im
                        else:
                            ps.delay_Qmf_ser[
                                m, temp_delay_ser[m], sb, 0] = t2_re
                            ps.delay_Qmf_ser[
                                m, temp_delay_ser[m], sb, 1] = t2_im
                        r0_re = t_re
                        r0_im = t_im
                bk = (~NEGATE_IPD_MASK) & int(ps.map_group2bk[gr])
                r0_re = F32(G_TransientRatio[n, bk] * r0_re)
                r0_im = F32(G_TransientRatio[n, bk] * r0_im)
                if gr < ps.num_hybrid_groups:
                    X_hybrid_right[n, sb, 0] = r0_re
                    X_hybrid_right[n, sb, 1] = r0_im
                else:
                    X_right[n, sb, 0] = r0_re
                    X_right[n, sb, 1] = r0_im
                temp_delay += 1
                if temp_delay >= 2:
                    temp_delay = 0
                if sb > ps.nr_allpass_bands and \
                        gr >= ps.num_hybrid_groups:
                    ps.delay_buf_index_delay[sb] += 1
                    if ps.delay_buf_index_delay[sb] >= ps.delay_D[sb]:
                        ps.delay_buf_index_delay[sb] = 0
                for m in range(NO_ALLPASS_LINKS):
                    temp_delay_ser[m] += 1
                    if temp_delay_ser[m] >= ps.num_sample_delay_ser[m]:
                        temp_delay_ser[m] = 0
    ps.saved_delay = temp_delay
    for m in range(NO_ALLPASS_LINKS):
        ps.delay_buf_index_ser[m] = temp_delay_ser[m]


# --------------------------------------------------------------------------
# mixing + phase (ps_dec.c:1404-1860) and the driver
# --------------------------------------------------------------------------

def _magnitude_c(re, im):
    """magnitude_c float: sqrt(re*re + im*im) with C promotion (sqrt
    takes double of the float sum)."""
    return F32(np.sqrt(np.float64(F32(F32(re * re) + F32(im * im)))))


_COEF_SQRT2 = F32(1.4142135623731)


def ps_mix_phase(ps, X_left, X_right, X_hybrid_left, X_hybrid_right):
    if ps.iid_mode >= 3:
        no_iid_steps = 15
        sf_iid = T.SF_IID_FINE
    else:
        no_iid_steps = 7
        sf_iid = T.SF_IID_NORMAL
    if ps.ipd_mode == 0 or ps.ipd_mode == 3:
        nr_ipdopd_par = 11
    else:
        nr_ipdopd_par = ps.nr_ipdopd_par

    for gr in range(ps.num_groups):
        bk = (~NEGATE_IPD_MASK) & int(ps.map_group2bk[gr])
        maxsb = int(ps.group_border[gr]) + 1 \
            if gr < ps.num_hybrid_groups else int(ps.group_border[gr + 1])
        for env in range(ps.num_env):
            iid = int(ps.iid_index[env][bk])
            icc = int(ps.icc_index[env][bk])
            if ps.icc_mode < 3:
                # type A mixing
                c_1 = sf_iid[no_iid_steps + iid]
                c_2 = sf_iid[no_iid_steps - iid]
                cosa = T.COS_ALPHAS[icc]
                sina = T.SIN_ALPHAS[icc]
                if ps.iid_mode >= 3:
                    if iid < 0:
                        cosb = T.COS_BETAS_FINE[-iid][icc]
                        sinb = F32(-T.SIN_BETAS_FINE[-iid][icc])
                    else:
                        cosb = T.COS_BETAS_FINE[iid][icc]
                        sinb = T.SIN_BETAS_FINE[iid][icc]
                else:
                    if iid < 0:
                        cosb = T.COS_BETAS_NORMAL[-iid][icc]
                        sinb = F32(-T.SIN_BETAS_NORMAL[-iid][icc])
                    else:
                        cosb = T.COS_BETAS_NORMAL[iid][icc]
                        sinb = T.SIN_BETAS_NORMAL[iid][icc]
                ab1 = F32(cosb * cosa)
                ab2 = F32(sinb * sina)
                ab3 = F32(sinb * cosa)
                ab4 = F32(cosb * sina)
                h11 = [F32(c_2 * F32(ab1 - ab2)), F32(0)]
                h12 = [F32(c_1 * F32(ab1 + ab2)), F32(0)]
                h21 = [F32(c_2 * F32(ab3 + ab4)), F32(0)]
                h22 = [F32(c_1 * F32(ab3 - ab4)), F32(0)]
            else:
                # type B mixing
                abs_iid = abs(iid)
                if ps.iid_mode >= 3:
                    cosa = T.SINCOS_ALPHAS_B_FINE[no_iid_steps +
                                                  iid][icc]
                    sina = T.SINCOS_ALPHAS_B_FINE[30 - (no_iid_steps +
                                                        iid)][icc]
                    cosg = T.COS_GAMMAS_FINE[abs_iid][icc]
                    sing = T.SIN_GAMMAS_FINE[abs_iid][icc]
                else:
                    cosa = T.SINCOS_ALPHAS_B_NORMAL[no_iid_steps +
                                                    iid][icc]
                    sina = T.SINCOS_ALPHAS_B_NORMAL[14 - (no_iid_steps +
                                                          iid)][icc]
                    cosg = T.COS_GAMMAS_NORMAL[abs_iid][icc]
                    sing = T.SIN_GAMMAS_NORMAL[abs_iid][icc]
                h11 = [F32(_COEF_SQRT2 * F32(cosa * cosg)), F32(0)]
                h12 = [F32(_COEF_SQRT2 * F32(sina * cosg)), F32(0)]
                h21 = [F32(_COEF_SQRT2 * F32(F32(-cosa) * sing)), F32(0)]
                h22 = [F32(_COEF_SQRT2 * F32(sina * sing)), F32(0)]

            enable_rot = ps.enable_ipdopd and bk < nr_ipdopd_par
            if enable_rot:
                i = ps.phase_hist
                tl_re = F32(ps.ipd_prev[bk, i, 0] * F32(0.25))
                tl_im = F32(ps.ipd_prev[bk, i, 1] * F32(0.25))
                tr_re = F32(ps.opd_prev[bk, i, 0] * F32(0.25))
                tr_im = F32(ps.opd_prev[bk, i, 1] * F32(0.25))
                ipd = int(ps.ipd_index[env][bk])
                opd = int(ps.opd_index[env][bk])
                ps.ipd_prev[bk, i, 0] = T.IPDOPD_COS_TAB[abs(ipd)]
                ps.ipd_prev[bk, i, 1] = T.IPDOPD_SIN_TAB[abs(ipd)]
                ps.opd_prev[bk, i, 0] = T.IPDOPD_COS_TAB[abs(opd)]
                ps.opd_prev[bk, i, 1] = T.IPDOPD_SIN_TAB[abs(opd)]
                tl_re = F32(tl_re + ps.ipd_prev[bk, i, 0])
                tl_im = F32(tl_im + ps.ipd_prev[bk, i, 1])
                tr_re = F32(tr_re + ps.opd_prev[bk, i, 0])
                tr_im = F32(tr_im + ps.opd_prev[bk, i, 1])
                if i == 0:
                    i = 2
                i -= 1
                tl_re = F32(tl_re + F32(ps.ipd_prev[bk, i, 0] *
                                        F32(0.5)))
                tl_im = F32(tl_im + F32(ps.ipd_prev[bk, i, 1] *
                                        F32(0.5)))
                tr_re = F32(tr_re + F32(ps.opd_prev[bk, i, 0] *
                                        F32(0.5)))
                tr_im = F32(tr_im + F32(ps.opd_prev[bk, i, 1] *
                                        F32(0.5)))
                xy = _magnitude_c(tr_re, tr_im)
                pq = _magnitude_c(tl_re, tl_im)
                if xy != 0:
                    pl_re = F32(tr_re / xy)
                    pl_im = F32(tr_im / xy)
                else:
                    pl_re = F32(0)
                    pl_im = F32(0)
                xypq = F32(xy * pq)
                if xypq != 0:
                    tmp1 = F32(F32(tr_re * tl_re) + F32(tr_im * tl_im))
                    tmp2 = F32(F32(tr_im * tl_re) - F32(tr_re * tl_im))
                    pr_re = F32(tmp1 / xypq)
                    pr_im = F32(tmp2 / xypq)
                else:
                    pr_re = F32(0)
                    pr_im = F32(0)
                h11[1] = F32(h11[0] * pl_im)
                h12[1] = F32(h12[0] * pr_im)
                h21[1] = F32(h21[0] * pl_im)
                h22[1] = F32(h22[0] * pr_im)
                h11[0] = F32(h11[0] * pl_re)
                h12[0] = F32(h12[0] * pr_re)
                h21[0] = F32(h21[0] * pl_re)
                h22[0] = F32(h22[0] * pr_re)

            L = F32(ps.border_position[env + 1] -
                    ps.border_position[env])
            dH11_re = F32(F32(h11[0] - ps.h11_prev[gr, 0]) / L)
            dH12_re = F32(F32(h12[0] - ps.h12_prev[gr, 0]) / L)
            dH21_re = F32(F32(h21[0] - ps.h21_prev[gr, 0]) / L)
            dH22_re = F32(F32(h22[0] - ps.h22_prev[gr, 0]) / L)
            H11_re = ps.h11_prev[gr, 0]
            H12_re = ps.h12_prev[gr, 0]
            H21_re = ps.h21_prev[gr, 0]
            H22_re = ps.h22_prev[gr, 0]
            ps.h11_prev[gr, 0] = h11[0]
            ps.h12_prev[gr, 0] = h12[0]
            ps.h21_prev[gr, 0] = h21[0]
            ps.h22_prev[gr, 0] = h22[0]
            dH11_im = dH12_im = dH21_im = dH22_im = F32(0)
            H11_im = H12_im = H21_im = H22_im = F32(0)
            if enable_rot:
                dH11_im = F32(F32(h11[1] - ps.h11_prev[gr, 1]) / L)
                dH12_im = F32(F32(h12[1] - ps.h12_prev[gr, 1]) / L)
                dH21_im = F32(F32(h21[1] - ps.h21_prev[gr, 1]) / L)
                dH22_im = F32(F32(h22[1] - ps.h22_prev[gr, 1]) / L)
                H11_im = ps.h11_prev[gr, 1]
                H12_im = ps.h12_prev[gr, 1]
                H21_im = ps.h21_prev[gr, 1]
                H22_im = ps.h22_prev[gr, 1]
                if (NEGATE_IPD_MASK & int(ps.map_group2bk[gr])) != 0:
                    dH11_im = F32(-dH11_im)
                    dH12_im = F32(-dH12_im)
                    dH21_im = F32(-dH21_im)
                    dH22_im = F32(-dH22_im)
                    H11_im = F32(-H11_im)
                    H12_im = F32(-H12_im)
                    H21_im = F32(-H21_im)
                    H22_im = F32(-H22_im)
                ps.h11_prev[gr, 1] = h11[1]
                ps.h12_prev[gr, 1] = h12[1]
                ps.h21_prev[gr, 1] = h21[1]
                ps.h22_prev[gr, 1] = h22[1]

            for n in range(ps.border_position[env],
                           ps.border_position[env + 1]):
                H11_re = F32(H11_re + dH11_re)
                H12_re = F32(H12_re + dH12_re)
                H21_re = F32(H21_re + dH21_re)
                H22_re = F32(H22_re + dH22_re)
                if enable_rot:
                    H11_im = F32(H11_im + dH11_im)
                    H12_im = F32(H12_im + dH12_im)
                    H21_im = F32(H21_im + dH21_im)
                    H22_im = F32(H22_im + dH22_im)
                for sb in range(int(ps.group_border[gr]), maxsb):
                    if gr < ps.num_hybrid_groups:
                        inl_re = X_hybrid_left[n, sb, 0]
                        inl_im = X_hybrid_left[n, sb, 1]
                        inr_re = X_hybrid_right[n, sb, 0]
                        inr_im = X_hybrid_right[n, sb, 1]
                    else:
                        inl_re = X_left[n, sb, 0]
                        inl_im = X_left[n, sb, 1]
                        inr_re = X_right[n, sb, 0]
                        inr_im = X_right[n, sb, 1]
                    tl_re = F32(F32(H11_re * inl_re) +
                                F32(H21_re * inr_re))
                    tl_im = F32(F32(H11_re * inl_im) +
                                F32(H21_re * inr_im))
                    tr_re = F32(F32(H12_re * inl_re) +
                                F32(H22_re * inr_re))
                    tr_im = F32(F32(H12_re * inl_im) +
                                F32(H22_re * inr_im))
                    if enable_rot:
                        tl_re = F32(tl_re - F32(F32(H11_im * inl_im) +
                                                F32(H21_im * inr_im)))
                        tl_im = F32(tl_im + F32(F32(H11_im * inl_re) +
                                                F32(H21_im * inr_re)))
                        tr_re = F32(tr_re - F32(F32(H12_im * inl_im) +
                                                F32(H22_im * inr_im)))
                        tr_im = F32(tr_im + F32(F32(H12_im * inl_re) +
                                                F32(H22_im * inr_re)))
                    if gr < ps.num_hybrid_groups:
                        X_hybrid_left[n, sb, 0] = tl_re
                        X_hybrid_left[n, sb, 1] = tl_im
                        X_hybrid_right[n, sb, 0] = tr_re
                        X_hybrid_right[n, sb, 1] = tr_im
                    else:
                        X_left[n, sb, 0] = tl_re
                        X_left[n, sb, 1] = tl_im
                        X_right[n, sb, 0] = tr_re
                        X_right[n, sb, 1] = tr_im
            ps.phase_hist += 1
            if ps.phase_hist == 2:
                ps.phase_hist = 0


def ps_decode(ps, X_left, X_right):
    """ps_decode (ps_dec.c:1964-2013): mono QMF matrix -> stereo."""
    X_hybrid_left = np.zeros((32, 32, 2), F32)
    X_hybrid_right = np.zeros((32, 32, 2), F32)
    ps_data_decode(ps)
    if ps.use34hybrid_bands:
        ps.group_border = T.GROUP_BORDER34
        ps.map_group2bk = T.MAP_GROUP2BK34
        ps.num_groups = 32 + 18
        ps.num_hybrid_groups = 32
        ps.nr_par_bands = 34
        ps.decay_cutoff = 5
    else:
        ps.group_border = T.GROUP_BORDER20
        ps.map_group2bk = T.MAP_GROUP2BK20
        ps.num_groups = 10 + 12
        ps.num_hybrid_groups = 10
        ps.nr_par_bands = 20
        ps.decay_cutoff = 3
    hybrid_analysis(ps.hyb, X_left, X_hybrid_left, ps.use34hybrid_bands,
                    ps.numTimeSlotsRate)
    ps_decorrelate(ps, X_left, X_right, X_hybrid_left, X_hybrid_right)
    ps_mix_phase(ps, X_left, X_right, X_hybrid_left, X_hybrid_right)
    hybrid_synthesis(ps.hyb, X_left, X_hybrid_left,
                     ps.use34hybrid_bands, ps.numTimeSlotsRate)
    hybrid_synthesis(ps.hyb, X_right, X_hybrid_right,
                     ps.use34hybrid_bands, ps.numTimeSlotsRate)
    return 0
