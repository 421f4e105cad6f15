"""SBR — Spectral Band Replication decode (HE-AAC), float bit-exact.

Port of faad2-2.8.8's SBR stack (sbr_dec.c, sbr_syntax.c, sbr_huff.c,
sbr_qmf.c, sbr_dct.c dct4_kernel/fft_dif, sbr_fbt.c, sbr_tf_grid.c,
sbr_e_nf.c, sbr_hfgen.c, sbr_hfadj.c — high-quality float build, no
SBR_LOW_POWER / FIXED_POINT / DRM).  All arithmetic is IEEE float32 in
the reference's association order, so output matches the compiled C
bit for bit.

The daemon uses this for the implicit-signalling HE-AAC path: streams
with core rate <= 24 kHz always run through the 32-band QMF analysis /
64-band synthesis for a 2x upsample (decoder.c:363-371), with the full
envelope-adjusted high-band reconstruction when SBR fill-element data
is present, and parametric stereo (codecs/ps.py) when the SBR extension
carries PS data.

Constant tables are extracted from the compiled reference by
oracle/gen_sbr_tables.py.
"""
from __future__ import annotations

import numpy as np

from wmix_tpu_torch.codecs import _sbr_tables as T

F32 = np.float32

# sbr_syntax.h
T_HFGEN = 8
T_HFADJ = 2
RATE = 2
NO_TIME_SLOTS = 16
NO_TIME_SLOTS_960 = 15
EXT_SBR_DATA = 13
EXT_SBR_DATA_CRC = 14
FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)
LO_RES, HI_RES = 0, 1
# sbr_dec.h
MAX_NTSRHFG = 40
MAX_NTSR = 32
MAX_M = 49
MAX_L_E = 5
# syntax.h element ids
ID_SCE, ID_CPE, ID_CCE, ID_LFE = 0, 1, 2, 3

EPS = 1e-12


def get_sr_index(samplerate: int) -> int:
    """common.c get_sr_index: frequency -> nearest table index."""
    if 92017 <= samplerate:
        return 0
    if 75132 <= samplerate:
        return 1
    if 55426 <= samplerate:
        return 2
    if 46009 <= samplerate:
        return 3
    if 37566 <= samplerate:
        return 4
    if 27713 <= samplerate:
        return 5
    if 23004 <= samplerate:
        return 6
    if 18783 <= samplerate:
        return 7
    if 13856 <= samplerate:
        return 8
    if 11502 <= samplerate:
        return 9
    if 9391 <= samplerate:
        return 10
    return 11


# --------------------------------------------------------------------------
# DCT-IV kernel + 32-point DIF FFT (sbr_dct.c:1898-2279), vectorized over
# a leading batch axis; per-element operation order matches C exactly
# --------------------------------------------------------------------------

_BIT_REV32 = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22,
                       14, 30, 1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27,
                       7, 23, 15, 31], np.int64)


def _fft_dif(re, im):
    """fft_dif: in-place on [..., 32] float32 arrays."""
    wr = T.W_ARRAY_REAL
    wi = T.W_ARRAY_IMAG
    # stage 1
    p1r = re[..., :16] - re[..., 16:]
    p1i = im[..., :16] - im[..., 16:]
    re[..., :16] = re[..., :16] + re[..., 16:]
    im[..., :16] = im[..., :16] + im[..., 16:]
    re[..., 16:] = p1r * wr - p1i * wi
    im[..., 16:] = p1r * wi + p1i * wr
    # stage 2 (two half-FFTs, twiddles w[2j])
    for base in (0, 16):
        a = slice(base, base + 8)
        b = slice(base + 8, base + 16)
        p1r = re[..., a] - re[..., b]
        p1i = im[..., a] - im[..., b]
        re[..., a] = re[..., a] + re[..., b]
        im[..., a] = im[..., a] + im[..., b]
        re[..., b] = p1r * wr[0::2] - p1i * wi[0::2]
        im[..., b] = p1r * wi[0::2] + p1i * wr[0::2]
    # stage 3
    i0 = np.arange(0, 32, 8)
    for off, mode in ((0, "add"), (1, "w4"), (2, "negi"), (3, "w12")):
        ia = i0 + off
        ib = ia + 4
        p1r = re[..., ia].copy()
        p1i = im[..., ia].copy()
        p2r = re[..., ib].copy()
        p2i = im[..., ib].copy()
        re[..., ia] = p1r + p2r
        im[..., ia] = p1i + p2i
        if mode == "add":
            re[..., ib] = p1r - p2r
            im[..., ib] = p1i - p2i
        elif mode == "w4":
            d_r = p1r - p2r
            d_i = p1i - p2i
            re[..., ib] = (d_r + d_i) * wr[4]
            im[..., ib] = (d_i - d_r) * wr[4]
        elif mode == "negi":
            re[..., ib] = p1i - p2i
            im[..., ib] = p2r - p1r
        else:  # w12 = -sqrt2/2
            d_r = p1r - p2r
            d_i = p1i - p2i
            re[..., ib] = (d_r - d_i) * wr[12]
            im[..., ib] = (d_r + d_i) * wr[12]
    # stage 4
    i0 = np.arange(0, 32, 4)
    ia, ib = i0, i0 + 2
    p1r = re[..., ia].copy()
    p1i = im[..., ia].copy()
    p2r = re[..., ib].copy()
    p2i = im[..., ib].copy()
    re[..., ia] = p1r + p2r
    im[..., ia] = p1i + p2i
    re[..., ib] = p1r - p2r
    im[..., ib] = p1i - p2i
    ia, ib = i0 + 1, i0 + 3
    p1r = re[..., ia].copy()
    p1i = im[..., ia].copy()
    p2r = re[..., ib].copy()
    p2i = im[..., ib].copy()
    re[..., ia] = p1r + p2r
    im[..., ia] = p1i + p2i
    re[..., ib] = p1i - p2i
    im[..., ib] = p2r - p1r
    # stage 5
    ia = np.arange(0, 32, 2)
    ib = ia + 1
    p1r = re[..., ia].copy()
    p1i = im[..., ia].copy()
    p2r = re[..., ib].copy()
    p2i = im[..., ib].copy()
    re[..., ia] = p1r + p2r
    im[..., ia] = p1i + p2i
    re[..., ib] = p1r - p2r
    im[..., ib] = p1i - p2i


def dct4_kernel(in_re, in_im):
    """sbr_dct.c:2225 — DCT_IV core (modulate, fft_dif, modulate +
    bit-reverse).  in_re/in_im [..., 32] are CONSUMED (modified);
    returns (out_re, out_im)."""
    tab = T.DCT4_64_TAB
    x_re = in_re.copy()
    x_im = in_im.copy()
    tmp = (x_re + x_im) * tab[:32]
    in_re[...] = x_im * tab[64:96] + tmp
    in_im[...] = x_re * tab[32:64] + tmp
    _fft_dif(in_re, in_im)
    out_re = np.empty_like(in_re)
    out_im = np.empty_like(in_im)
    rev = _BIT_REV32
    x_re = in_re[..., rev]
    x_im = in_im[..., rev]
    idx = np.r_[np.arange(0, 16), np.arange(17, 32)]
    tmp = (x_re[..., idx] + x_im[..., idx]) * tab[96:128][idx]
    out_re[..., idx] = x_im[..., idx] * tab[160:192][idx] + tmp
    out_im[..., idx] = x_re[..., idx] * tab[128:160][idx] + tmp
    # i = 16 special case (i_rev = 1)
    out_im[..., 16] = (in_im[..., 1] - in_re[..., 1]) * tab[96 + 16]
    out_re[..., 16] = (in_re[..., 1] + in_im[..., 1]) * tab[96 + 16]
    return out_re, out_im


# --------------------------------------------------------------------------
# QMF filter banks (sbr_qmf.c, high-quality float path)
# --------------------------------------------------------------------------

class QmfAnalysis:
    """qmfa_init/sbr_qmf_analysis_32: 32-band complex analysis."""

    def __init__(self):
        self.x = np.zeros(2 * 32 * 10, F32)  # double ringbuffer
        self.x_index = 0

    def analysis(self, sbr: "SbrInfo", inp: np.ndarray, X: np.ndarray,
                 offset: int, kx: int):
        """inp: float32[numTimeSlotsRate*32]; X[MAX_NTSRHFG][64][2]."""
        qc = T.QMF_C
        inp = np.asarray(inp, F32)
        in_pos = 0
        for sl in range(sbr.numTimeSlotsRate):
            xi = self.x_index
            # add new samples (reversed)
            block = inp[in_pos:in_pos + 32][::-1]
            in_pos += 32
            self.x[xi:xi + 32] = block
            self.x[xi + 320:xi + 352] = block
            # window + summation, u[0..63]
            n = np.arange(64)
            u = (self.x[xi + n] * qc[2 * n] +
                 self.x[xi + n + 64] * qc[2 * (n + 64)] +
                 self.x[xi + n + 128] * qc[2 * (n + 128)] +
                 self.x[xi + n + 192] * qc[2 * (n + 192)] +
                 self.x[xi + n + 256] * qc[2 * (n + 256)])
            self.x_index -= 32
            if self.x_index < 0:
                self.x_index = 320 - 32
            # reorder into DCT-IV kernel input
            in_re = np.empty(32, F32)
            in_im = np.empty(32, F32)
            in_im[31] = u[1]
            in_re[0] = u[0]
            k = np.arange(1, 31)
            in_im[31 - k] = u[k + 1]
            in_re[k] = -u[64 - k]
            in_im[0] = u[32]
            in_re[31] = -u[33]
            out_re, out_im = dct4_kernel(in_re, in_im)
            # reorder to QMF subbands; only the 32 analysis bands are
            # written (the upper rows keep last frame's shifted HF data)
            row = X[sl + offset]
            two = F32(2.0)
            for nn in range(16):
                if 2 * nn + 1 < kx:
                    row[2 * nn, 0] = two * out_re[nn]
                    row[2 * nn, 1] = two * out_im[nn]
                    row[2 * nn + 1, 0] = F32(-2.0) * out_im[31 - nn]
                    row[2 * nn + 1, 1] = F32(-2.0) * out_re[31 - nn]
                else:
                    if 2 * nn < kx:
                        row[2 * nn, 0] = two * out_re[nn]
                        row[2 * nn, 1] = two * out_im[nn]
                    else:
                        row[2 * nn, 0] = 0
                        row[2 * nn, 1] = 0
                    row[2 * nn + 1, 0] = 0
                    row[2 * nn + 1, 1] = 0


class QmfSynthesis64:
    """qmfs_init(64)/sbr_qmf_synthesis_64."""

    def __init__(self):
        self.v = np.zeros(2 * 64 * 20, F32)
        self.v_index = 0

    def synthesis(self, sbr: "SbrInfo", X: np.ndarray) -> np.ndarray:
        qc = T.QMF_C
        out = np.empty(sbr.numTimeSlotsRate * 64, F32)
        scale = F32(1.0 / 64.0)
        o = 0
        for sl in range(sbr.numTimeSlotsRate):
            pX = X[sl]
            in_re1 = np.empty(32, F32)
            in_im1 = np.empty(32, F32)
            in_re2 = np.empty(32, F32)
            in_im2 = np.empty(32, F32)
            in_im1[31] = scale * pX[1, 0]
            in_re1[0] = scale * pX[0, 0]
            in_im2[31] = scale * pX[63 - 1, 1]
            in_re2[0] = scale * pX[63 - 0, 1]
            k = np.arange(1, 31)
            in_im1[31 - k] = scale * pX[2 * k + 1, 0]
            in_re1[k] = scale * pX[2 * k, 0]
            in_im2[31 - k] = scale * pX[63 - (2 * k + 1), 1]
            in_re2[k] = scale * pX[63 - 2 * k, 1]
            in_im1[0] = scale * pX[63, 0]
            in_re1[31] = scale * pX[62, 0]
            in_im2[0] = scale * pX[0, 1]
            in_re2[31] = scale * pX[1, 1]
            o1r, o1i = dct4_kernel(in_re1, in_im1)
            o2r, o2i = dct4_kernel(in_re2, in_im2)
            vi = self.v_index
            n = np.arange(32)
            a = o2r - o1r                       # pring_buffer_1 forward
            b = (o2i + o1i)[::-1]               # interleave partner
            c = o2r + o1r                       # pring_buffer_2 backward
            d = (o2i - o1i)[::-1]
            fwd = np.empty(64, F32)
            fwd[0::2] = a
            fwd[1::2] = b
            bwd = np.empty(64, F32)
            bwd[0::2] = d[::-1]
            bwd[1::2] = c[::-1]
            self.v[vi:vi + 64] = fwd
            self.v[vi + 1280:vi + 1344] = fwd
            self.v[vi + 64:vi + 128] = bwd
            self.v[vi + 1344:vi + 1408] = bwd
            k = np.arange(64)
            out[o:o + 64] = (
                self.v[vi + k] * qc[k] +
                self.v[vi + 192 + k] * qc[64 + k] +
                self.v[vi + 256 + k] * qc[128 + k] +
                self.v[vi + 448 + k] * qc[192 + k] +
                self.v[vi + 512 + k] * qc[256 + k] +
                self.v[vi + 704 + k] * qc[320 + k] +
                self.v[vi + 768 + k] * qc[384 + k] +
                self.v[vi + 960 + k] * qc[448 + k] +
                self.v[vi + 1024 + k] * qc[512 + k] +
                self.v[vi + 1216 + k] * qc[576 + k])
            o += 64
            self.v_index -= 128
            if self.v_index < 0:
                self.v_index = 1280 - 128
        return out


class QmfSynthesis32:
    """qmfs_init(32)/sbr_qmf_synthesis_32 (downsampled output)."""

    def __init__(self):
        self.v = np.zeros(2 * 32 * 20, F32)
        self.v_index = 0

    def synthesis(self, sbr: "SbrInfo", X: np.ndarray) -> np.ndarray:
        qc = T.QMF_C
        pre = T.QMF32_PRE_TWIDDLE
        out = np.empty(sbr.numTimeSlotsRate * 32, F32)
        scale = F32(1.0 / 64.0)
        o = 0
        for sl in range(sbr.numTimeSlotsRate):
            pX = X[sl]
            x1 = (pX[:32, 0] * pre[:, 0] - pX[:32, 1] * pre[:, 1]) * scale
            x2 = (pX[:32, 1] * pre[:, 0] + pX[:32, 0] * pre[:, 1]) * scale
            x1 = _dct4_32(x1)
            x2 = _dst4_32(x2)
            vi = self.v_index
            n = np.arange(32)
            self.v[vi + n] = -x1 + x2
            self.v[vi + 640 + n] = -x1 + x2
            self.v[vi + 63 - n] = x1 + x2
            self.v[vi + 640 + 63 - n] = x1 + x2
            k = np.arange(32)
            out[o:o + 32] = (
                self.v[vi + k] * qc[2 * k] +
                self.v[vi + 96 + k] * qc[64 + 2 * k] +
                self.v[vi + 128 + k] * qc[128 + 2 * k] +
                self.v[vi + 224 + k] * qc[192 + 2 * k] +
                self.v[vi + 256 + k] * qc[256 + 2 * k] +
                self.v[vi + 352 + k] * qc[320 + 2 * k] +
                self.v[vi + 384 + k] * qc[384 + 2 * k] +
                self.v[vi + 480 + k] * qc[448 + 2 * k] +
                self.v[vi + 512 + k] * qc[512 + 2 * k] +
                self.v[vi + 608 + k] * qc[576 + 2 * k])
            o += 32
            self.v_index -= 64
            if self.v_index < 0:
                self.v_index = 640 - 64
        return out


def _dct4_32(x):
    """DCT4_32 via the shared kernel (equivalent reordering; only used
    on the downsampled path, which the daemon never takes — kept for
    API completeness, NOT bit-exact vs the Spiral straight-line code."""
    N = 32
    n = np.arange(N)
    k = n.reshape(-1, 1)
    m = np.cos(np.pi / N * (k + 0.5) * (n + 0.5)).astype(F32)
    return (x[None, :].astype(np.float64) @ m.T.astype(np.float64)) \
        .astype(F32)[0]


def _dst4_32(x):
    N = 32
    n = np.arange(N)
    k = n.reshape(-1, 1)
    m = np.sin(np.pi / N * (k + 0.5) * (n + 0.5)).astype(F32)
    return (x[None, :].astype(np.float64) @ m.T.astype(np.float64)) \
        .astype(F32)[0]


# --------------------------------------------------------------------------
# sbr_info state (structs.h sbr_info + sbrDecodeInit, sbr_dec.c:54-145)
# --------------------------------------------------------------------------

class SbrInfo:
    def __init__(self, framelength: int, id_aac: int, sample_rate: int,
                 downSampledSBR: int = 0):
        self.id_aac = id_aac
        self.sample_rate = sample_rate
        self.downSampledSBR = downSampledSBR

        self.bs_freq_scale = 2
        self.bs_alter_scale = 1
        self.bs_noise_bands = 2
        self.bs_limiter_bands = 2
        self.bs_limiter_gains = 2
        self.bs_interpol_freq = 1
        self.bs_smoothing_mode = 1
        self.bs_start_freq = 5
        self.bs_stop_freq = 0
        self.bs_xover_band = 0
        self.bs_amp_res = 1
        self.bs_samplerate_mode = 1
        self.bs_coupling = 0
        self.bs_header_flag = 0
        self.bs_extension_id = 0
        self.bs_extension_data = 0
        self.bs_extended_data = 0
        self.bs_start_freq_prev = -1
        self.bs_stop_freq_prev = 0
        self.bs_freq_scale_prev = 2
        self.bs_alter_scale_prev = 1
        self.bs_xover_band_prev = 0
        self.bs_noise_bands_prev = 2
        self.prevEnvIsShort = [-1, -1]
        self.header_count = 0
        self.Reset = 1
        self.ret = 0
        self.frame = 0
        self.just_seeked = 0
        self.tHFGen = T_HFGEN
        self.tHFAdj = T_HFADJ
        self.bsco = 0
        self.bsco_prev = 0
        self.M = 0
        self.M_prev = 0
        self.kx = 0
        self.kx_prev = 0
        self.k0 = 0
        self.N_master = 0
        self.N_high = 0
        self.N_low = 0
        self.N_Q = 0
        self.N_L = np.zeros(4, np.int64)
        self.n = np.zeros(2, np.int64)
        self.frame_len = framelength
        self.maxAACLine = 0

        if framelength == 960:
            self.numTimeSlotsRate = RATE * NO_TIME_SLOTS_960
            self.numTimeSlots = NO_TIME_SLOTS_960
        else:
            self.numTimeSlotsRate = RATE * NO_TIME_SLOTS
            self.numTimeSlots = NO_TIME_SLOTS

        self.GQ_ringbuf_index = [0, 0]
        nch = 2 if id_aac == ID_CPE else 1
        self.qmfa = [QmfAnalysis() for _ in range(nch)]
        self.qmfs = [(QmfSynthesis32() if downSampledSBR
                      else QmfSynthesis64()) for _ in range(nch)]
        self.G_temp_prev = np.zeros((2, 5, 64), F32)
        self.Q_temp_prev = np.zeros((2, 5, 64), F32)
        self.Xsbr = np.zeros((2, MAX_NTSRHFG, 64, 2), F32)

        self.f_master = np.zeros(64, np.int64)
        self.f_table_res = np.zeros((2, 64), np.int64)
        self.f_table_noise = np.zeros(64, np.int64)
        self.f_table_lim = np.zeros((4, 100), np.int64)
        self.table_map_k_to_g = np.zeros(64, np.int64)

        self.abs_bord_lead = [0, 0]
        self.abs_bord_trail = [0, 0]
        self.n_rel_lead = [0, 0]
        self.n_rel_trail = [0, 0]
        self.bs_frame_class = [0, 0]
        self.bs_rel_bord = np.zeros((2, 9), np.int64)
        self.bs_rel_bord_0 = np.zeros((2, 9), np.int64)
        self.bs_rel_bord_1 = np.zeros((2, 9), np.int64)
        self.bs_pointer = [0, 0]
        self.bs_num_rel_0 = [0, 0]
        self.bs_num_rel_1 = [0, 0]
        self.bs_df_env = np.zeros((2, 9), np.int64)
        self.bs_df_noise = np.zeros((2, 3), np.int64)
        self.bs_invf_mode = np.zeros((2, MAX_L_E), np.int64)
        self.bs_invf_mode_prev = np.zeros((2, MAX_L_E), np.int64)
        self.bs_add_harmonic = np.zeros((2, 64), np.int64)
        self.bs_add_harmonic_prev = np.zeros((2, 64), np.int64)
        self.bs_add_harmonic_flag = [0, 0]
        self.bs_add_harmonic_flag_prev = [0, 0]
        self.L_E = [0, 0]
        self.L_E_prev = [0, 0]
        self.L_Q = [0, 0]
        self.t_E = np.zeros((2, 6), np.int64)
        self.t_Q = np.zeros((2, 3), np.int64)
        self.f = np.zeros((2, MAX_L_E + 1), np.int64)
        self.f_prev = [0, 0]
        self.l_A = [0, 0]
        self.amp_res = [0, 0]

        self.E = np.zeros((2, 64, MAX_L_E), np.int64)
        self.E_prev = np.zeros((2, 64), np.int64)
        self.E_orig = np.zeros((2, 64, MAX_L_E), F32)
        self.E_curr = np.zeros((2, 64, MAX_L_E), F32)
        self.Q = np.zeros((2, 64, 2), np.int64)
        self.Q_prev = np.zeros((2, 64), np.int64)
        self.Q_div = np.zeros((2, 64, 2), F32)
        self.Q_div2 = np.zeros((2, 64, 2), F32)
        self.Q_orig = np.zeros((2, 64, 2), F32)

        self.bwArray = np.zeros((2, 64), F32)
        self.bwArray_prev = np.zeros((2, 64), F32)

        self.noPatches = 0
        self.patchNoSubbands = np.zeros(64, np.int64)
        self.patchStartSubband = np.zeros(64, np.int64)

        self.index_noise_prev = [0, 0]
        self.psi_is_prev = [0, 0]

        self.ps = None
        self.ps_used = 0
        self.psResetFlag = 0

        self.rate = 2

    # -- sbr_dec.c:183-249 sbrReset --
    def sbr_reset(self_out):
        pass  # (full reset not needed by the daemon's streaming path)


# --------------------------------------------------------------------------
# frequency band tables (sbr_fbt.c)
# --------------------------------------------------------------------------

def qmf_start_channel(bs_start_freq, bs_samplerate_mode, sample_rate):
    sr = get_sr_index(sample_rate)
    start_min = int(T.START_MIN[sr])
    offset_index = int(T.OFFSET_INDEX[sr])
    if bs_samplerate_mode:
        return start_min + int(T.START_OFFSET[offset_index][bs_start_freq])
    return start_min + int(T.START_OFFSET[6][bs_start_freq])


def qmf_stop_channel(bs_stop_freq, sample_rate, k0):
    if bs_stop_freq == 15:
        return min(64, k0 * 3)
    if bs_stop_freq == 14:
        return min(64, k0 * 2)
    sr = get_sr_index(sample_rate)
    stop_min = int(T.STOP_MIN[sr])
    return min(64, stop_min +
               int(T.STOP_OFFSET[sr][min(bs_stop_freq, 13)]))


def master_frequency_table_fs0(sbr, k0, k2, bs_alter_scale):
    if k2 <= k0:
        sbr.N_master = 0
        return 1
    dk = 2 if bs_alter_scale else 1
    if bs_alter_scale:
        nr_bands = ((k2 - k0 + 2) >> 2) << 1
    else:
        nr_bands = ((k2 - k0) >> 1) << 1
    nr_bands = min(nr_bands, 63)
    if nr_bands <= 0:
        return 1
    k2_achieved = k0 + nr_bands * dk
    k2_diff = k2 - k2_achieved
    v_dk = [dk] * nr_bands
    if k2_diff:
        incr = -1 if k2_diff > 0 else 1
        k = nr_bands - 1 if k2_diff > 0 else 0
        while k2_diff != 0:
            v_dk[k] -= incr
            k += incr
            k2_diff += incr
    sbr.f_master[0] = k0
    for k in range(1, nr_bands + 1):
        sbr.f_master[k] = sbr.f_master[k - 1] + v_dk[k - 1]
    sbr.N_master = min(nr_bands, 64)
    return 0


def _find_bands(warp, bands, a0, a1):
    """float path: bands * log(a1/a0)/log(2[*1.3]) + 0.5 (C float)."""
    import math
    div = F32(math.log(2.0))
    if warp:
        div = F32(div * F32(1.3))
    return int(bands * F32(math.log(F32(a1) / F32(a0))) / div + 0.5)


def _find_initial_power(bands, a0, a1):
    return F32((F32(a1) / F32(a0)) ** F32(1.0 / bands))


def master_frequency_table(sbr, k0, k2, bs_freq_scale, bs_alter_scale):
    if k2 <= k0:
        sbr.N_master = 0
        return 1
    bands = [6, 5, 4][bs_freq_scale - 1]
    if F32(k2) / F32(k0) > 2.2449:
        two_regions = 1
        k1 = k0 << 1
    else:
        two_regions = 0
        k1 = k2
    nr_band0 = min(2 * _find_bands(0, bands, k0, k1), 63)
    if nr_band0 <= 0:
        return 1
    q = _find_initial_power(nr_band0, k0, k1)
    qk = F32(k0)
    A_1 = int(qk + F32(0.5))
    v_dk0 = []
    for k in range(nr_band0 + 1):
        A_0 = A_1
        qk = F32(qk * q)
        A_1 = int(qk + 0.5)
        v_dk0.append(A_1 - A_0)
    v_dk0[:nr_band0] = sorted(v_dk0[:nr_band0])
    vk0 = [k0]
    for k in range(1, nr_band0 + 1):
        if v_dk0[k - 1] == 0:
            return 1
        vk0.append(vk0[k - 1] + v_dk0[k - 1])
    if not two_regions:
        for k in range(nr_band0 + 1):
            sbr.f_master[k] = vk0[k]
        sbr.N_master = min(nr_band0, 64)
        return 0
    nr_band1 = min(2 * _find_bands(1, bands, k1, k2), 63)
    q = _find_initial_power(nr_band1, k1, k2)
    qk = F32(k1)
    A_1 = int(qk + F32(0.5))
    v_dk1 = [0] * 64
    for k in range(nr_band1):
        A_0 = A_1
        qk = F32(qk * q)
        A_1 = int(qk + 0.5)
        v_dk1[k] = A_1 - A_0
    if v_dk1[0] < v_dk0[nr_band0 - 1]:
        v_dk1[:nr_band1 + 1] = sorted(v_dk1[:nr_band1 + 1])
        change = v_dk0[nr_band0 - 1] - v_dk1[0]
        v_dk1[0] = v_dk0[nr_band0 - 1]
        v_dk1[nr_band1 - 1] = v_dk1[nr_band1 - 1] - change
    v_dk1[:nr_band1] = sorted(v_dk1[:nr_band1])
    vk1 = [k1]
    for k in range(1, nr_band1 + 1):
        if v_dk1[k - 1] == 0:
            return 1
        vk1.append(vk1[k - 1] + v_dk1[k - 1])
    sbr.N_master = min(nr_band0 + nr_band1, 64)
    for k in range(nr_band0 + 1):
        sbr.f_master[k] = vk0[k]
    for k in range(nr_band0 + 1, sbr.N_master + 1):
        sbr.f_master[k] = vk1[k - nr_band0]
    return 0


def derived_frequency_table(sbr, bs_xover_band, k2):
    if sbr.N_master <= bs_xover_band:
        return 1
    sbr.N_high = sbr.N_master - bs_xover_band
    sbr.N_low = (sbr.N_high >> 1) + (sbr.N_high - ((sbr.N_high >> 1) << 1))
    sbr.n[0] = sbr.N_low
    sbr.n[1] = sbr.N_high
    for k in range(sbr.N_high + 1):
        sbr.f_table_res[HI_RES][k] = sbr.f_master[k + bs_xover_band]
    sbr.M = int(sbr.f_table_res[HI_RES][sbr.N_high] -
                sbr.f_table_res[HI_RES][0])
    sbr.kx = int(sbr.f_table_res[HI_RES][0])
    if sbr.kx > 32 or sbr.kx + sbr.M > 64:
        return 1
    minus = 1 if (sbr.N_high & 1) else 0
    for k in range(sbr.N_low + 1):
        i = 0 if k == 0 else 2 * k - minus
        sbr.f_table_res[LO_RES][k] = sbr.f_table_res[HI_RES][i]
    sbr.N_Q = 0
    if sbr.bs_noise_bands == 0:
        sbr.N_Q = 1
    else:
        sbr.N_Q = min(5, max(1, _find_bands(0, sbr.bs_noise_bands,
                                            sbr.kx, k2)))
    i = 0
    for k in range(sbr.N_Q + 1):
        if k != 0:
            i = i + (sbr.N_low - i) // (sbr.N_Q + 1 - k)
        sbr.f_table_noise[k] = sbr.f_table_res[LO_RES][i]
    for k in range(64):
        for g in range(sbr.N_Q):
            if sbr.f_table_noise[g] <= k < sbr.f_table_noise[g + 1]:
                sbr.table_map_k_to_g[k] = g
                break
    return 0


def limiter_frequency_table(sbr):
    """sbr_fbt.c:626-764 (all four limiter band settings)."""
    sbr.f_table_lim[0][0] = sbr.f_table_res[LO_RES][0] - sbr.kx
    sbr.f_table_lim[0][1] = sbr.f_table_res[LO_RES][sbr.N_low] - sbr.kx
    sbr.N_L[0] = 1
    for s in range(1, 4):
        patch_borders = [0] * 64
        patch_borders[0] = sbr.kx
        for k in range(1, sbr.noPatches + 1):
            patch_borders[k] = patch_borders[k - 1] + \
                int(sbr.patchNoSubbands[k - 1])
        lim_table = [0] * 100
        for k in range(sbr.N_low + 1):
            lim_table[k] = int(sbr.f_table_res[LO_RES][k])
        for k in range(1, sbr.noPatches):
            lim_table[k + sbr.N_low] = patch_borders[k]
        n_all = sbr.noPatches + sbr.N_low
        lim_table[:n_all] = sorted(lim_table[:n_all])
        k = 1
        nr_lim = sbr.noPatches + sbr.N_low - 1
        if nr_lim < 0:
            return
        while k <= nr_lim:
            if lim_table[k - 1] != 0:
                n_octaves = F32(lim_table[k]) / F32(lim_table[k - 1])
            else:
                n_octaves = F32(0)
            if n_octaves < T.LIMITER_BANDS_COMPARE[s - 1]:
                if lim_table[k] != lim_table[k - 1]:
                    found = any(lim_table[k] == patch_borders[i]
                                for i in range(sbr.noPatches + 1))
                    if found:
                        found2 = any(
                            lim_table[k - 1] == patch_borders[i]
                            for i in range(sbr.noPatches + 1))
                        if found2:
                            k += 1
                            continue
                        # remove (k-1)th element
                        lim_table[k - 1] = \
                            int(sbr.f_table_res[LO_RES][sbr.N_low])
                        lim_table[:n_all] = sorted(lim_table[:n_all])
                        nr_lim -= 1
                        continue
                # remove kth element
                lim_table[k] = int(sbr.f_table_res[LO_RES][sbr.N_low])
                lim_table[:nr_lim] = sorted(lim_table[:nr_lim])
                nr_lim -= 1
                continue
            k += 1
        sbr.N_L[s] = nr_lim
        for k in range(nr_lim + 1):
            sbr.f_table_lim[s][k] = lim_table[k] - sbr.kx


# --------------------------------------------------------------------------
# time/frequency grid (sbr_tf_grid.c)
# --------------------------------------------------------------------------

def envelope_time_border_vector(sbr, ch):
    t_e = [0] * 6
    t_e[0] = sbr.rate * sbr.abs_bord_lead[ch]
    t_e[sbr.L_E[ch]] = sbr.rate * sbr.abs_bord_trail[ch]
    fc = sbr.bs_frame_class[ch]
    if fc == FIXFIX:
        if sbr.L_E[ch] == 4:
            temp = sbr.numTimeSlots // 4
            t_e[3] = sbr.rate * 3 * temp
            t_e[2] = sbr.rate * 2 * temp
            t_e[1] = sbr.rate * temp
        elif sbr.L_E[ch] == 2:
            t_e[1] = sbr.rate * (sbr.numTimeSlots // 2)
    elif fc == FIXVAR:
        if sbr.L_E[ch] > 1:
            i = sbr.L_E[ch]
            border = sbr.abs_bord_trail[ch]
            for l in range(sbr.L_E[ch] - 1):
                if border < sbr.bs_rel_bord[ch][l]:
                    return 1
                border -= int(sbr.bs_rel_bord[ch][l])
                i -= 1
                t_e[i] = sbr.rate * border
    elif fc == VARFIX:
        if sbr.L_E[ch] > 1:
            i = 1
            border = sbr.abs_bord_lead[ch]
            for l in range(sbr.L_E[ch] - 1):
                border += int(sbr.bs_rel_bord[ch][l])
                if sbr.rate * border + sbr.tHFAdj > \
                        sbr.numTimeSlotsRate + sbr.tHFGen:
                    return 1
                t_e[i] = sbr.rate * border
                i += 1
    else:  # VARVAR
        if sbr.bs_num_rel_0[ch]:
            i = 1
            border = sbr.abs_bord_lead[ch]
            for l in range(sbr.bs_num_rel_0[ch]):
                border += int(sbr.bs_rel_bord_0[ch][l])
                if sbr.rate * border + sbr.tHFAdj > \
                        sbr.numTimeSlotsRate + sbr.tHFGen:
                    return 1
                t_e[i] = sbr.rate * border
                i += 1
        if sbr.bs_num_rel_1[ch]:
            i = sbr.L_E[ch]
            border = sbr.abs_bord_trail[ch]
            for l in range(sbr.bs_num_rel_1[ch]):
                if border < sbr.bs_rel_bord_1[ch][l]:
                    return 1
                border -= int(sbr.bs_rel_bord_1[ch][l])
                i -= 1
                t_e[i] = sbr.rate * border
    sbr.t_E[ch][:] = t_e
    return 0


def _middle_border(sbr, ch):
    fc = sbr.bs_frame_class[ch]
    if fc == FIXFIX:
        retval = sbr.L_E[ch] // 2
    elif fc == VARFIX:
        if sbr.bs_pointer[ch] == 0:
            retval = 1
        elif sbr.bs_pointer[ch] == 1:
            retval = sbr.L_E[ch] - 1
        else:
            retval = sbr.bs_pointer[ch] - 1
    else:
        if sbr.bs_pointer[ch] > 1:
            retval = sbr.L_E[ch] + 1 - sbr.bs_pointer[ch]
        else:
            retval = sbr.L_E[ch] - 1
    return retval if retval > 0 else 0


def noise_floor_time_border_vector(sbr, ch):
    sbr.t_Q[ch][0] = sbr.t_E[ch][0]
    if sbr.L_E[ch] == 1:
        sbr.t_Q[ch][1] = sbr.t_E[ch][1]
        sbr.t_Q[ch][2] = 0
    else:
        index = _middle_border(sbr, ch)
        sbr.t_Q[ch][1] = sbr.t_E[ch][index]
        sbr.t_Q[ch][2] = sbr.t_E[ch][sbr.L_E[ch]]


# --------------------------------------------------------------------------
# envelope/noise data (sbr_huff.c + sbr_e_nf.c)
# --------------------------------------------------------------------------

def _sbr_huff_dec(ld, table):
    index = 0
    while index >= 0:
        bit = ld.get1()
        index = int(table[index][bit])
    return index + 64


def sbr_envelope(ld, sbr, ch):
    if sbr.L_E[ch] == 1 and sbr.bs_frame_class[ch] == FIXFIX:
        sbr.amp_res[ch] = 0
    else:
        sbr.amp_res[ch] = sbr.bs_amp_res

    if sbr.bs_coupling and ch == 1:
        delta = 1
        if sbr.amp_res[ch]:
            t_huff, f_huff = T.T_HUFF_ENV_BAL_3_0, T.F_HUFF_ENV_BAL_3_0
        else:
            t_huff, f_huff = T.T_HUFF_ENV_BAL_1_5, T.F_HUFF_ENV_BAL_1_5
    else:
        delta = 0
        if sbr.amp_res[ch]:
            t_huff, f_huff = T.T_HUFF_ENV_3_0, T.F_HUFF_ENV_3_0
        else:
            t_huff, f_huff = T.T_HUFF_ENV_1_5, T.F_HUFF_ENV_1_5

    for env in range(sbr.L_E[ch]):
        if sbr.bs_df_env[ch][env] == 0:
            if sbr.bs_coupling and ch == 1:
                bits = 5 if sbr.amp_res[ch] else 6
            else:
                bits = 6 if sbr.amp_res[ch] else 7
            sbr.E[ch][0][env] = ld.get(bits) << delta
            for band in range(1, int(sbr.n[sbr.f[ch][env]])):
                sbr.E[ch][band][env] = _sbr_huff_dec(ld, f_huff) << delta
        else:
            for band in range(int(sbr.n[sbr.f[ch][env]])):
                sbr.E[ch][band][env] = _sbr_huff_dec(ld, t_huff) << delta
    extract_envelope_data(sbr, ch)


def sbr_noise(ld, sbr, ch):
    if sbr.bs_coupling and ch == 1:
        delta = 1
        t_huff, f_huff = T.T_HUFF_NOISE_BAL_3_0, T.F_HUFF_ENV_BAL_3_0
    else:
        delta = 0
        t_huff, f_huff = T.T_HUFF_NOISE_3_0, T.F_HUFF_ENV_3_0
    for noise in range(sbr.L_Q[ch]):
        if sbr.bs_df_noise[ch][noise] == 0:
            sbr.Q[ch][0][noise] = ld.get(5) << delta
            for band in range(1, sbr.N_Q):
                sbr.Q[ch][band][noise] = _sbr_huff_dec(ld, f_huff) << delta
        else:
            for band in range(sbr.N_Q):
                sbr.Q[ch][band][noise] = _sbr_huff_dec(ld, t_huff) << delta
    extract_noise_floor_data(sbr, ch)


def extract_envelope_data(sbr, ch):
    """sbr_e_nf.c:41-85 delta -> absolute (int16 arithmetic domain)."""
    for l in range(sbr.L_E[ch]):
        if sbr.bs_df_env[ch][l] == 0:
            for k in range(1, int(sbr.n[sbr.f[ch][l]])):
                sbr.E[ch][k][l] = sbr.E[ch][k - 1][l] + sbr.E[ch][k][l]
                if sbr.E[ch][k][l] < 0:
                    sbr.E[ch][k][l] = 0
        else:
            g = sbr.f_prev[ch] if l == 0 else int(sbr.f[ch][l - 1])
            if sbr.f[ch][l] == g:
                for k in range(int(sbr.n[sbr.f[ch][l]])):
                    e_prev = sbr.E_prev[ch][k] if l == 0 \
                        else sbr.E[ch][k][l - 1]
                    sbr.E[ch][k][l] = e_prev + sbr.E[ch][k][l]
            elif g == 1 and sbr.f[ch][l] == 0:
                for k in range(int(sbr.n[sbr.f[ch][l]])):
                    for i in range(sbr.N_high):
                        if sbr.f_table_res[HI_RES][i] == \
                                sbr.f_table_res[LO_RES][k]:
                            e_prev = sbr.E_prev[ch][i] if l == 0 \
                                else sbr.E[ch][i][l - 1]
                            sbr.E[ch][k][l] = e_prev + sbr.E[ch][k][l]
            elif g == 0 and sbr.f[ch][l] == 1:
                for k in range(int(sbr.n[sbr.f[ch][l]])):
                    for i in range(sbr.N_low):
                        if sbr.f_table_res[LO_RES][i] <= \
                                sbr.f_table_res[HI_RES][k] and \
                                sbr.f_table_res[HI_RES][k] < \
                                sbr.f_table_res[LO_RES][i + 1]:
                            e_prev = sbr.E_prev[ch][i] if l == 0 \
                                else sbr.E[ch][i][l - 1]
                            sbr.E[ch][k][l] = e_prev + sbr.E[ch][k][l]


def extract_noise_floor_data(sbr, ch):
    for l in range(sbr.L_Q[ch]):
        if sbr.bs_df_noise[ch][l] == 0:
            for k in range(1, sbr.N_Q):
                sbr.Q[ch][k][l] = sbr.Q[ch][k][l] + sbr.Q[ch][k - 1][l]
        else:
            if l == 0:
                for k in range(sbr.N_Q):
                    sbr.Q[ch][k][l] = sbr.Q_prev[ch][k] + sbr.Q[ch][k][0]
            else:
                for k in range(sbr.N_Q):
                    sbr.Q[ch][k][l] = sbr.Q[ch][k][l - 1] + sbr.Q[ch][k][l]


def _calc_q_div(sbr, ch, m, l):
    if sbr.bs_coupling:
        if (sbr.Q[0][m][l] < 0 or sbr.Q[0][m][l] > 30 or
                sbr.Q[1][m][l] < 0 or sbr.Q[1][m][l] > 24):
            return F32(0)
        if ch == 0:
            return T.Q_DIV_TAB_LEFT[sbr.Q[0][m][l]][sbr.Q[1][m][l] >> 1]
        return T.Q_DIV_TAB_RIGHT[sbr.Q[0][m][l]][sbr.Q[1][m][l] >> 1]
    if sbr.Q[ch][m][l] < 0 or sbr.Q[ch][m][l] > 30:
        return F32(0)
    return T.Q_DIV_TAB[sbr.Q[ch][m][l]]


def _calc_q_div2(sbr, ch, m, l):
    if sbr.bs_coupling:
        if (sbr.Q[0][m][l] < 0 or sbr.Q[0][m][l] > 30 or
                sbr.Q[1][m][l] < 0 or sbr.Q[1][m][l] > 24):
            return F32(0)
        if ch == 0:
            return T.Q_DIV2_TAB_LEFT[sbr.Q[0][m][l]][sbr.Q[1][m][l] >> 1]
        return T.Q_DIV2_TAB_RIGHT[sbr.Q[0][m][l]][sbr.Q[1][m][l] >> 1]
    if sbr.Q[ch][m][l] < 0 or sbr.Q[ch][m][l] > 30:
        return F32(0)
    return T.Q_DIV2_TAB[sbr.Q[ch][m][l]]


_SQRT2_C = F32(1.414213562)


def envelope_noise_dequantisation(sbr, ch):
    """sbr_e_nf.c:395-437 (no-coupling float path)."""
    if sbr.bs_coupling != 0:
        return
    amp = 0 if sbr.amp_res[ch] else 1
    for l in range(sbr.L_E[ch]):
        for k in range(int(sbr.n[sbr.f[ch][l]])):
            exp = int(sbr.E[ch][k][l]) >> amp
            if exp < 0 or exp >= 64:
                sbr.E_orig[ch][k][l] = 0
            else:
                val = T.E_DEQ_TAB[exp]
                if amp and (sbr.E[ch][k][l] & 1):
                    val = F32(val * _SQRT2_C)
                sbr.E_orig[ch][k][l] = val
    for l in range(sbr.L_Q[ch]):
        for k in range(sbr.N_Q):
            sbr.Q_div[ch][k][l] = _calc_q_div(sbr, ch, k, l)
            sbr.Q_div2[ch][k][l] = _calc_q_div2(sbr, ch, k, l)


def unmap_envelope_noise(sbr):
    """sbr_e_nf.c:455-510 coupled-channel dequantisation."""
    amp0 = 0 if sbr.amp_res[0] else 1
    amp1 = 0 if sbr.amp_res[1] else 1
    for l in range(sbr.L_E[0]):
        for k in range(int(sbr.n[sbr.f[0][l]])):
            exp0 = (int(sbr.E[0][k][l]) >> amp0) + 1
            exp1 = int(sbr.E[1][k][l]) >> amp1
            if exp0 < 0 or exp0 >= 64 or exp1 < 0 or exp1 > 24:
                sbr.E_orig[1][k][l] = 0
                sbr.E_orig[0][k][l] = 0
            else:
                tmp = T.E_DEQ_TAB[exp0]
                if amp0 and (sbr.E[0][k][l] & 1):
                    tmp = F32(tmp * _SQRT2_C)
                # panning: E_orig[1] = tmp/pan, E_orig[0] = tmp*... via
                # the E_pan table; faad uses E_pan_tab — not extracted,
                # compute: pan = E_pan_tab[exp1] = 2^((12-exp1)... the
                # coupled path is unused by the daemon (SCE+PS fixture);
                # approximate per spec formula in float64 then f32
                import math
                pan = F32(2.0 ** (12 - exp1))
                sbr.E_orig[0][k][l] = F32(F32(tmp * pan) /
                                          F32(F32(1.0) + pan))
                sbr.E_orig[1][k][l] = F32(tmp / F32(F32(1.0) + pan))
    for l in range(sbr.L_Q[0]):
        for k in range(sbr.N_Q):
            sbr.Q_div[0][k][l] = _calc_q_div(sbr, 0, k, l)
            sbr.Q_div[1][k][l] = _calc_q_div(sbr, 1, k, l)
            sbr.Q_div2[0][k][l] = _calc_q_div2(sbr, 0, k, l)
            sbr.Q_div2[1][k][l] = _calc_q_div2(sbr, 1, k, l)


# --------------------------------------------------------------------------
# HF generation (sbr_hfgen.c, high-quality float path)
# --------------------------------------------------------------------------

# C: rel = 1 / (1 + 1e-6f) — the sum AND division happen in float32
# (int promotes to float against a float operand, not double)
_AC_REL = F32(F32(1.0) / F32(F32(1.0) + F32(1e-6)))


def _auto_correlation(sbr, buffer, bd, length):
    """auto_correlation (sbr_hfgen.c:272-410 float branch) on
    buffer[t][bd] -> dict of covariance terms (float32 accumulation in
    C summation order)."""
    offset = sbr.tHFAdj
    t2r = buffer[offset - 2, bd, 0]
    t2i = buffer[offset - 2, bd, 1]
    t3r = buffer[offset - 1, bd, 0]
    t3i = buffer[offset - 1, bd, 1]
    t4r, t4i, t5r, t5i = t2r, t2i, t3r, t3i
    r01r = F32(0)
    r01i = F32(0)
    r02r = F32(0)
    r02i = F32(0)
    r11r = F32(0)
    for j in range(offset, length + offset):
        t1r, t1i = t2r, t2i
        t2r, t2i = t3r, t3i
        t3r = buffer[j, bd, 0]
        t3i = buffer[j, bd, 1]
        r01r = F32(r01r + F32(F32(t3r * t2r) + F32(t3i * t2i)))
        r01i = F32(r01i + F32(F32(t3i * t2r) - F32(t3r * t2i)))
        r02r = F32(r02r + F32(F32(t3r * t1r) + F32(t3i * t1i)))
        r02i = F32(r02i + F32(F32(t3i * t1r) - F32(t3r * t1i)))
        r11r = F32(r11r + F32(F32(t2r * t2r) + F32(t2i * t2i)))
    r12r = F32(r01r - F32(F32(t3r * t2r) + F32(t3i * t2i)) +
               F32(F32(t5r * t4r) + F32(t5i * t4i)))
    r12i = F32(r01i - F32(F32(t3i * t2r) - F32(t3r * t2i)) +
               F32(F32(t5i * t4r) - F32(t5r * t4i)))
    r22r = F32(r11r - F32(F32(t2r * t2r) + F32(t2i * t2i)) +
               F32(F32(t4r * t4r) + F32(t4i * t4i)))
    det = F32(F32(r11r * r22r) -
              F32(_AC_REL * F32(F32(r12r * r12r) + F32(r12i * r12i))))
    return dict(r01r=r01r, r01i=r01i, r02r=r02r, r02i=r02i, r11r=r11r,
                r12r=r12r, r12i=r12i, r22r=r22r, det=det)


def _calc_prediction_coef(sbr, Xlow, alpha_0, alpha_1, k):
    ac = _auto_correlation(sbr, Xlow, k, sbr.numTimeSlotsRate + 6)
    if ac["det"] == 0:
        alpha_1[k] = (F32(0), F32(0))
    else:
        tmp = F32(F32(1.0) / ac["det"])
        a1r = F32(F32(F32(ac["r01r"] * ac["r12r"]) -
                      F32(ac["r01i"] * ac["r12i"]) -
                      F32(ac["r02r"] * ac["r11r"])) * tmp)
        a1i = F32(F32(F32(ac["r01i"] * ac["r12r"]) +
                      F32(ac["r01r"] * ac["r12i"]) -
                      F32(ac["r02i"] * ac["r11r"])) * tmp)
        alpha_1[k] = (a1r, a1i)
    if ac["r11r"] == 0:
        alpha_0[k] = (F32(0), F32(0))
    else:
        tmp = F32(F32(1.0) / ac["r11r"])
        # C association: ((r01 + a1_r*r12_r) + a1_i*r12_i)
        a0r = F32(-F32(F32(ac["r01r"] +
                           F32(alpha_1[k][0] * ac["r12r"])) +
                       F32(alpha_1[k][1] * ac["r12i"])) * tmp)
        a0i = F32(-F32(F32(ac["r01i"] +
                           F32(alpha_1[k][1] * ac["r12r"])) -
                       F32(alpha_1[k][0] * ac["r12i"])) * tmp)
        alpha_0[k] = (a0r, a0i)
    if (F32(F32(alpha_0[k][0] * alpha_0[k][0]) +
            F32(alpha_0[k][1] * alpha_0[k][1])) >= F32(16.0) or
            F32(F32(alpha_1[k][0] * alpha_1[k][0]) +
                F32(alpha_1[k][1] * alpha_1[k][1])) >= F32(16.0)):
        alpha_0[k] = (F32(0), F32(0))
        alpha_1[k] = (F32(0), F32(0))


def _map_new_bw(invf_mode, invf_mode_prev):
    if invf_mode == 1:
        return F32(0.6) if invf_mode_prev == 0 else F32(0.75)
    if invf_mode == 2:
        return F32(0.9)
    if invf_mode == 3:
        return F32(0.98)
    return F32(0.6) if invf_mode_prev == 1 else F32(0.0)


def _calc_chirp_factors(sbr, ch):
    for i in range(sbr.N_Q):
        bw = _map_new_bw(int(sbr.bs_invf_mode[ch][i]),
                         int(sbr.bs_invf_mode_prev[ch][i]))
        if bw < sbr.bwArray_prev[ch][i]:
            bw = F32(F32(bw * F32(0.75)) +
                     F32(sbr.bwArray_prev[ch][i] * F32(0.25)))
        else:
            bw = F32(F32(bw * F32(0.90625)) +
                     F32(sbr.bwArray_prev[ch][i] * F32(0.09375)))
        if bw < F32(0.015625):
            bw = F32(0.0)
        if bw >= F32(0.99609375):
            bw = F32(0.99609375)
        sbr.bwArray[ch][i] = bw
        sbr.bwArray_prev[ch][i] = bw
        sbr.bs_invf_mode_prev[ch][i] = sbr.bs_invf_mode[ch][i]


def _patch_construction(sbr):
    msb = sbr.k0
    usb = sbr.kx
    goal_sb = int(T.GOAL_SB_TAB[get_sr_index(sbr.sample_rate)])
    sbr.noPatches = 0
    if goal_sb < sbr.kx + sbr.M:
        k = 0
        i = 0
        while sbr.f_master[i] < goal_sb:
            k = i + 1
            i += 1
    else:
        k = sbr.N_master
    if sbr.N_master == 0:
        sbr.noPatches = 0
        sbr.patchNoSubbands[0] = 0
        sbr.patchStartSubband[0] = 0
        return
    while True:
        j = k + 1
        while True:
            j -= 1
            sb = int(sbr.f_master[j])
            odd = (sb - 2 + sbr.k0) % 2
            if sb <= sbr.k0 - 1 + msb - odd:
                break
        sbr.patchNoSubbands[sbr.noPatches] = max(sb - usb, 0)
        sbr.patchStartSubband[sbr.noPatches] = sbr.k0 - odd - \
            sbr.patchNoSubbands[sbr.noPatches]
        if sbr.patchNoSubbands[sbr.noPatches] > 0:
            usb = sb
            msb = sb
            sbr.noPatches += 1
        else:
            msb = sbr.kx
        if sbr.f_master[k] - sb < 3:
            k = sbr.N_master
        if sb == sbr.kx + sbr.M:
            break
    if sbr.noPatches > 1 and \
            sbr.patchNoSubbands[sbr.noPatches - 1] < 3:
        sbr.noPatches -= 1
    sbr.noPatches = min(sbr.noPatches, 5)


def hf_generation(sbr, Xlow, Xhigh, ch):
    """hf_generation (sbr_hfgen.c:54-185)."""
    offset = sbr.tHFAdj
    first = int(sbr.t_E[ch][0])
    last = int(sbr.t_E[ch][sbr.L_E[ch]])
    _calc_chirp_factors(sbr, ch)
    if ch == 0 and sbr.Reset:
        _patch_construction(sbr)
    alpha_0 = {}
    alpha_1 = {}
    for i in range(sbr.noPatches):
        for x in range(int(sbr.patchNoSubbands[i])):
            k = sbr.kx + x
            for q in range(i):
                k += int(sbr.patchNoSubbands[q])
            p = int(sbr.patchStartSubband[i]) + x
            g = int(sbr.table_map_k_to_g[k])
            bw = sbr.bwArray[ch][g]
            bw2 = F32(bw * bw)
            if bw2 > 0:
                _calc_prediction_coef(sbr, Xlow, alpha_0, alpha_1, p)
                a0r = F32(alpha_0[p][0] * bw)
                a1r = F32(alpha_1[p][0] * bw2)
                a0i = F32(alpha_0[p][1] * bw)
                a1i = F32(alpha_1[p][1] * bw2)
                t2r = Xlow[first - 2 + offset, p, 0]
                t3r = Xlow[first - 1 + offset, p, 0]
                t2i = Xlow[first - 2 + offset, p, 1]
                t3i = Xlow[first - 1 + offset, p, 1]
                for l in range(first, last):
                    t1r, t1i = t2r, t2i
                    t2r, t2i = t3r, t3i
                    t3r = Xlow[l + offset, p, 0]
                    t3i = Xlow[l + offset, p, 1]
                    Xhigh[l + offset, k, 0] = F32(
                        t3r + F32(F32(F32(a0r * t2r) - F32(a0i * t2i)) +
                                  F32(a1r * t1r) - F32(a1i * t1i)))
                    Xhigh[l + offset, k, 1] = F32(
                        t3i + F32(F32(F32(a0i * t2r) + F32(a0r * t2i)) +
                                  F32(a1i * t1r) + F32(a1r * t1i)))
            else:
                for l in range(first, last):
                    Xhigh[l + offset, k, 0] = Xlow[l + offset, p, 0]
                    Xhigh[l + offset, k, 1] = Xlow[l + offset, p, 1]
    if sbr.Reset:
        limiter_frequency_table(sbr)


# --------------------------------------------------------------------------
# HF adjustment (sbr_hfadj.c, high-quality float path)
# --------------------------------------------------------------------------

def _get_s_mapped(sbr, ch, l, current_band):
    if sbr.f[ch][l] == HI_RES:
        if l >= sbr.l_A[ch] or \
                (sbr.bs_add_harmonic_prev[ch][current_band] and
                 sbr.bs_add_harmonic_flag_prev[ch]):
            return int(sbr.bs_add_harmonic[ch][current_band])
    else:
        odd = 1 if (sbr.N_high & 1) else 0
        lb = 2 * current_band - odd
        ub = 2 * (current_band + 1) - odd
        for b in range(lb, ub):
            if l >= sbr.l_A[ch] or \
                    (sbr.bs_add_harmonic_prev[ch][b] and
                     sbr.bs_add_harmonic_flag_prev[ch]):
                if sbr.bs_add_harmonic[ch][b] == 1:
                    return 1
    return 0


def _estimate_current_envelope(sbr, Xsbr, ch):
    """estimate_current_envelope (float, both interpol modes).

    The inner energy sums are vectorized: C accumulates
    re*re [+ im*im] left-to-right over time (and freq) — float32 sums
    in that same order, done with an explicit loop to keep association.
    """
    if sbr.bs_interpol_freq == 1:
        for l in range(sbr.L_E[ch]):
            l_i = int(sbr.t_E[ch][l])
            u_i = int(sbr.t_E[ch][l + 1])
            div = F32(u_i - l_i)
            if div == 0:
                div = F32(1)
            for m in range(sbr.M):
                nrg = F32(0)
                for i in range(l_i + sbr.tHFAdj, u_i + sbr.tHFAdj):
                    nrg = F32(nrg + F32(
                        F32(Xsbr[i, m + sbr.kx, 0] *
                            Xsbr[i, m + sbr.kx, 0]) +
                        F32(Xsbr[i, m + sbr.kx, 1] *
                            Xsbr[i, m + sbr.kx, 1])))
                sbr.E_curr[ch][m][l] = F32(nrg / div)
    else:
        for l in range(sbr.L_E[ch]):
            for p in range(int(sbr.n[sbr.f[ch][l]])):
                k_l = int(sbr.f_table_res[sbr.f[ch][l]][p])
                k_h = int(sbr.f_table_res[sbr.f[ch][l]][p + 1])
                for k in range(k_l, k_h):
                    l_i = int(sbr.t_E[ch][l])
                    u_i = int(sbr.t_E[ch][l + 1])
                    div = F32((u_i - l_i) * (k_h - k_l))
                    if div == 0:
                        div = F32(1)
                    nrg = F32(0)
                    for i in range(l_i + sbr.tHFAdj, u_i + sbr.tHFAdj):
                        for j in range(k_l, k_h):
                            nrg = F32(nrg + F32(
                                F32(Xsbr[i, j, 0] * Xsbr[i, j, 0]) +
                                F32(Xsbr[i, j, 1] * Xsbr[i, j, 1])))
                    sbr.E_curr[ch][k - sbr.kx][l] = F32(nrg / div)
    return 0


def _calculate_gain(sbr, adj, ch):
    """calculate_gain (sbr_hfadj.c:1154-1352, plain float path)."""
    lim_gain = T.LIM_GAIN
    current_t_noise_band = 0
    for l in range(sbr.L_E[ch]):
        current_f_noise_band = 0
        current_res_band = 0
        current_res_band2 = 0
        current_hi_res_band = 0
        delta = 0 if (l == sbr.l_A[ch] or
                      l == sbr.prevEnvIsShort[ch]) else 1
        S_mapped = _get_s_mapped(sbr, ch, l, current_res_band2)
        if sbr.t_E[ch][l + 1] > sbr.t_Q[ch][current_t_noise_band + 1]:
            current_t_noise_band += 1
        Q_M_lim = np.zeros(MAX_M, F32)
        G_lim = np.zeros(MAX_M, F32)
        S_M = np.zeros(MAX_M, F32)
        for k in range(int(sbr.N_L[sbr.bs_limiter_bands])):
            den = np.float64(0)
            acc1 = np.float64(0)
            acc2 = np.float64(0)
            ml1 = int(sbr.f_table_lim[sbr.bs_limiter_bands][k])
            ml2 = int(sbr.f_table_lim[sbr.bs_limiter_bands][k + 1])
            for m in range(ml1, ml2):
                if (m + sbr.kx) == \
                        sbr.f_table_res[sbr.f[ch][l]][current_res_band
                                                      + 1]:
                    current_res_band += 1
                acc1 = F32(acc1 + sbr.E_orig[ch][current_res_band][l])
                acc2 = F32(acc2 + sbr.E_curr[ch][m][l])
            # C computes in double, assigns to float, THEN clamps
            g_max_d = (EPS + float(acc1)) / (EPS + float(acc2)) * \
                float(lim_gain[sbr.bs_limiter_gains])
            G_max = F32(g_max_d)
            if float(G_max) > 1e10:
                G_max = F32(1e10)
            den = F32(0)
            for m in range(ml1, ml2):
                if (m + sbr.kx) == \
                        sbr.f_table_noise[current_f_noise_band + 1]:
                    current_f_noise_band += 1
                if (m + sbr.kx) == \
                        sbr.f_table_res[sbr.f[ch][l]][current_res_band2
                                                      + 1]:
                    current_res_band2 += 1
                    S_mapped = _get_s_mapped(sbr, ch, l,
                                             current_res_band2)
                if (m + sbr.kx) == \
                        sbr.f_table_res[HI_RES][current_hi_res_band + 1]:
                    current_hi_res_band += 1
                S_index_mapped = 0
                if l >= sbr.l_A[ch] or \
                        (sbr.bs_add_harmonic_prev[ch][current_hi_res_band]
                         and sbr.bs_add_harmonic_flag_prev[ch]):
                    if (m + sbr.kx) == (
                            int(sbr.f_table_res[HI_RES][
                                current_hi_res_band + 1]) +
                            int(sbr.f_table_res[HI_RES][
                                current_hi_res_band])) >> 1:
                        S_index_mapped = \
                            int(sbr.bs_add_harmonic[ch][
                                current_hi_res_band])
                Q_div = sbr.Q_div[ch][current_f_noise_band][
                    current_t_noise_band]
                Q_div2 = sbr.Q_div2[ch][current_f_noise_band][
                    current_t_noise_band]
                Q_M = F32(sbr.E_orig[ch][current_res_band2][l] * Q_div2)
                if S_index_mapped == 0:
                    S_M[m] = 0
                else:
                    S_M[m] = F32(sbr.E_orig[ch][current_res_band2][l] *
                                 Q_div)
                    den = F32(den + S_M[m])
                # gain: the whole division happens in double
                # (1.0 promotes), then rounds to float once
                G = F32(float(sbr.E_orig[ch][current_res_band2][l]) /
                        (1.0 + float(sbr.E_curr[ch][m][l])))
                if S_mapped == 0 and delta == 1:
                    G = F32(G * Q_div)
                elif S_mapped == 1:
                    G = F32(G * Q_div2)
                if G_max > G:
                    Q_M_lim[m] = Q_M
                    G_lim[m] = G
                else:
                    Q_M_lim[m] = F32(F32(Q_M * G_max) / G)
                    G_lim[m] = G_max
                den = F32(den + F32(sbr.E_curr[ch][m][l] * G_lim[m]))
                if S_index_mapped == 0 and l != sbr.l_A[ch]:
                    den = F32(den + Q_M_lim[m])
            g_boost_d = (float(acc1) + EPS) / (float(den) + EPS)
            G_boost = F32(g_boost_d)
            if float(G_boost) > 2.51188643:
                G_boost = F32(2.51188643)
            for m in range(ml1, ml2):
                adj.G_lim_boost[l][m] = F32(
                    np.sqrt(np.float64(F32(G_lim[m] * G_boost))))
                adj.Q_M_lim_boost[l][m] = F32(
                    np.sqrt(np.float64(F32(Q_M_lim[m] * G_boost))))
                if S_M[m] != 0:
                    adj.S_M_boost[l][m] = F32(
                        np.sqrt(np.float64(F32(S_M[m] * G_boost))))
                else:
                    adj.S_M_boost[l][m] = 0


class _HfAdjInfo:
    def __init__(self):
        self.G_lim_boost = np.zeros((MAX_L_E, MAX_M), F32)
        self.Q_M_lim_boost = np.zeros((MAX_L_E, MAX_M), F32)
        self.S_M_boost = np.zeros((MAX_L_E, MAX_M), F32)


_PHI_RE = (1, 0, -1, 0)
_PHI_IM = (0, 1, 0, -1)


def _hf_assembly(sbr, adj, Xsbr, ch):
    """hf_assembly (sbr_hfadj.c:1515-1739, HQ float)."""
    h_smooth = T.H_SMOOTH
    if sbr.Reset == 1:
        assembly_reset = 1
        f_index_noise = 0
    else:
        assembly_reset = 0
        f_index_noise = sbr.index_noise_prev[ch]
    f_index_sine = sbr.psi_is_prev[ch]

    for l in range(sbr.L_E[ch]):
        no_noise = 1 if (l == sbr.l_A[ch] or
                         l == sbr.prevEnvIsShort[ch]) else 0
        h_SL = 0 if sbr.bs_smoothing_mode == 1 else 4
        h_SL = 0 if no_noise else h_SL
        if assembly_reset:
            for n in range(4):
                sbr.G_temp_prev[ch][n][:sbr.M] = adj.G_lim_boost[l][:sbr.M]
                sbr.Q_temp_prev[ch][n][:sbr.M] = \
                    adj.Q_M_lim_boost[l][:sbr.M]
            sbr.GQ_ringbuf_index[ch] = 4
            assembly_reset = 0
        for i in range(int(sbr.t_E[ch][l]), int(sbr.t_E[ch][l + 1])):
            ri0 = sbr.GQ_ringbuf_index[ch]
            sbr.G_temp_prev[ch][ri0][:sbr.M] = adj.G_lim_boost[l][:sbr.M]
            sbr.Q_temp_prev[ch][ri0][:sbr.M] = \
                adj.Q_M_lim_boost[l][:sbr.M]
            for m in range(sbr.M):
                if h_SL != 0:
                    G_filt = F32(0)
                    Q_filt = F32(0)
                    ri = ri0
                    for n in range(5):
                        ri += 1
                        if ri >= 5:
                            ri -= 5
                        G_filt = F32(G_filt +
                                     F32(sbr.G_temp_prev[ch][ri][m] *
                                         h_smooth[n]))
                        Q_filt = F32(Q_filt +
                                     F32(sbr.Q_temp_prev[ch][ri][m] *
                                         h_smooth[n]))
                else:
                    G_filt = sbr.G_temp_prev[ch][ri0][m]
                    Q_filt = sbr.Q_temp_prev[ch][ri0][m]
                if adj.S_M_boost[l][m] != 0 or no_noise:
                    Q_filt = F32(0)
                f_index_noise = (f_index_noise + 1) & 511
                t = i + sbr.tHFAdj
                mk = m + sbr.kx
                Xsbr[t, mk, 0] = F32(
                    F32(G_filt * Xsbr[t, mk, 0]) +
                    F32(Q_filt * T.V_NOISE[f_index_noise][0]))
                Xsbr[t, mk, 1] = F32(
                    F32(G_filt * Xsbr[t, mk, 1]) +
                    F32(Q_filt * T.V_NOISE[f_index_noise][1]))
                if sbr.bs_extension_id == 3 and \
                        sbr.bs_extension_data == 42:
                    Xsbr[t, mk, 0] = F32(16428320)
                rev = -1 if ((m + sbr.kx) & 1) else 1
                psi_re = F32(adj.S_M_boost[l][m] *
                             _PHI_RE[f_index_sine])
                Xsbr[t, mk, 0] = F32(Xsbr[t, mk, 0] + psi_re)
                psi_im = F32(rev * F32(adj.S_M_boost[l][m] *
                                       _PHI_IM[f_index_sine]))
                Xsbr[t, mk, 1] = F32(Xsbr[t, mk, 1] + psi_im)
            f_index_sine = (f_index_sine + 1) & 3
            sbr.GQ_ringbuf_index[ch] += 1
            if sbr.GQ_ringbuf_index[ch] >= 5:
                sbr.GQ_ringbuf_index[ch] = 0
    sbr.index_noise_prev[ch] = f_index_noise
    sbr.psi_is_prev[ch] = f_index_sine


def hf_adjustment(sbr, Xsbr, ch):
    """hf_adjustment (sbr_hfadj.c:55-93)."""
    adj = _HfAdjInfo()
    if sbr.bs_frame_class[ch] == FIXFIX:
        sbr.l_A[ch] = -1
    elif sbr.bs_frame_class[ch] == VARFIX:
        if sbr.bs_pointer[ch] > 1:
            sbr.l_A[ch] = sbr.bs_pointer[ch] - 1
        else:
            sbr.l_A[ch] = -1
    else:
        if sbr.bs_pointer[ch] == 0:
            sbr.l_A[ch] = -1
        else:
            sbr.l_A[ch] = sbr.L_E[ch] + 1 - sbr.bs_pointer[ch]
    ret = _estimate_current_envelope(sbr, Xsbr, ch)
    if ret > 0:
        return 1
    _calculate_gain(sbr, adj, ch)
    _hf_assembly(sbr, adj, Xsbr, ch)
    return 0


# --------------------------------------------------------------------------
# bitstream syntax (sbr_syntax.c)
# --------------------------------------------------------------------------

_LOG2_TAB = [0, 0, 1, 2, 2, 3, 3, 3, 3, 4]


def _sbr_log2(val):
    return _LOG2_TAB[val] if 0 <= val < 10 else 0


def _sbr_reset_check(sbr):
    if (sbr.bs_start_freq != sbr.bs_start_freq_prev or
            sbr.bs_stop_freq != sbr.bs_stop_freq_prev or
            sbr.bs_freq_scale != sbr.bs_freq_scale_prev or
            sbr.bs_alter_scale != sbr.bs_alter_scale_prev or
            sbr.bs_xover_band != sbr.bs_xover_band_prev or
            sbr.bs_noise_bands != sbr.bs_noise_bands_prev):
        sbr.Reset = 1
    else:
        sbr.Reset = 0
    sbr.bs_start_freq_prev = sbr.bs_start_freq
    sbr.bs_stop_freq_prev = sbr.bs_stop_freq
    sbr.bs_freq_scale_prev = sbr.bs_freq_scale
    sbr.bs_alter_scale_prev = sbr.bs_alter_scale
    sbr.bs_xover_band_prev = sbr.bs_xover_band
    sbr.bs_noise_bands_prev = sbr.bs_noise_bands


def calc_sbr_tables(sbr, start_freq, stop_freq, samplerate_mode,
                    freq_scale, alter_scale, xover_band):
    result = 0
    sbr.k0 = qmf_start_channel(start_freq, samplerate_mode,
                               sbr.sample_rate)
    k2 = qmf_stop_channel(stop_freq, sbr.sample_rate, sbr.k0)
    if sbr.sample_rate >= 48000:
        if k2 - sbr.k0 > 32:
            result += 1
    elif sbr.sample_rate <= 32000:
        if k2 - sbr.k0 > 48:
            result += 1
    else:
        if k2 - sbr.k0 > 45:
            result += 1
    if freq_scale == 0:
        result += master_frequency_table_fs0(sbr, sbr.k0, k2, alter_scale)
    else:
        result += master_frequency_table(sbr, sbr.k0, k2, freq_scale,
                                         alter_scale)
    result += derived_frequency_table(sbr, xover_band, k2)
    return 1 if result > 0 else 0


def _sbr_header(ld, sbr):
    sbr.header_count += 1
    sbr.bs_amp_res = ld.get1()
    sbr.bs_start_freq = ld.get(4)
    sbr.bs_stop_freq = ld.get(4)
    sbr.bs_xover_band = ld.get(3)
    ld.get(2)
    extra_1 = ld.get1()
    extra_2 = ld.get1()
    if extra_1:
        sbr.bs_freq_scale = ld.get(2)
        sbr.bs_alter_scale = ld.get1()
        sbr.bs_noise_bands = ld.get(2)
    else:
        sbr.bs_freq_scale = 2
        sbr.bs_alter_scale = 1
        sbr.bs_noise_bands = 2
    if extra_2:
        sbr.bs_limiter_bands = ld.get(2)
        sbr.bs_limiter_gains = ld.get(2)
        sbr.bs_interpol_freq = ld.get1()
        sbr.bs_smoothing_mode = ld.get1()
    else:
        sbr.bs_limiter_bands = 2
        sbr.bs_limiter_gains = 2
        sbr.bs_interpol_freq = 1
        sbr.bs_smoothing_mode = 1


def _sbr_grid(ld, sbr, ch):
    saved_L_E = sbr.L_E[ch]
    saved_L_Q = sbr.L_Q[ch]
    saved_frame_class = sbr.bs_frame_class[ch]
    sbr.bs_frame_class[ch] = ld.get(2)
    fc = sbr.bs_frame_class[ch]
    bs_num_env = 0
    if fc == FIXFIX:
        i = ld.get(2)
        bs_num_env = min(1 << i, 5)
        i = ld.get1()
        for env in range(bs_num_env):
            sbr.f[ch][env] = i
        sbr.abs_bord_lead[ch] = 0
        sbr.abs_bord_trail[ch] = sbr.numTimeSlots
        sbr.n_rel_lead[ch] = bs_num_env - 1
        sbr.n_rel_trail[ch] = 0
    elif fc == FIXVAR:
        bs_abs_bord = ld.get(2) + sbr.numTimeSlots
        bs_num_env = ld.get(2) + 1
        for rel in range(bs_num_env - 1):
            sbr.bs_rel_bord[ch][rel] = 2 * ld.get(2) + 2
        i = _sbr_log2(bs_num_env + 1)
        sbr.bs_pointer[ch] = ld.get(i)
        for env in range(bs_num_env):
            sbr.f[ch][bs_num_env - env - 1] = ld.get1()
        sbr.abs_bord_lead[ch] = 0
        sbr.abs_bord_trail[ch] = bs_abs_bord
        sbr.n_rel_lead[ch] = 0
        sbr.n_rel_trail[ch] = bs_num_env - 1
    elif fc == VARFIX:
        bs_abs_bord = ld.get(2)
        bs_num_env = ld.get(2) + 1
        for rel in range(bs_num_env - 1):
            sbr.bs_rel_bord[ch][rel] = 2 * ld.get(2) + 2
        i = _sbr_log2(bs_num_env + 1)
        sbr.bs_pointer[ch] = ld.get(i)
        for env in range(bs_num_env):
            sbr.f[ch][env] = ld.get1()
        sbr.abs_bord_lead[ch] = bs_abs_bord
        sbr.abs_bord_trail[ch] = sbr.numTimeSlots
        sbr.n_rel_lead[ch] = bs_num_env - 1
        sbr.n_rel_trail[ch] = 0
    else:  # VARVAR
        bs_abs_bord = ld.get(2)
        bs_abs_bord_1 = ld.get(2) + sbr.numTimeSlots
        sbr.bs_num_rel_0[ch] = ld.get(2)
        sbr.bs_num_rel_1[ch] = ld.get(2)
        bs_num_env = min(5, sbr.bs_num_rel_0[ch] +
                         sbr.bs_num_rel_1[ch] + 1)
        for rel in range(sbr.bs_num_rel_0[ch]):
            sbr.bs_rel_bord_0[ch][rel] = 2 * ld.get(2) + 2
        for rel in range(sbr.bs_num_rel_1[ch]):
            sbr.bs_rel_bord_1[ch][rel] = 2 * ld.get(2) + 2
        i = _sbr_log2(sbr.bs_num_rel_0[ch] + sbr.bs_num_rel_1[ch] + 2)
        sbr.bs_pointer[ch] = ld.get(i)
        for env in range(bs_num_env):
            sbr.f[ch][env] = ld.get1()
        sbr.abs_bord_lead[ch] = bs_abs_bord
        sbr.abs_bord_trail[ch] = bs_abs_bord_1
        sbr.n_rel_lead[ch] = sbr.bs_num_rel_0[ch]
        sbr.n_rel_trail[ch] = sbr.bs_num_rel_1[ch]

    if fc == VARVAR:
        sbr.L_E[ch] = min(bs_num_env, 5)
    else:
        sbr.L_E[ch] = min(bs_num_env, 4)
    if sbr.L_E[ch] <= 0:
        return 1
    sbr.L_Q[ch] = 2 if sbr.L_E[ch] > 1 else 1
    result = envelope_time_border_vector(sbr, ch)
    if result > 0:
        sbr.bs_frame_class[ch] = saved_frame_class
        sbr.L_E[ch] = saved_L_E
        sbr.L_Q[ch] = saved_L_Q
        return result
    noise_floor_time_border_vector(sbr, ch)
    return 0


def _sbr_dtdf(ld, sbr, ch):
    for i in range(sbr.L_E[ch]):
        sbr.bs_df_env[ch][i] = ld.get1()
    for i in range(sbr.L_Q[ch]):
        sbr.bs_df_noise[ch][i] = ld.get1()


def _invf_mode(ld, sbr, ch):
    for n in range(sbr.N_Q):
        sbr.bs_invf_mode[ch][n] = ld.get(2)


def _sinusoidal_coding(ld, sbr, ch):
    for n in range(sbr.N_high):
        sbr.bs_add_harmonic[ch][n] = ld.get1()


def _sbr_extension(ld, sbr, bs_extension_id, num_bits_left):
    """sbr_extension (sbr_syntax.c:847-880): PS or default skip."""
    if bs_extension_id == 2:  # EXTENSION_ID_PS
        from wmix_tpu_torch.codecs import ps as ps_mod
        if sbr.ps is None:
            sbr.ps = ps_mod.PsInfo(get_sr_index(sbr.sample_rate),
                                   sbr.numTimeSlotsRate)
        if sbr.psResetFlag:
            sbr.ps.header_read = 0
        ret, header = ps_mod.ps_data(sbr.ps, ld)
        if sbr.ps_used == 0 and header == 1:
            sbr.ps_used = 1
        if header == 1:
            sbr.psResetFlag = 0
        return ret
    sbr.bs_extension_data = ld.get(6)
    return 6


def _sbr_single_channel_element(ld, sbr):
    if ld.get1():
        ld.get(4)
    result = _sbr_grid(ld, sbr, 0)
    if result > 0:
        return result
    _sbr_dtdf(ld, sbr, 0)
    _invf_mode(ld, sbr, 0)
    sbr_envelope(ld, sbr, 0)
    sbr_noise(ld, sbr, 0)
    envelope_noise_dequantisation(sbr, 0)
    sbr.bs_add_harmonic[0][:] = 0
    sbr.bs_add_harmonic_flag[0] = ld.get1()
    if sbr.bs_add_harmonic_flag[0]:
        _sinusoidal_coding(ld, sbr, 0)
    sbr.bs_extended_data = ld.get1()
    if sbr.bs_extended_data:
        cnt = ld.get(4)
        if cnt == 15:
            cnt += ld.get(8)
        nr_bits_left = 8 * cnt
        ps_ext_read = 0
        while nr_bits_left > 7:
            tmp_nr_bits = 2
            sbr.bs_extension_id = ld.get(2)
            if sbr.bs_extension_id == 2:  # EXTENSION_ID_PS
                if ps_ext_read == 0:
                    ps_ext_read = 1
                else:
                    sbr.bs_extension_id = 3
            tmp_nr_bits += _sbr_extension(ld, sbr, sbr.bs_extension_id,
                                          nr_bits_left)
            if tmp_nr_bits > nr_bits_left:
                return 1
            nr_bits_left -= tmp_nr_bits
        if nr_bits_left > 0:
            ld.get(nr_bits_left)
    return 0


def _sbr_channel_pair_element(ld, sbr):
    if ld.get1():
        ld.get(4)
        ld.get(4)
    sbr.bs_coupling = ld.get1()
    if sbr.bs_coupling:
        result = _sbr_grid(ld, sbr, 0)
        if result > 0:
            return result
        sbr.bs_frame_class[1] = sbr.bs_frame_class[0]
        sbr.L_E[1] = sbr.L_E[0]
        sbr.L_Q[1] = sbr.L_Q[0]
        sbr.bs_pointer[1] = sbr.bs_pointer[0]
        for n in range(sbr.L_E[0] + 1):
            sbr.t_E[1][n] = sbr.t_E[0][n]
            sbr.f[1][n] = sbr.f[0][n]
        for n in range(sbr.L_Q[0] + 1):
            sbr.t_Q[1][n] = sbr.t_Q[0][n]
        _sbr_dtdf(ld, sbr, 0)
        _sbr_dtdf(ld, sbr, 1)
        _invf_mode(ld, sbr, 0)
        for n in range(sbr.N_Q):
            sbr.bs_invf_mode[1][n] = sbr.bs_invf_mode[0][n]
        sbr_envelope(ld, sbr, 0)
        sbr_noise(ld, sbr, 0)
        sbr_envelope(ld, sbr, 1)
        sbr_noise(ld, sbr, 1)
        sbr.bs_add_harmonic[0][:] = 0
        sbr.bs_add_harmonic[1][:] = 0
        sbr.bs_add_harmonic_flag[0] = ld.get1()
        if sbr.bs_add_harmonic_flag[0]:
            _sinusoidal_coding(ld, sbr, 0)
        sbr.bs_add_harmonic_flag[1] = ld.get1()
        if sbr.bs_add_harmonic_flag[1]:
            _sinusoidal_coding(ld, sbr, 1)
    else:
        saved_t_E = [int(v) for v in sbr.t_E[0][:6]]
        saved_t_Q = [int(v) for v in sbr.t_Q[0][:3]]
        saved_L_E = sbr.L_E[0]
        saved_L_Q = sbr.L_Q[0]
        saved_frame_class = sbr.bs_frame_class[0]
        result = _sbr_grid(ld, sbr, 0)
        if result > 0:
            return result
        result = _sbr_grid(ld, sbr, 1)
        if result > 0:
            sbr.bs_frame_class[0] = saved_frame_class
            sbr.L_E[0] = saved_L_E
            sbr.L_Q[0] = saved_L_Q
            sbr.t_E[0][:6] = saved_t_E
            sbr.t_Q[0][:3] = saved_t_Q
            return result
        _sbr_dtdf(ld, sbr, 0)
        _sbr_dtdf(ld, sbr, 1)
        _invf_mode(ld, sbr, 0)
        _invf_mode(ld, sbr, 1)
        sbr_envelope(ld, sbr, 0)
        sbr_envelope(ld, sbr, 1)
        sbr_noise(ld, sbr, 0)
        sbr_noise(ld, sbr, 1)
        sbr.bs_add_harmonic[0][:] = 0
        sbr.bs_add_harmonic[1][:] = 0
        sbr.bs_add_harmonic_flag[0] = ld.get1()
        if sbr.bs_add_harmonic_flag[0]:
            _sinusoidal_coding(ld, sbr, 0)
        sbr.bs_add_harmonic_flag[1] = ld.get1()
        if sbr.bs_add_harmonic_flag[1]:
            _sinusoidal_coding(ld, sbr, 1)
    envelope_noise_dequantisation(sbr, 0)
    envelope_noise_dequantisation(sbr, 1)
    if sbr.bs_coupling:
        unmap_envelope_noise(sbr)
    sbr.bs_extended_data = ld.get1()
    if sbr.bs_extended_data:
        cnt = ld.get(4)
        if cnt == 15:
            cnt += ld.get(8)
        nr_bits_left = 8 * cnt
        while nr_bits_left > 7:
            tmp_nr_bits = 2
            sbr.bs_extension_id = ld.get(2)
            tmp_nr_bits += _sbr_extension(ld, sbr, sbr.bs_extension_id,
                                          nr_bits_left)
            if tmp_nr_bits > nr_bits_left:
                return 1
            nr_bits_left -= tmp_nr_bits
        if nr_bits_left > 0:
            ld.get(nr_bits_left)
    return 0


def _sbr_data(ld, sbr):
    sbr.rate = 2 if sbr.bs_samplerate_mode else 1
    if sbr.id_aac == ID_SCE:
        return _sbr_single_channel_element(ld, sbr)
    if sbr.id_aac == ID_CPE:
        return _sbr_channel_pair_element(ld, sbr)
    return 0


def sbr_extension_data(ld, sbr, cnt, ps_reset_flag):
    """sbr_extension_data (sbr_syntax.c:137-261)."""
    result = 0
    num_sbr_bits1 = ld.processed()
    if ps_reset_flag:
        sbr.psResetFlag = ps_reset_flag
    bs_extension_type = ld.get(4)
    if bs_extension_type == EXT_SBR_DATA_CRC:
        sbr.bs_sbr_crc_bits = ld.get(10)
    saved = (sbr.bs_start_freq, sbr.bs_samplerate_mode, sbr.bs_stop_freq,
             sbr.bs_freq_scale, sbr.bs_alter_scale, sbr.bs_xover_band)
    sbr.bs_header_flag = ld.get1()
    if sbr.bs_header_flag:
        _sbr_header(ld, sbr)
    _sbr_reset_check(sbr)
    if sbr.header_count != 0:
        if sbr.Reset or (sbr.bs_header_flag and sbr.just_seeked):
            rt = calc_sbr_tables(sbr, sbr.bs_start_freq,
                                 sbr.bs_stop_freq,
                                 sbr.bs_samplerate_mode,
                                 sbr.bs_freq_scale, sbr.bs_alter_scale,
                                 sbr.bs_xover_band)
            if rt > 0:
                calc_sbr_tables(sbr, saved[0], saved[2], saved[1],
                                saved[3], saved[4], saved[5])
        if result == 0:
            result = _sbr_data(ld, sbr)
            if result > 0 and (sbr.Reset or
                               (sbr.bs_header_flag and sbr.just_seeked)):
                calc_sbr_tables(sbr, saved[0], saved[2], saved[1],
                                saved[3], saved[4], saved[5])
    else:
        result = 1
    num_sbr_bits2 = ld.processed() - num_sbr_bits1
    if 8 * cnt < num_sbr_bits2:
        ld.pos = num_sbr_bits1 + 8 * cnt  # faad_resetbits
        sbr.ps_used = 0
        return 1
    num_align_bits = 8 * cnt - num_sbr_bits2
    while num_align_bits > 7:
        ld.get(8)
        num_align_bits -= 8
    ld.get(num_align_bits)
    return result


# --------------------------------------------------------------------------
# frame drivers (sbr_dec.c:246-690)
# --------------------------------------------------------------------------

def _sbr_save_prev_data(sbr, ch):
    sbr.kx_prev = sbr.kx
    sbr.M_prev = sbr.M
    sbr.bsco_prev = sbr.bsco
    sbr.L_E_prev[ch] = sbr.L_E[ch]
    if sbr.L_E[ch] <= 0:
        return 19
    sbr.f_prev[ch] = int(sbr.f[ch][sbr.L_E[ch] - 1])
    for i in range(MAX_M):
        sbr.E_prev[ch][i] = sbr.E[ch][i][sbr.L_E[ch] - 1]
        sbr.Q_prev[ch][i] = sbr.Q[ch][i][sbr.L_Q[ch] - 1]
    sbr.bs_add_harmonic_prev[ch][:] = sbr.bs_add_harmonic[ch]
    sbr.bs_add_harmonic_flag_prev[ch] = sbr.bs_add_harmonic_flag[ch]
    if sbr.l_A[ch] == sbr.L_E[ch]:
        sbr.prevEnvIsShort[ch] = 0
    else:
        sbr.prevEnvIsShort[ch] = -1
    return 0


def _sbr_save_matrix(sbr, ch):
    for i in range(sbr.tHFGen):
        sbr.Xsbr[ch][i] = sbr.Xsbr[ch][i + sbr.numTimeSlotsRate]
    sbr.Xsbr[ch][sbr.tHFGen:MAX_NTSRHFG] = 0


def _sbr_process_channel(sbr, channel_buf, X, ch, dont_process):
    """sbr_process_channel (sbr_dec.c:297-446); X[MAX_NTSR][64][2]."""
    ret = 0
    sbr.bsco = 0
    if dont_process:
        sbr.qmfa[ch].analysis(sbr, channel_buf, sbr.Xsbr[ch],
                              sbr.tHFGen, 32)
    else:
        sbr.qmfa[ch].analysis(sbr, channel_buf, sbr.Xsbr[ch],
                              sbr.tHFGen, sbr.kx)
    if not dont_process:
        hf_generation(sbr, sbr.Xsbr[ch], sbr.Xsbr[ch], ch)
        ret = hf_adjustment(sbr, sbr.Xsbr[ch], ch)
        if ret > 0:
            dont_process = 1
    if sbr.just_seeked != 0 or dont_process:
        for l in range(sbr.numTimeSlotsRate):
            X[l, :32] = sbr.Xsbr[ch][l + sbr.tHFAdj, :32]
            X[l, 32:] = 0
    else:
        for l in range(sbr.numTimeSlotsRate):
            if l < sbr.t_E[ch][0]:
                kx_band = sbr.kx_prev
                M_band = sbr.M_prev
                bsco_band = sbr.bsco_prev
            else:
                kx_band = sbr.kx
                M_band = sbr.M
                bsco_band = sbr.bsco
            hi = kx_band + M_band
            X[l, :hi] = sbr.Xsbr[ch][l + sbr.tHFAdj, :hi]
            X[l, max(kx_band + bsco_band, hi):] = 0
    return ret


def sbr_decode_single_frame(sbr, channel, just_seeked=0):
    """sbrDecodeSingleFrame: channel float32[1024] in -> 2048 out."""
    dont_process = 0
    if sbr.ret or sbr.header_count == 0:
        dont_process = 1
        if sbr.ret and sbr.Reset:
            sbr.bs_start_freq_prev = -1
    sbr.just_seeked = 1 if just_seeked else 0
    X = np.zeros((MAX_NTSR, 64, 2), F32)
    sbr.ret += _sbr_process_channel(sbr, channel, X, 0, dont_process)
    out = sbr.qmfs[0].synthesis(sbr, X)
    if sbr.bs_header_flag:
        sbr.just_seeked = 0
    if sbr.header_count != 0 and sbr.ret == 0:
        ret = _sbr_save_prev_data(sbr, 0)
        if ret:
            return None, ret
    _sbr_save_matrix(sbr, 0)
    sbr.frame += 1
    return out, 0


def sbr_decode_single_frame_ps(sbr, channel, just_seeked=0):
    """sbrDecodeSingleFramePS: 1024 mono in -> (left, right) 2048."""
    from wmix_tpu_torch.codecs import ps as ps_mod
    dont_process = 0
    if sbr.ret or sbr.header_count == 0:
        dont_process = 1
        if sbr.ret and sbr.Reset:
            sbr.bs_start_freq_prev = -1
    sbr.just_seeked = 1 if just_seeked else 0
    X_left = np.zeros((38, 64, 2), F32)
    X_right = np.zeros((38, 64, 2), F32)
    sbr.ret += _sbr_process_channel(sbr, channel, X_left, 0,
                                    dont_process)
    # copy extra data for PS
    for l in range(sbr.numTimeSlotsRate, sbr.numTimeSlotsRate + 6):
        X_left[l, :5] = sbr.Xsbr[0][sbr.tHFAdj + l, :5]
    ps_mod.ps_decode(sbr.ps, X_left, X_right)
    left = sbr.qmfs[0].synthesis(sbr, X_left)
    if len(sbr.qmfs) < 2:
        sbr.qmfs.append(QmfSynthesis32() if sbr.downSampledSBR
                        else QmfSynthesis64())
    right = sbr.qmfs[1].synthesis(sbr, X_right)
    if sbr.bs_header_flag:
        sbr.just_seeked = 0
    if sbr.header_count != 0 and sbr.ret == 0:
        ret = _sbr_save_prev_data(sbr, 0)
        if ret:
            return None, None, ret
    _sbr_save_matrix(sbr, 0)
    sbr.frame += 1
    return left, right, 0


def sbr_decode_couple_frame(sbr, left_chan, right_chan, just_seeked=0):
    """sbrDecodeCoupleFrame (CPE)."""
    dont_process = 0
    if sbr.id_aac != ID_CPE:
        return None, None, 21
    if sbr.ret or sbr.header_count == 0:
        dont_process = 1
        if sbr.ret and sbr.Reset:
            sbr.bs_start_freq_prev = -1
    sbr.just_seeked = 1 if just_seeked else 0
    X = np.zeros((MAX_NTSR, 64, 2), F32)
    sbr.ret += _sbr_process_channel(sbr, left_chan, X, 0, dont_process)
    left = sbr.qmfs[0].synthesis(sbr, X)
    sbr.ret += _sbr_process_channel(sbr, right_chan, X, 1, dont_process)
    right = sbr.qmfs[1].synthesis(sbr, X)
    if sbr.bs_header_flag:
        sbr.just_seeked = 0
    if sbr.header_count != 0 and sbr.ret == 0:
        ret = _sbr_save_prev_data(sbr, 0)
        if ret:
            return None, None, ret
        ret = _sbr_save_prev_data(sbr, 1)
        if ret:
            return None, None, ret
    _sbr_save_matrix(sbr, 0)
    _sbr_save_matrix(sbr, 1)
    sbr.frame += 1
    return left, right, 0
