"""AAC-LC encoder: bit-exact rebuild of faac 1.29.9.2 as deployed by the
daemon (aac_encode, src/aacType.c:321-366: faacEncOpen
defaults + inputFormat=FAAC_INPUT_16BIT, ADTS output, 1024 samples per
channel per call).

Pipeline (frame.c faacEncEncode):
  int16 -> double -> 4-frame lookahead buffer -> psy (short-window MDCT
  energies, blockswitch.c) -> window switch -> MDCT filterbank
  (filtbank.c, sine windows) -> [TNS off by default] -> stereo
  (JOINT_IS intensity coding, stereo.c) -> band quality -> quantize
  (quantize.c bmask/qlevel) -> Huffman (huff2.c) -> ADTS bitstream
  (bitstream.c) -> per-frame quality adaptation toward bitRate=64000.

Bit-exactness notes: faac computes in C double; numpy float64 matches
elementwise.  The quantizer's rounding runs the __SSE2__ branch on the
x86 reference build (quantize.c qlevel: float32 lanes, truncation) — the
deployment targets的 plain-C double branch differs by LSBs; we mirror
the compiled oracle.  Order-sensitive reductions (band energies, FFT
butterflies) are folded in the reference's loop order.  Huffman code
tables and scalefactor-band widths come from _aacenc_tables.py
(generated from the compiled reference, oracle/gen_faac_tables.py).

Parity gate (tests/test_aacenc.py): byte-identical ADTS stream vs the
reference `aac_encode` on fixture PCM.
"""
from __future__ import annotations

import math

import numpy as np

from wmix_tpu_torch.codecs import _aacenc_tables as T

FRAME_LEN = 1024
BLOCK_LEN_LONG = 1024
BLOCK_LEN_SHORT = 128
NSFB_LONG = 51
NSFB_SHORT = 15
MAX_SHORT_WINDOWS = 8
NFLAT_LS = (BLOCK_LEN_LONG - BLOCK_LEN_SHORT) // 2

ONLY_LONG_WINDOW = 0
LONG_SHORT_WINDOW = 1
ONLY_SHORT_WINDOW = 2
SHORT_LONG_WINDOW = 3

HCB_ZERO = 0
HCB_ESC = 11
HCB_PNS = 13
HCB_INTENSITY2 = 14
HCB_INTENSITY = 15
HCB_NONE = 16

SF_OFFSET = 100
DEFQUAL = 100
MAXQUAL = 5000
MINQUAL = 10
MAGIC_NUMBER = 0.4054
NOISEFLOOR = 0.4
NOISETONE = 0.2

ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)

SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350]

_BOOKS = {1: T.BOOK01, 2: T.BOOK02, 3: T.BOOK03, 4: T.BOOK04,
          5: T.BOOK05, 6: T.BOOK06, 7: T.BOOK07, 8: T.BOOK08,
          9: T.BOOK09, 10: T.BOOK10, 11: T.BOOK11}


def get_sr_index(samplerate: int) -> int:
    """GetSRIndex (util.c): >= 0.92 * rate thresholds."""
    rates = SAMPLE_RATES[:12]
    for i, r in enumerate(rates):
        if samplerate >= 0.92 * r:
            return i
    return 11


def max_bitrate(samplerate: int) -> int:
    return int(0x2000 * 8 * float(samplerate) / FRAME_LEN)


# --------------------------------------------------------------------------
# bitstream writer (bitstream.c PutBit/WriteByte semantics)
# --------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, data: int, n: int) -> None:
        if n <= 0:
            return
        data &= (1 << n) - 1
        for i in range(n - 1, -1, -1):
            self.bits.append((data >> i) & 1)

    def numbits(self) -> int:
        return len(self.bits)

    def tobytes(self) -> bytes:
        n = len(self.bits)
        out = bytearray((n + 7) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


# --------------------------------------------------------------------------
# fft.c (non-DRM): radix-2 with float32 twiddle tables, double data
# --------------------------------------------------------------------------

_FFT_TABS = {}


def _fft_tables(logm: int):
    if logm not in _FFT_TABS:
        size = 1 << logm
        i = np.arange(size >> 1, dtype=np.float64)
        theta = 2.0 * np.pi * i / size
        cos = np.cos(theta).astype(np.float32)
        nsin = (-np.sin(theta)).astype(np.float32)
        rev = np.zeros(size, np.int64)
        for k in range(size):
            r = 0
            t = k
            for _ in range(logm):
                r = (r << 1) | (t & 1)
                t >>= 1
            rev[k] = r
        _FFT_TABS[logm] = (cos, nsin, rev)
    return _FFT_TABS[logm]


def fac_fft(xr: np.ndarray, xi: np.ndarray, logm: int):
    """fft (fft.c:369-390): reorder + radix-2 DIT with f32 twiddles.
    In-place on float64 arrays."""
    cos, nsin, rev = _fft_tables(logm)
    size = 1 << logm
    xr[:] = xr[rev]
    xi[:] = xi[rev]
    estep = size
    step = 1
    while step < size:
        estep >>= 1
        # vectorize over the butterflies of this stage: positions
        # pos=0,2step,...; within each, shift=0..step-1, exp=shift*estep
        idx1 = (np.arange(0, size, 2 * step)[:, None] +
                np.arange(step)[None, :]).ravel()
        idx2 = idx1 + step
        exp = (np.arange(step) * estep)
        wr = np.tile(cos[exp].astype(np.float64), size // (2 * step))
        wi = np.tile(nsin[exp].astype(np.float64), size // (2 * step))
        v2r = xr[idx2] * wr - xi[idx2] * wi
        v2i = xr[idx2] * wi + xi[idx2] * wr
        xr[idx2] = xr[idx1] - v2r
        xr[idx1] = xr[idx1] + v2r
        xi[idx2] = xi[idx1] - v2i
        xi[idx1] = xi[idx1] + v2i
        step *= 2


# --------------------------------------------------------------------------
# MDCT (filtbank.c mdct / blockswitch.c mdct; recurrence twiddles)
# --------------------------------------------------------------------------

_MDCT_TWID = {}


def _mdct_twiddles(N: int):
    """The c/s recurrence values for i = 0..N/4-1 (double, order exact)."""
    if N not in _MDCT_TWID:
        freq = 2.0 * math.pi / N
        cfreq = math.cos(freq)
        sfreq = math.sin(freq)
        c = math.cos(freq * 0.125)
        s = math.sin(freq * 0.125)
        cs = np.zeros(N >> 2, np.float64)
        sn = np.zeros(N >> 2, np.float64)
        for i in range(N >> 2):
            cs[i] = c
            sn[i] = s
            cold = c
            c = c * cfreq - s * sfreq
            s = s * cfreq + cold * sfreq
        _MDCT_TWID[N] = (cs, sn)
    return _MDCT_TWID[N]


def fac_mdct(data: np.ndarray, N: int) -> np.ndarray:
    """mdct (blockswitch.c:272-350 == filtbank.c): in data[N] double,
    returns the transformed data[N] (only [0:N/2) carry the spectrum:
    even indices ascending, odd descending; [N/2:N) mirror)."""
    n4 = N >> 2
    n2 = N >> 1
    cs, sn = _mdct_twiddles(N)
    n = 2 * np.arange(n4)
    tempr = np.where(
        n < n4,
        data[n4 + n2 - 1 - n] + data[np.minimum(N - n4 + n, N - 1)],
        data[n4 + n2 - 1 - n] - data[n - n4])
    tempi = np.where(
        n < n4,
        data[n4 + n] - data[n4 - 1 - n],
        data[n4 + n] + data[np.minimum(N + n4 - 1 - n, N - 1)])
    xr = tempr * cs + tempi * sn
    xi = tempi * cs - tempr * sn
    logm = 6 if N == 2 * BLOCK_LEN_SHORT else 9
    fac_fft(xr, xi, logm)
    tempr = 2.0 * (xr * cs + xi * sn)
    tempi = 2.0 * (xi * cs - xr * sn)
    out = np.empty(N, np.float64)
    i2 = 2 * np.arange(n4)
    out[i2] = -tempr
    out[n2 - 1 - i2] = tempi
    out[n2 + i2] = -tempi
    out[N - 1 - i2] = tempr
    return out


# --------------------------------------------------------------------------
# psy model (blockswitch.c psymodel2)
# --------------------------------------------------------------------------

_HANN_S = 0.5 * (1 - np.cos(2.0 * np.pi *
                            (np.arange(2 * BLOCK_LEN_SHORT) + 0.5) /
                            (2 * BLOCK_LEN_SHORT)))

_SIN_LONG = np.sin((np.pi / (2 * BLOCK_LEN_LONG)) *
                   (np.arange(BLOCK_LEN_LONG) + 0.5))
_SIN_SHORT = np.sin((np.pi / (2 * BLOCK_LEN_SHORT)) *
                    (np.arange(BLOCK_LEN_SHORT) + 0.5))


class _PsyChannel:
    def __init__(self):
        self.prev_samples = np.zeros(BLOCK_LEN_LONG, np.float64)
        # energy rings [4 generations][8 windows][NSFB_SHORT] float32
        self.eng = np.zeros((4, 8, NSFB_SHORT), np.float32)
        self.block_type = ONLY_LONG_WINDOW
        self.lastband = 0
        self.bandS = 0


class Encoder:
    """faacEncOpen + the aacType.c configuration (16-bit input, ADTS)."""

    def __init__(self, channels: int, samplerate: int):
        assert channels in (1, 2), "daemon geometry is mono/stereo"
        self.channels = channels
        self.samplerate = samplerate
        self.sr_idx = get_sr_index(samplerate)
        (_, self.num_cb_long, self.num_cb_short,
         self.cb_width_long, self.cb_width_short) = T.SR_INFO[self.sr_idx]

        # faacEncSetConfiguration with the GetCurrentConfiguration
        # defaults + inputFormat=16BIT (aacType.c:347-365): bandWidth
        # stays at its preset 0.42*fs (nonzero, so the bitrate-derived
        # branch is skipped), quantqual 0 -> DEFQUAL
        self.bit_rate = min(64000, max_bitrate(samplerate) // channels)
        bw = 0.42 * samplerate
        bw = max(100.0, min(bw, samplerate / 2))
        self.band_width = bw
        self.quality = float(DEFQUAL)

        self.pnslevel = 4  # JOINT_IS keeps the default pnslevel

        # CalcBW (quantize.c:495-527)
        self.band_width, self.max_cbs, self.max_cbl, self.max_l = \
            self._calc_bw(int(self.band_width))

        self.frame_num = 0
        self.flush_frame = 0
        # 4-deep per-channel double buffers (sample, next, next2, next3)
        self.bufs = [[np.zeros(FRAME_LEN, np.float64) for _ in range(4)]
                     for _ in range(channels)]
        self.psy = [_PsyChannel() for _ in range(channels)]
        self.overlap = [np.zeros(FRAME_LEN, np.float64)
                        for _ in range(channels)]
        self.block_type = [ONLY_LONG_WINDOW] * channels
        self.desired_block_type = [ONLY_LONG_WINDOW] * channels

    def _calc_bw(self, bw: int):
        maxv = bw * (BLOCK_LEN_SHORT << 1) // self.samplerate
        length = 0
        cnt = 0
        while cnt < self.num_cb_short:
            if length >= maxv:
                break
            length += self.cb_width_short[cnt]
            cnt += 1
        max_cbs = cnt
        if self.pnslevel:
            bw = int(float(length) * self.samplerate /
                     (BLOCK_LEN_SHORT << 1))
        maxv = bw * (BLOCK_LEN_LONG << 1) // self.samplerate
        length = 0
        cnt = 0
        while cnt < self.num_cb_long:
            if length >= maxv:
                break
            length += self.cb_width_long[cnt]
            cnt += 1
        max_cbl = cnt
        max_l = length
        bw = int(float(length) * self.samplerate / (BLOCK_LEN_LONG << 1))
        return bw, max_cbs, max_cbl, max_l

    # -- psy ------------------------------------------------------------

    def _psy_buffer_update(self, ch: int, new_samples: np.ndarray):
        p = self.psy[ch]
        p.bandS = int(BLOCK_LEN_SHORT * self.band_width * 2 /
                      self.samplerate)
        trans = np.concatenate([p.prev_samples, new_samples])
        # rotate generations: engPrev <- eng <- engNext <- engNext2
        p.eng = np.roll(p.eng, -1, axis=0)
        for win in range(8):
            seg = trans[win * BLOCK_LEN_SHORT + NFLAT_LS:
                        win * BLOCK_LEN_SHORT + NFLAT_LS +
                        2 * BLOCK_LEN_SHORT].copy()
            seg *= _HANN_S
            seg = fac_mdct(seg, 2 * BLOCK_LEN_SHORT)
            last = 0
            sfb = 0
            for sfb in range(self.num_cb_short):
                first = last
                last = first + self.cb_width_short[sfb]
                f = max(first, 1)
                if f >= p.bandS:
                    break
                e = 0.0
                for l in range(f, last):
                    e += seg[l] * seg[l]
                p.eng[3, win, sfb] = np.float32(e)
            else:
                sfb = self.num_cb_short
            p.lastband = sfb
            p.eng[3, win, sfb:] = 0
        p.prev_samples = new_samples.copy()

    def _psy_check_short(self, ch: int, quality: float):
        """PsyCheckShort (blockswitch.c:71-110): engPrev[6:8], eng[0:8],
        engNext[0:2] volume-change scan."""
        p = self.psy[ch]
        # generations: [0]=engPrev, [1]=eng, [2]=engNext, [3]=engNext2
        seq = [p.eng[0, 6], p.eng[0, 7]] + \
            [p.eng[1, w] for w in range(8)] + \
            [p.eng[2, 0], p.eng[2, 1]]
        p.block_type = ONLY_LONG_WINDOW
        lastband = p.lastband
        lasteng = None
        for eng in seq:
            if lasteng is not None:
                # C: double accumulators over float32 values, in-band
                # order; the f32 subtraction happens before the fabs
                toteng = 0.0
                volchg = 0.0
                for sfb in range(2, lastband):
                    e = eng[sfb]
                    le = lasteng[sfb]
                    toteng += float(e if e < le else le)
                    volchg += abs(float(np.float32(e - le)))
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = np.float64(volchg) / np.float64(toteng) \
                        if toteng != 0.0 else np.float64(
                            np.inf if volchg > 0 else np.nan)
                    if float(ratio) * quality > 3.0:
                        p.block_type = ONLY_SHORT_WINDOW
                        break
            lasteng = eng
        return p.block_type

    def _psy_calculate(self):
        quality = max(self.quality / DEFQUAL, 0.4)
        for ch in range(self.channels):
            self._psy_check_short(ch, quality)

    def _block_switch(self):
        desire = ONLY_LONG_WINDOW
        for ch in range(self.channels):
            if self.psy[ch].block_type == ONLY_SHORT_WINDOW:
                desire = ONLY_SHORT_WINDOW
        for ch in range(self.channels):
            last = self.block_type[ch]
            if desire == ONLY_SHORT_WINDOW or \
                    self.desired_block_type[ch] == ONLY_SHORT_WINDOW:
                if last in (ONLY_LONG_WINDOW, SHORT_LONG_WINDOW):
                    self.block_type[ch] = LONG_SHORT_WINDOW
                else:
                    self.block_type[ch] = ONLY_SHORT_WINDOW
            else:
                if last in (ONLY_SHORT_WINDOW, LONG_SHORT_WINDOW):
                    self.block_type[ch] = SHORT_LONG_WINDOW
                else:
                    self.block_type[ch] = ONLY_LONG_WINDOW
            self.desired_block_type[ch] = desire

    # -- filterbank -------------------------------------------------------

    def _filter_bank(self, ch: int, block_type: int) -> np.ndarray:
        p_in = self.bufs[ch][0]
        transf = np.concatenate([self.overlap[ch], p_in])
        self.overlap[ch] = p_in.copy()
        # window shapes are always SINE (faac never switches shape)
        out = np.zeros(2 * BLOCK_LEN_LONG, np.float64)
        if block_type == ONLY_LONG_WINDOW:
            out[:BLOCK_LEN_LONG] = transf[:BLOCK_LEN_LONG] * _SIN_LONG
            out[BLOCK_LEN_LONG:] = (transf[BLOCK_LEN_LONG:] *
                                    _SIN_LONG[::-1])
            return fac_mdct(out, 2 * BLOCK_LEN_LONG)
        if block_type == LONG_SHORT_WINDOW:
            out[:BLOCK_LEN_LONG] = transf[:BLOCK_LEN_LONG] * _SIN_LONG
            out[BLOCK_LEN_LONG:BLOCK_LEN_LONG + NFLAT_LS] = \
                transf[BLOCK_LEN_LONG:BLOCK_LEN_LONG + NFLAT_LS]
            sl = slice(BLOCK_LEN_LONG + NFLAT_LS,
                       BLOCK_LEN_LONG + NFLAT_LS + BLOCK_LEN_SHORT)
            out[sl] = transf[sl] * _SIN_SHORT[::-1]
            return fac_mdct(out, 2 * BLOCK_LEN_LONG)
        if block_type == SHORT_LONG_WINDOW:
            sl = slice(NFLAT_LS, NFLAT_LS + BLOCK_LEN_SHORT)
            out[sl] = transf[sl] * _SIN_SHORT
            out[NFLAT_LS + BLOCK_LEN_SHORT:BLOCK_LEN_LONG] = \
                transf[NFLAT_LS + BLOCK_LEN_SHORT:BLOCK_LEN_LONG]
            out[BLOCK_LEN_LONG:] = (transf[BLOCK_LEN_LONG:] *
                                    _SIN_LONG[::-1])
            return fac_mdct(out, 2 * BLOCK_LEN_LONG)
        # ONLY_SHORT_WINDOW: 8 short MDCTs over [NFLAT_LS..]
        res = np.zeros(2 * BLOCK_LEN_LONG, np.float64)
        base = NFLAT_LS
        first_w = _SIN_SHORT
        for k in range(MAX_SHORT_WINDOWS):
            seg = np.empty(2 * BLOCK_LEN_SHORT, np.float64)
            seg[:BLOCK_LEN_SHORT] = \
                transf[base:base + BLOCK_LEN_SHORT] * first_w
            seg[BLOCK_LEN_SHORT:] = \
                transf[base + BLOCK_LEN_SHORT:
                       base + 2 * BLOCK_LEN_SHORT] * _SIN_SHORT[::-1]
            res[k * BLOCK_LEN_SHORT:
                k * BLOCK_LEN_SHORT + 2 * BLOCK_LEN_SHORT] = \
                fac_mdct(seg, 2 * BLOCK_LEN_SHORT)
            base += BLOCK_LEN_SHORT
            first_w = _SIN_SHORT
        return res

    # -- grouping (quantize.c BlocGroup) ---------------------------------

    def _bloc_group(self, xr: np.ndarray, block_type: int):
        if block_type != ONLY_SHORT_WINDOW:
            return [1]
        MINSFB = 2
        maxl = self.max_l // 8
        maxsfb = self.max_cbs
        fastmin = ((maxsfb - MINSFB) * 3) >> 2
        offs = self._sfb_offsets(True)

        groups = []
        win0 = 0
        mn = mx = None
        for win in range(MAX_SHORT_WINDOWS):
            seg = xr[win * BLOCK_LEN_SHORT:(win + 1) * BLOCK_LEN_SHORT]
            # calce mutes lines above the cutoff IN PLACE (quantize.c:546)
            seg[maxl:offs[maxsfb]] = 0.0
            e = np.zeros(NSFB_SHORT, np.float64)
            for sfb in range(MINSFB, maxsfb):
                s = 0.0
                for l in range(offs[sfb], offs[sfb + 1]):
                    s += seg[l] * seg[l]
                e[sfb] = s
            if win == 0:
                mn = e.copy()
                mx = e.copy()
                continue
            fast = 0
            for sfb in range(MINSFB, maxsfb):
                if mn[sfb] > e[sfb]:
                    mn[sfb] = e[sfb]
                if mx[sfb] < e[sfb]:
                    mx[sfb] = e[sfb]
                if mx[sfb] > 3.0 * mn[sfb]:
                    fast += 1
            if fast > fastmin:
                groups.append(win - win0)
                win0 = win
                mn = e.copy()
                mx = e.copy()
        groups.append(MAX_SHORT_WINDOWS - win0)
        return groups

    def _sfb_offsets(self, short: bool):
        if short:
            widths = self.cb_width_short[:self.max_cbs]
        else:
            widths = self.cb_width_long[:self.max_cbl]
        offs = [0]
        for w in widths:
            offs.append(offs[-1] + w)
        return offs

    # -- main encode ------------------------------------------------------

    def encode(self, pcm: np.ndarray) -> bytes:
        """One faacEncEncode call: pcm int16 interleaved, FRAME_LEN
        samples per channel (or size 0 to flush).  Returns the ADTS
        bytes written (b\"\" while the lookahead pipeline fills)."""
        self.frame_num += 1
        if pcm.size == 0:
            self.flush_frame += 1
            if self.flush_frame > 4:
                return b""

        for ch in range(self.channels):
            self.bufs[ch] = self.bufs[ch][1:] + [self.bufs[ch][0]]
            buf = self.bufs[ch][3]
            if pcm.size == 0:
                buf[:] = 0.0
            else:
                spc = pcm.size // self.channels
                buf[:spc] = pcm[ch::self.channels].astype(np.float64)
                buf[spc:] = 0.0
            self._psy_buffer_update(ch, buf)

        if self.frame_num <= 3:
            return b""

        self._psy_calculate()
        self._block_switch()
        if self.frame_num <= 4:
            for ch in range(self.channels):
                self.block_type[ch] = ONLY_SHORT_WINDOW

        freq = []
        for ch in range(self.channels):
            freq.append(self._filter_bank(ch, self.block_type[ch]))

        # groups / sfb offsets per channel
        coder = []
        for ch in range(self.channels):
            c = {"block_type": self.block_type[ch], "window_shape": 0}
            if self.block_type[ch] == ONLY_SHORT_WINDOW:
                c["sfbn"] = self.max_cbs
                c["sfb_offset"] = self._sfb_offsets(True)
                c["groups"] = self._bloc_group(freq[ch], ONLY_SHORT_WINDOW)
            else:
                c["sfbn"] = self.max_cbl
                c["sfb_offset"] = self._sfb_offsets(False)
                c["groups"] = [1]
            c["tns_present"] = 0
            coder.append(c)

        ms_used, common_window, is_present = self._stereo(coder, freq)

        for ch in range(self.channels):
            self._bloc_quant(coder[ch], freq[ch])

        # fix max_sfb in CPE mode
        if self.channels == 2:
            n = max(coder[0]["sfbn"], coder[1]["sfbn"])
            coder[0]["sfbn"] = coder[1]["sfbn"] = n

        frame = self._write_bitstream(coder, freq, ms_used, common_window,
                                      is_present)

        # per-frame quality adaptation (frame.c:644-668)
        if self.bit_rate:
            desbits = self.channels * (self.bit_rate * FRAME_LEN) // \
                self.samplerate
            fix = float(desbits) / float(len(frame) * 8)
            if fix < 0.9:
                fix += 0.1
            elif fix > 1.1:
                fix -= 0.1
            else:
                fix = 1.0
            fix = (fix - 1.0) * 0.5 + 1.0
            self.quality *= fix
            self.quality = min(self.quality, float(MAXQUAL))
            self.quality = max(self.quality, 10.0)
        return frame

    # -- stereo (stereo.c AACstereo, JOINT_IS mode) -----------------------

    def _stereo(self, coder, freq):
        quality = self.quality / DEFQUAL
        isthr = 0.18 / (quality * quality)
        isthr = min(isthr, math.sqrt(2.0) - 1.0)
        isthr += 1.0
        isthr *= isthr

        nch = self.channels
        for c in coder:
            total = len(c["groups"]) * c["sfbn"]
            c["book"] = [HCB_NONE] * ((NSFB_SHORT + 1) * 8)
            c["sf"] = [0] * ((NSFB_SHORT + 1) * 8)
        ms_used = None
        common_window = 0
        is_present = 0
        if nch != 2:
            return ms_used, common_window, is_present
        cl, cr = coder
        if cl["block_type"] != cr["block_type"] or \
                cl["groups"] != cr["groups"]:
            return ms_used, 0, 0
        common_window = 1
        # JOINT_IS: the intensity scan (stereo.c stereo())
        sfcnt = 0
        start = 0
        for glen in cl["groups"]:
            end = start + glen
            sfcnt = self._is_scan(cl, cr, freq[0], freq[1], sfcnt,
                                  start, end, isthr)
            start = end
        return ms_used, common_window, is_present

    def _is_scan(self, cl, cr, sl0, sr0, sfcnt, wstart, wend, phthr):
        """stereo (stereo.c:22-131)."""
        if not phthr:
            return sfcnt
        phthr = 1.0 / phthr
        sfmin = 1 if cl["block_type"] == ONLY_SHORT_WINDOW else 8
        sfcnt += sfmin
        step = 10 / 1.50515
        offs = cl["sfb_offset"]
        for sfb in range(sfmin, cl["sfbn"]):
            start, end = offs[sfb], offs[sfb + 1]
            enrgs = enrgd = enrgl = enrgr = 0.0
            for win in range(wstart, wend):
                sl = sl0[win * BLOCK_LEN_SHORT:]
                sr = sr0[win * BLOCK_LEN_SHORT:]
                for l in range(start, end):
                    lx = sl[l]
                    rx = sr[l]
                    s = lx + rx
                    d = lx - rx
                    enrgs += s * s
                    enrgd += d * d
                    enrgl += lx * lx
                    enrgr += rx * rx
            ethr = _sqrt(enrgl) + _sqrt(enrgr)
            ethr *= ethr
            ethr *= phthr
            efix = enrgl + enrgr
            hcb = HCB_NONE
            vfix = 0.0
            with np.errstate(invalid="ignore", divide="ignore"):
                if enrgs >= ethr:
                    hcb = HCB_INTENSITY
                    vfix = float(np.float64(efix) / np.float64(enrgs))
                    vfix = _sqrt(vfix)
                elif enrgd >= ethr:
                    hcb = HCB_INTENSITY2
                    vfix = float(np.float64(efix) / np.float64(enrgd))
                    vfix = _sqrt(vfix)
            if hcb != HCB_NONE:
                with np.errstate(invalid="ignore", divide="ignore"):
                    rl = float(np.float64(enrgl) / np.float64(efix))
                    rr = float(np.float64(enrgr) / np.float64(efix))
                sf = _lrint(_log10(rl) * step)
                pan = ((_lrint(_log10(rr) * step) - sf + 2**31)
                       % 2**32) - 2**31
                if pan > 30:
                    cl["book"][sfcnt] = HCB_ZERO
                    sfcnt += 1
                    continue
                if pan < -30:
                    cr["book"][sfcnt] = HCB_ZERO
                    sfcnt += 1
                    continue
                cl["sf"][sfcnt] = sf
                cr["sf"][sfcnt] = -pan
                cr["book"][sfcnt] = hcb
                for win in range(wstart, wend):
                    base = win * BLOCK_LEN_SHORT
                    for l in range(start, end):
                        if hcb == HCB_INTENSITY:
                            s = sl0[base + l] + sr0[base + l]
                        else:
                            s = sl0[base + l] - sr0[base + l]
                        sl0[base + l] = s * vfix
            sfcnt += 1
        return sfcnt

    # -- quantization (quantize.c) ----------------------------------------

    def _bloc_quant(self, c, xr):
        c["bandcnt"] = 0
        c["data"] = []          # list of (data, len)
        bandlvl = np.zeros(NSFB_SHORT + 1 + NSFB_LONG, np.float64)
        gxr = 0
        for gnum, glen in enumerate(c["groups"]):
            lvl = self._bmask(c, xr[gxr:], gnum)
            self._qlevel(c, xr[gxr:], lvl, gnum)
            gxr += glen * BLOCK_LEN_SHORT

        # global gain = first non-IS coded band's sf
        c["global_gain"] = 0
        for cnt in range(c["bandcnt"]):
            book = c["book"][cnt]
            if not book or book == HCB_NONE:
                continue
            if book not in (HCB_INTENSITY, HCB_INTENSITY2):
                c["global_gain"] = c["sf"][cnt]
                break
        lastsf = c["global_gain"]
        lastis = 0
        for cnt in range(c["bandcnt"]):
            book = c["book"][cnt]
            if book in (HCB_INTENSITY, HCB_INTENSITY2):
                diff = c["sf"][cnt] - lastis
                diff = max(-60, min(60, diff))
                lastis += diff
                c["sf"][cnt] = lastis
            elif book != HCB_PNS:
                # NB zero-book bands participate in this clamp chain
                # (quantize.c:320-334 has no zero-book skip): their sf=0
                # drags lastsf down, which is why the bitstream carries
                # the characteristic -60/+30 staircase after silence
                diff = c["sf"][cnt] - lastsf
                diff = max(-60, min(60, diff))
                lastsf += diff
                c["sf"][cnt] = lastsf

    def _bmask(self, c, xr0, gnum):
        """bmask (quantize.c:47-140)."""
        gsize = c["groups"][gnum]
        offs = c["sfb_offset"]
        sfbn = c["sfbn"]
        quality = self.quality / DEFQUAL
        totenrg = 0.0
        enrgcnt = 0
        for sfb in range(sfbn):
            for win in range(gsize):
                seg = xr0[win * BLOCK_LEN_SHORT:]
                for cnt in range(offs[sfb], offs[sfb + 1]):
                    totenrg += seg[cnt] * seg[cnt]
                    enrgcnt += 1
        lvl = np.zeros(sfbn, np.float64)
        if totenrg < (NOISEFLOOR * NOISEFLOOR) * enrgcnt:
            return lvl
        short = c["block_type"] == ONLY_SHORT_WINDOW
        last = BLOCK_LEN_SHORT if short else BLOCK_LEN_LONG
        powm = 0.4
        for sfb in range(sfbn):
            start, end = offs[sfb], offs[sfb + 1]
            avge = 0.0
            maxe = 0.0
            for win in range(gsize):
                seg = xr0[win * BLOCK_LEN_SHORT:]
                for cnt in range(start, end):
                    e = seg[cnt] * seg[cnt]
                    avge += e
                    if maxe < e:
                        maxe = e
            maxe *= gsize
            avgenrg = totenrg / last
            avgenrg *= end - start
            target = NOISETONE * math.pow(avge / avgenrg, powm)
            target += (1.0 - NOISETONE) * 0.45 * \
                math.pow(maxe / avgenrg, powm)
            if short:
                target *= 1.5
            target *= 10.0 / (1.0 + (float(start + end) / last))
            lvl[sfb] = target * quality
        return lvl

    def _qlevel(self, c, xr0, bandqual, gnum):
        """qlevel (quantize.c:143-280), SSE2 float32 rounding branch (the
        x86 reference build takes it; cpuid has SSE2)."""
        sfstep = 1.0 / math.log10(math.sqrt(math.sqrt(2.0)))
        gsize = c["groups"][gnum]
        pnsthr = 0.1 * self.pnslevel
        offs = c["sfb_offset"]
        for sb in range(c["sfbn"]):
            if c["book"][c["bandcnt"]] != HCB_NONE:
                c["bandcnt"] += 1
                continue
            start, end = offs[sb], offs[sb + 1]
            etot = 0.0
            for win in range(gsize):
                seg = xr0[win * BLOCK_LEN_SHORT:]
                for cnt in range(start, end):
                    etot += seg[cnt] * seg[cnt]
            etot /= gsize
            rmsx = _sqrt(etot / (end - start))
            if rmsx < NOISEFLOOR or not bandqual[sb]:
                c["book"][c["bandcnt"]] = HCB_ZERO
                c["bandcnt"] += 1
                continue
            if bandqual[sb] < pnsthr:
                c["book"][c["bandcnt"]] = HCB_PNS
                c["sf"][c["bandcnt"]] += _lrint(
                    _log10(etot) * (0.5 * sfstep))
                c["bandcnt"] += 1
                continue
            sfac = _lrint(_log10(bandqual[sb] / rmsx) * sfstep)
            if (SF_OFFSET - sfac) < 10:
                sfacfix = 0.0
            else:
                sfacfix = math.pow(10, sfac / sfstep)
            width = end - start
            xi = np.zeros(gsize * width, np.int64)
            p = 0
            for win in range(gsize):
                seg = xr0[win * BLOCK_LEN_SHORT + start:
                          win * BLOCK_LEN_SHORT + end]
                # SSE2 branch: float32 lanes, x*sfacfix, x*sqrt(x),
                # sqrt, +MAGIC, truncate
                x = np.abs(seg).astype(np.float32)
                x = (x * np.float32(sfacfix)).astype(np.float32)
                x = (x * np.sqrt(x, dtype=np.float32)).astype(np.float32)
                x = np.sqrt(x, dtype=np.float32)
                x = (x + np.float32(MAGIC_NUMBER)).astype(np.float32)
                # cvttps_epi32: NaN / out-of-range -> 0x80000000
                with np.errstate(invalid="ignore"):
                    bad = ~np.isfinite(x) | (x >= np.float32(2.0**31)) \
                        | (x < np.float32(-2.0**31))
                    q = np.where(bad, np.int64(-2**31),
                                 np.where(np.isfinite(x), np.trunc(x),
                                          0).astype(np.int64))
                q = np.where(seg < 0, -q, q)
                q = ((q + 2**31) % 2**32) - 2**31  # int32 wrap
                xi[p:p + width] = q
                p += width
            self._huffbook(c, xi.tolist())
            c["sf"][c["bandcnt"]] += SF_OFFSET - sfac
            c["bandcnt"] += 1

    # -- huffman (huff2.c) -------------------------------------------------

    @staticmethod
    def _escape(x: int):
        preflen = 0
        base = 32
        code = 0
        while base <= x:
            base <<= 1
            code = (code << 1) | 1
            preflen += 1
        base >>= 1
        code <<= 1
        code <<= preflen + 4
        code |= x - base
        return (preflen << 1) + 5, code

    def _huffcode(self, qs, bnum, emit):
        """huffcode (huff2.c:70-378).  emit=None counts bits only; else
        it's a list of (data, len) to append to."""
        book = _BOOKS.get(bnum)
        bits = 0
        if bnum in (1, 2):
            for ofs in range(0, len(qs), 4):
                qp = qs[ofs:ofs + 4]
                idx = 27 * qp[0] + 9 * qp[1] + 3 * qp[2] + qp[3] + 40
                blen = int(book[idx][0])
                if emit is not None:
                    emit.append((int(book[idx][1]), blen))
                bits += blen
        elif bnum in (3, 4):
            for ofs in range(0, len(qs), 4):
                qp = qs[ofs:ofs + 4]
                idx = (27 * abs(qp[0]) + 9 * abs(qp[1]) +
                       3 * abs(qp[2]) + abs(qp[3]))
                blen = int(book[idx][0])
                if emit is None:
                    blen += sum(1 for v in qp if v)
                else:
                    data = int(book[idx][1])
                    for v in qp:
                        if v:
                            blen += 1
                            data = (data << 1) | (1 if v < 0 else 0)
                    emit.append((data, blen))
                bits += blen
        elif bnum in (5, 6):
            for ofs in range(0, len(qs), 2):
                qp = qs[ofs:ofs + 2]
                idx = 9 * qp[0] + qp[1] + 40
                blen = int(book[idx][0])
                if emit is not None:
                    emit.append((int(book[idx][1]), blen))
                bits += blen
        elif bnum in (7, 8):
            for ofs in range(0, len(qs), 2):
                qp = qs[ofs:ofs + 2]
                idx = 8 * abs(qp[0]) + abs(qp[1])
                blen = int(book[idx][0])
                if emit is None:
                    blen += sum(1 for v in qp if v)
                else:
                    data = int(book[idx][1])
                    for v in qp:
                        if v:
                            blen += 1
                            data = (data << 1) | (1 if v < 0 else 0)
                    emit.append((data, blen))
                bits += blen
        elif bnum in (9, 10):
            for ofs in range(0, len(qs), 2):
                qp = qs[ofs:ofs + 2]
                idx = 13 * abs(qp[0]) + abs(qp[1])
                blen = int(book[idx][0])
                if emit is None:
                    blen += sum(1 for v in qp if v)
                else:
                    data = int(book[idx][1])
                    for v in qp:
                        if v:
                            blen += 1
                            data = (data << 1) | (1 if v < 0 else 0)
                    emit.append((data, blen))
                bits += blen
        elif bnum == HCB_ESC:
            for ofs in range(0, len(qs), 2):
                qp = qs[ofs:ofs + 2]
                x0 = min(abs(qp[0]), 16)
                x1 = min(abs(qp[1]), 16)
                idx = 17 * x0 + x1
                blen = int(book[idx][0])
                if emit is None:
                    blen += sum(1 for v in qp if v)
                else:
                    data = int(book[idx][1])
                    for v in qp:
                        if v:
                            blen += 1
                            data = (data << 1) | (1 if v < 0 else 0)
                    emit.append((data, blen))
                bits += blen
                if x0 >= 16:
                    elen, edata = self._escape(abs(qp[0]))
                    if emit is not None:
                        emit.append((edata, elen))
                    bits += elen
                if x1 >= 16:
                    elen, edata = self._escape(abs(qp[1]))
                    if emit is not None:
                        emit.append((edata, elen))
                    bits += elen
        else:
            raise ValueError(f"book {bnum}")
        return bits

    def _huffbook(self, c, qs):
        maxq = 0
        for q in qs:
            a = _absi32(q)
            if maxq < a:
                maxq = a
        if maxq < 1:
            bookmin = HCB_ZERO
        else:
            if maxq < 2:
                base = 1
            elif maxq < 3:
                base = 3
            elif maxq < 5:
                base = 5
            elif maxq < 8:
                base = 7
            elif maxq < 13:
                base = 9
            else:
                base = None
            if base is None:
                bookmin = HCB_ESC
            else:
                bookmin = base
                lenmin = self._huffcode(qs, base, None)
                if self._huffcode(qs, base + 1, None) < lenmin:
                    bookmin += 1
        if bookmin > HCB_ZERO:
            self._huffcode(qs, bookmin, c["data"])
        c["book"][c["bandcnt"]] = bookmin

    # -- bitstream write (bitstream.c) -------------------------------------

    def _write_books(self, c, bs):
        bits = 0
        if c["block_type"] == ONLY_SHORT_WINDOW:
            maxcnt, cntbits = 7, 3
        else:
            maxcnt, cntbits = 31, 5
        for group in range(len(c["groups"])):
            band = group * c["sfbn"]
            maxband = band + c["sfbn"]
            while band < maxband:
                book = c["book"][band]
                band += 1
                bookcnt = 1
                if bs:
                    bs.put(book, 4)
                bits += 4
                while band < maxband and c["book"][band] == book:
                    band += 1
                    bookcnt += 1
                while bookcnt >= maxcnt:
                    if bs:
                        bs.put(maxcnt, cntbits)
                    bits += cntbits
                    bookcnt -= maxcnt
                if bs:
                    bs.put(bookcnt, cntbits)
                bits += cntbits
        return bits

    def _write_sf(self, c, bs):
        bits = 0
        lastsf = c["global_gain"]
        lastis = 0
        lastpns = c["global_gain"] - 90
        initpns = True
        bandcnt = len(c["groups"]) * c["sfbn"]
        for cnt in range(bandcnt):
            book = c["book"][cnt]
            if book in (HCB_INTENSITY, HCB_INTENSITY2):
                diff = max(-60, min(60, c["sf"][cnt] - lastis))
                length = int(T.BOOK12[60 + diff][0])
                bits += length
                lastis += diff
                if bs:
                    bs.put(int(T.BOOK12[60 + diff][1]), length)
            elif book == HCB_PNS:
                diff = c["sf"][cnt] - lastpns
                if initpns:
                    initpns = False
                    bits += 9
                    lastpns += diff
                    if bs:
                        bs.put(diff + 256, 9)
                    continue
                diff = max(-60, min(60, diff))
                length = int(T.BOOK12[60 + diff][0])
                bits += length
                lastpns += diff
                if bs:
                    bs.put(int(T.BOOK12[60 + diff][1]), length)
            elif book and book != HCB_NONE:
                diff = max(-60, min(60, c["sf"][cnt] - lastsf))
                length = int(T.BOOK12[60 + diff][0])
                bits += length
                lastsf += diff
                if bs:
                    bs.put(int(T.BOOK12[60 + diff][1]), length)
        return bits

    def _grouping_bits(self, groups):
        tmp = []
        for i, glen in enumerate(groups):
            tmp.extend([i] * glen)
        gb = 0
        for i in range(1, 8):
            gb <<= 1
            if tmp[i] == tmp[i - 1]:
                gb += 1
        return gb

    def _write_ics_info(self, c, bs):
        bits = 0
        if bs:
            bs.put(0, 1)
            bs.put(c["block_type"], 2)
            bs.put(c["window_shape"], 1)
        bits += 4
        if c["block_type"] == ONLY_SHORT_WINDOW:
            if bs:
                bs.put(c["sfbn"], 4)
                bs.put(self._grouping_bits(c["groups"]), 7)
            bits += 4 + 7
        else:
            if bs:
                bs.put(c["sfbn"], 6)
            bits += 6
            bits += 1
            if bs:
                bs.put(0, 1)  # predictor_data_present
        return bits

    def _write_ics(self, c, bs, common_window):
        bits = 0
        if bs:
            bs.put(c["global_gain"], 8)
        bits += 8
        if not common_window:
            bits += self._write_ics_info(c, bs)
        bits += self._write_books(c, bs)
        bits += self._write_sf(c, bs)
        # pulse, tns, gain control: all absent
        if bs:
            bs.put(0, 1)
            bs.put(0, 1)
            bs.put(0, 1)
        bits += 3
        for data, length in c["data"]:
            if bs and length > 0:
                bs.put(data, length)
            bits += length
        return bits

    def _write_faac_str(self, bs, numbit_so_far):
        s = b"libfaac 1.29.9.2\x00"
        length = len(s)
        padbits = (8 - ((numbit_so_far + 7) % 8)) % 8
        count = length + 3
        bitcnt = 3 + 4 + (0 if count < 15 else 8) + count * 8
        if bs is None:
            return bitcnt
        bs.put(ID_FIL, 3)
        if count < 15:
            bs.put(count, 4)
        else:
            bs.put(15, 4)
            bs.put(count - 14, 8)
        bs.put(0, padbits)
        bs.put(0, 8)
        bs.put(0, 8)
        for ch in s:
            bs.put(ch, 8)
        bs.put(0, 8 - padbits)
        return bitcnt

    def _write_fill_bits(self, bs, num_bits):
        left = num_bits
        minbits = 3 + 4
        while left >= minbits:
            if bs:
                bs.put(ID_FIL, 3)
            left -= minbits
            nbytes = left // 8
            maxcnt = 15
            if nbytes < maxcnt:
                if bs:
                    bs.put(nbytes, 4)
                    for _ in range(nbytes):
                        bs.put(0, 8)
                left -= nbytes * 8
            else:
                if bs:
                    bs.put(maxcnt, 4)
                maxesc = 255
                nbytes = min(nbytes, maxcnt + maxesc)
                esc = nbytes - maxcnt
                if bs:
                    bs.put(esc, 8)
                    for _ in range(nbytes - 1):
                        bs.put(0, 8)
                left -= (nbytes - 1) * 8 + 8
        return left

    def _write_frame_body(self, coder, ms_used, common_window, is_present,
                          bs, header_bits):
        """The element writes shared by Count and Write passes; returns
        bits written excluding header."""
        bits = 0
        if self.frame_num == 4:
            bits += self._write_faac_str(
                bs, (bs.numbits() if bs else header_bits))
        if self.channels == 2:
            if bs:
                bs.put(ID_CPE, 3)
                bs.put(0, 4)        # tag
                bs.put(common_window, 1)
            bits += 3 + 4 + 1
            if common_window:
                bits += self._write_ics_info(coder[0], bs)
                if bs:
                    bs.put(is_present, 2)  # LEN_MASK_PRES
                bits += 2
                # JOINT_IS never sets ms is_present=1, so no ms_used mask
            bits += self._write_ics(coder[0], bs, common_window)
            bits += self._write_ics(coder[1], bs, common_window)
        else:
            if bs:
                bs.put(ID_SCE, 3)
                bs.put(0, 4)
            bits += 3 + 4
            bits += self._write_ics(coder[0], bs, 0)
        # in C `bits` includes the ADTS header, so the <5-bit case never
        # fires for ADTS output; the +6 fill is below the 7-bit minimum
        # fill element and is a no-op
        if bits + header_bits < (8 - 3):
            numfill = 8 - 3 - (bits + header_bits)
        else:
            numfill = 0
        numfill += 6
        left = self._write_fill_bits(bs, numfill)
        bits += numfill - left
        bits += 3
        if bs:
            bs.put(ID_END, 3)
        total = bits + header_bits
        pad = (8 - (total % 8)) % 8
        if bs:
            bs.put(0, pad)
        bits += pad
        return bits

    def _write_bitstream(self, coder, freq, ms_used, common_window,
                         is_present) -> bytes:
        # count pass (header = 56 bits)
        body_bits = self._write_frame_body(coder, ms_used, common_window,
                                           is_present, None, 56)
        used_bytes = (56 + body_bits) // 8
        # write pass
        bs = BitWriter()
        bs.put(0xFFF, 12)
        bs.put(0, 1)            # MPEG4
        bs.put(0, 2)
        bs.put(1, 1)            # protection absent
        bs.put(2 - 1, 2)        # profile LOW(2) - 1
        bs.put(self.sr_idx, 4)
        bs.put(0, 1)
        bs.put(self.channels, 3)
        bs.put(0, 1)
        bs.put(0, 1)
        bs.put(0, 1)
        bs.put(0, 1)
        bs.put(used_bytes, 13)
        bs.put(0x7FF, 11)
        bs.put(0, 2)
        self._write_frame_body(coder, ms_used, common_window, is_present,
                               bs, 56)
        out = bs.tobytes()
        assert len(out) == used_bytes, (len(out), used_bytes)
        return out


def _lrint(x: float) -> int:
    """C lrint on x86-64 (cvtsd2si) truncated into an int variable: NaN,
    infinities and out-of-range produce the 'integer indefinite'
    0x8000000000000000, whose low 32 bits are 0.  Silent stereo bands
    reach this path through the intensity scan's 0/0 energies
    (stereo.c:92-93) and the bitstream depends on the result."""
    xf = float(x)
    if math.isnan(xf) or math.isinf(xf) or not (-2.0**63 <= xf < 2.0**63):
        return 0  # low 32 bits of 0x8000000000000000
    v = int(np.rint(xf))
    return ((v + 2**31) % 2**32) - 2**31


def _log10(x: float) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.log10(np.float64(x)))


def _sqrt(x: float) -> float:
    with np.errstate(invalid="ignore"):
        return float(np.sqrt(np.float64(x)))


def _absi32(v: int) -> int:
    """C abs() on int: abs(INT_MIN) stays INT_MIN (negative) — the
    huffbook maxq scan relies on this to classify NaN-quantized bands
    (which cvttps turned into 0x80000000) as zero books."""
    return v if v == -(2**31) else abs(v)


# --------------------------------------------------------------------------
# aacType.c wrapper (aac_encode :321-366)
# --------------------------------------------------------------------------

def aac_encode(enc, pcm_bytes: bytes, chn: int, freq: int):
    """aac_encode semantics: in = 2048*chn BYTES?? — the C passes
    inLen/2 as samplesInput (FRAME_LEN*chn int16 samples).  Returns
    (enc, adts_bytes)."""
    if enc is None:
        enc = Encoder(chn, freq)
    pcm = np.frombuffer(pcm_bytes, np.int16)
    return enc, enc.encode(pcm)
