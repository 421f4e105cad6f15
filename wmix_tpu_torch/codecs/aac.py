"""AAC-LC decoder: bit-exact rebuild of the faad2 float decode path.

The daemon's AAC support wraps faad2 2.8.8 (`aac_decode`/`aac_decode2`,
src/aacType.c:125-255) built float (`FIXED_POINT` unset),
decoding ADTS AAC-LC.  This module re-derives that decode pipeline as a
host numpy program with C-float32 semantics:

  ADTS frame -> raw_data_block (SCE/CPE/DSE/PCE/FIL) ->
  section/scalefactor/spectral huffman -> dequant (q^(4/3) table) +
  2^(sf/4) scaling -> PNS -> M/S -> IS -> TNS all-pole filter ->
  IMDCT filterbank (pre-twiddle, cfftf1pos complex FFT, post-twiddle,
  window overlap-add) -> float->int16 (clip + lrintf)

Bit-exactness notes: all float arithmetic is float32 elementwise (numpy
never fuses into FMA, matching the reference's scalar C); transcendentals
(pow/cos/sqrt in scale computation and twiddle generation) go through
double then cast like the C; sequential float accumulations (PNS energy)
are folded left-to-right in float32.  Constant tables come from
`_aac_tables.py`, generated from the compiled reference decoder
(oracle/gen_aac_tables.py).

Scope: LC profile (ADTS object type 1/2), long+short windows, MS/IS/PNS/
TNS/pulse; the daemon never feeds MAIN/SSR/LTP or SBR streams (its own
encoder is faac LC, and the shipped fixtures are LC).  Unsupported
syntax raises AacError rather than guessing.

Layer III of the plan in docs/aac-plan.md; parity gates in
tests/test_aac.py run against the compiled reference
(.oracle/liboracle_*.so aac_decode) on the audio/ fixtures.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from wmix_tpu_torch.codecs import _aac_tables as T

F32 = np.float32

# element ids (syntax.h)
ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)

ONLY_LONG_SEQUENCE = 0
LONG_START_SEQUENCE = 1
EIGHT_SHORT_SEQUENCE = 2
LONG_STOP_SEQUENCE = 3

ZERO_HCB = 0
FIRST_PAIR_HCB = 5
ESC_HCB = 11
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15

TNS_MAX_ORDER = 20

SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350]

# tns_sbf_max (common.c:97-115), columns: [LC long, LC short]
TNS_SBF_MAX = [(31, 9), (31, 9), (34, 10), (40, 14), (42, 14), (51, 14),
               (46, 14), (46, 14), (42, 14), (42, 14), (42, 14), (39, 14),
               (39, 14), (0, 0), (0, 0), (0, 0)]

SWB_1024 = [T.SWB_OFFSET_1024_96, T.SWB_OFFSET_1024_96,
            T.SWB_OFFSET_1024_64, T.SWB_OFFSET_1024_48,
            T.SWB_OFFSET_1024_48, T.SWB_OFFSET_1024_32,
            T.SWB_OFFSET_1024_24, T.SWB_OFFSET_1024_24,
            T.SWB_OFFSET_1024_16, T.SWB_OFFSET_1024_16,
            T.SWB_OFFSET_1024_16, T.SWB_OFFSET_1024_8]
SWB_128 = [T.SWB_OFFSET_128_96, T.SWB_OFFSET_128_96, T.SWB_OFFSET_128_64,
           T.SWB_OFFSET_128_48, T.SWB_OFFSET_128_48, T.SWB_OFFSET_128_48,
           T.SWB_OFFSET_128_24, T.SWB_OFFSET_128_24, T.SWB_OFFSET_128_16,
           T.SWB_OFFSET_128_16, T.SWB_OFFSET_128_16, T.SWB_OFFSET_128_8]


class AacError(Exception):
    pass


def get_sr_index(samplerate: int) -> int:
    """get_sr_index (common.c:120-140): >= thresholds."""
    bounds = [92017, 75132, 55426, 46009, 37566, 27713, 23004, 18783,
              13856, 11502, 9391]
    for i, b in enumerate(bounds):
        if samplerate >= b:
            return i
    return 11


# --------------------------------------------------------------------------
# bitstream (bits.c semantics: MSB first; reads past the end return zeros)
# --------------------------------------------------------------------------

class Bits:
    def __init__(self, data: bytes):
        # +16 zero bytes: reads past the end return zeros (bits.c pads
        # the buffer the same way)
        self.data = bytes(data) + b"\x00" * 16
        self.nbits = len(data) * 8
        self.pos = 0

    def show(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        end = p + n
        first = p >> 3
        last = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first:last], "big")
        shift = last * 8 - end
        return (chunk >> shift) & ((1 << n) - 1)

    def flush(self, n: int) -> None:
        self.pos += n

    def get(self, n: int) -> int:
        v = self.show(n)
        self.pos += n
        return v

    def get1(self) -> int:
        return self.get(1)

    def byte_align(self) -> None:
        r = self.pos & 7
        if r:
            self.pos += 8 - r

    def processed(self) -> int:
        return self.pos


# --------------------------------------------------------------------------
# huffman (huffman.c) using the faad 2-step/binary tables
# --------------------------------------------------------------------------

HCB_2STEP_QUAD = {1: (T.HCB1_1, T.HCB1_2Q), 2: (T.HCB2_1, T.HCB2_2Q),
                  4: (T.HCB4_1, T.HCB4_2Q)}
HCB_2STEP_PAIR = {6: (T.HCB6_1, T.HCB6_2P), 8: (T.HCB8_1, T.HCB8_2P),
                  10: (T.HCB10_1, T.HCB10_2P), 11: (T.HCB11_1, T.HCB11_2P)}
HCB_BIN_PAIR = {5: T.HCB5_BINP, 7: T.HCB7_BINP, 9: T.HCB9_BINP}


def huffman_scale_factor(ld: Bits) -> int:
    offset = 0
    while T.HCB_SF[offset][1]:
        b = ld.get1()
        offset += int(T.HCB_SF[offset][b])
        if offset > 240:
            raise AacError("hcb_sf overflow")
    return int(T.HCB_SF[offset][0])


def _sign_bits(ld: Bits, sp: list) -> None:
    for i in range(len(sp)):
        if sp[i]:
            if ld.get1():
                sp[i] = -sp[i]


def _getescape(ld: Bits, sp: int) -> int:
    if sp < 0:
        if sp != -16:
            return sp
        neg = True
    else:
        if sp != 16:
            return sp
        neg = False
    i = 4
    while ld.get1():
        i += 1
    off = ld.get(i)
    j = off | (1 << i)
    return -j if neg else j


def _2step(cb: int, ld: Bits, first, second, width: int) -> list:
    nbits = T.HCB_N[cb]
    cw = ld.show(nbits)
    offset = int(first[cw][0])
    extra = int(first[cw][1])
    if extra:
        ld.flush(nbits)
        offset += ld.show(extra)
        ld.flush(int(second[offset][0]) - nbits)
    else:
        ld.flush(int(second[offset][0]))
    return [int(v) for v in second[offset][1:1 + width]]


def _binary_pair(cb: int, ld: Bits) -> list:
    tab = HCB_BIN_PAIR[cb]
    offset = 0
    while not tab[offset][0]:
        b = ld.get1()
        offset += int(tab[offset][1 + b])
    return [int(tab[offset][1]), int(tab[offset][2])]


def _binary_quad(ld: Bits) -> list:
    tab = T.HCB3_BINQ
    offset = 0
    while not tab[offset][0]:
        b = ld.get1()
        offset += int(tab[offset][1 + b])
    return [int(v) for v in tab[offset][1:5]]


def huffman_spectral_data(cb: int, ld: Bits) -> list:
    if cb in (1, 2):
        return _2step(cb, ld, *HCB_2STEP_QUAD[cb], width=4)
    if cb == 3:
        sp = _binary_quad(ld)
        _sign_bits(ld, sp)
        return sp
    if cb == 4:
        sp = _2step(cb, ld, *HCB_2STEP_QUAD[cb], width=4)
        _sign_bits(ld, sp)
        return sp
    if cb == 5:
        return _binary_pair(cb, ld)
    if cb == 6:
        return _2step(cb, ld, *HCB_2STEP_PAIR[cb], width=2)
    if cb in (7, 9):
        sp = _binary_pair(cb, ld)
        _sign_bits(ld, sp)
        return sp
    if cb in (8, 10):
        sp = _2step(cb, ld, *HCB_2STEP_PAIR[cb], width=2)
        _sign_bits(ld, sp)
        return sp
    if cb == 11:
        sp = _2step(11, ld, *HCB_2STEP_PAIR[11], width=2)
        _sign_bits(ld, sp)
        sp[0] = _getescape(ld, sp[0])
        sp[1] = _getescape(ld, sp[1])
        return sp
    raise AacError(f"bad codebook {cb}")


# --------------------------------------------------------------------------
# ic_stream side info
# --------------------------------------------------------------------------

class ICStream:
    def __init__(self):
        self.global_gain = 0
        self.window_sequence = 0
        self.window_shape = 0
        self.max_sfb = 0
        self.scale_factor_grouping = 0
        self.num_windows = 1
        self.num_window_groups = 1
        self.window_group_length = [1] * 8
        self.num_swb = 0
        self.swb_offset = None          # int array [num_swb+1]
        self.swb_offset_max = 0
        self.sect_sfb_offset = None     # [g][sect]
        self.sect_cb = [[0] * 120 for _ in range(8)]
        self.sect_start = [[0] * 120 for _ in range(8)]
        self.sect_end = [[0] * 120 for _ in range(8)]
        self.sfb_cb = [[0] * 64 for _ in range(8)]
        self.num_sec = [0] * 8
        self.scale_factors = [[0] * 64 for _ in range(8)]
        self.ms_mask_present = 0
        self.ms_used = [[0] * 64 for _ in range(8)]
        self.noise_used = 0
        self.is_used = 0
        self.pulse_data_present = 0
        self.tns_data_present = 0
        self.gain_control_data_present = 0
        self.predictor_data_present = 0
        self.pulse = None
        self.tns = None

    def is_intensity(self, g, sfb) -> int:
        cb = self.sfb_cb[g][sfb]
        if cb == INTENSITY_HCB:
            return 1
        if cb == INTENSITY_HCB2:
            return -1
        return 0

    def is_noise(self, g, sfb) -> bool:
        return self.sfb_cb[g][sfb] == NOISE_HCB


class TnsInfo:
    def __init__(self):
        self.n_filt = [0] * 8
        self.coef_res = [0] * 8
        self.length = [[0] * 4 for _ in range(8)]
        self.order = [[0] * 4 for _ in range(8)]
        self.direction = [[0] * 4 for _ in range(8)]
        self.coef_compress = [[0] * 4 for _ in range(8)]
        self.coef = [[[0] * 32 for _ in range(4)] for _ in range(8)]


def window_grouping_info(ics: ICStream, sf_index: int,
                         frame_len: int = 1024) -> None:
    """window_grouping_info (specrec.c:303-425)."""
    if ics.window_sequence in (ONLY_LONG_SEQUENCE, LONG_START_SEQUENCE,
                               LONG_STOP_SEQUENCE):
        ics.num_windows = 1
        ics.num_window_groups = 1
        ics.window_group_length = [1] + [0] * 7
        ics.num_swb = int(T.NUM_SWB_1024_WINDOW[sf_index])
        if ics.max_sfb > ics.num_swb:
            raise AacError("max_sfb > num_swb")
        swb = SWB_1024[sf_index]
        ics.swb_offset = np.concatenate(
            [np.asarray(swb[:ics.num_swb]), [frame_len]]).astype(np.int64)
        ics.swb_offset_max = frame_len
        ics.sect_sfb_offset = [list(ics.swb_offset)]
    elif ics.window_sequence == EIGHT_SHORT_SEQUENCE:
        ics.num_windows = 8
        ics.num_window_groups = 1
        ics.window_group_length = [1] + [0] * 7
        ics.num_swb = int(T.NUM_SWB_128_WINDOW[sf_index])
        if ics.max_sfb > ics.num_swb:
            raise AacError("max_sfb > num_swb")
        swb = SWB_128[sf_index]
        ics.swb_offset = np.concatenate(
            [np.asarray(swb[:ics.num_swb]), [frame_len // 8]]
        ).astype(np.int64)
        ics.swb_offset_max = frame_len // 8
        for i in range(ics.num_windows - 1):
            if not (ics.scale_factor_grouping & (1 << (6 - i))):
                ics.num_window_groups += 1
                ics.window_group_length[ics.num_window_groups - 1] = 1
            else:
                ics.window_group_length[ics.num_window_groups - 1] += 1
        ics.sect_sfb_offset = []
        for g in range(ics.num_window_groups):
            offs = []
            offset = 0
            for i in range(ics.num_swb):
                if i + 1 == ics.num_swb:
                    width = frame_len // 8 - int(swb[i])
                else:
                    width = int(swb[i + 1]) - int(swb[i])
                width *= ics.window_group_length[g]
                offs.append(offset)
                offset += width
            offs.append(offset)
            ics.sect_sfb_offset.append(offs)
    else:
        raise AacError("bad window sequence")


def ics_info(ics: ICStream, ld: Bits, sf_index: int,
             frame_len: int) -> None:
    """ics_info (syntax.c:769-886), LC deployment (no MAIN/LTP data)."""
    if ld.get1():
        raise AacError("ics_reserved_bit set")
    ics.window_sequence = ld.get(2)
    ics.window_shape = ld.get1()
    if ics.window_sequence == EIGHT_SHORT_SEQUENCE:
        ics.max_sfb = ld.get(4)
        ics.scale_factor_grouping = ld.get(7)
    else:
        ics.max_sfb = ld.get(6)
    window_grouping_info(ics, sf_index, frame_len)
    if ics.max_sfb > ics.num_swb:
        raise AacError("max_sfb range")
    if ics.window_sequence != EIGHT_SHORT_SEQUENCE:
        ics.predictor_data_present = ld.get1()
        if ics.predictor_data_present:
            # LC object type: predictor bits belong to LTP/MAIN profiles
            raise AacError("prediction not supported (LC only)")


def section_data(ics: ICStream, ld: Bits) -> None:
    """section_data (syntax.c:1652-1812)."""
    if ics.window_sequence == EIGHT_SHORT_SEQUENCE:
        sect_bits = 3
    else:
        sect_bits = 5
    sect_esc_val = (1 << sect_bits) - 1

    for g in range(ics.num_window_groups):
        k = 0
        i = 0
        while k < ics.max_sfb:
            ics.sect_cb[g][i] = ld.get(4)
            if ics.sect_cb[g][i] == 12:
                raise AacError("codebook 12")
            if ics.sect_cb[g][i] == NOISE_HCB:
                ics.noise_used = 1
            if ics.sect_cb[g][i] in (INTENSITY_HCB, INTENSITY_HCB2):
                ics.is_used = 1
            sect_len = 0
            sect_len_incr = ld.get(sect_bits)
            while sect_len_incr == sect_esc_val:
                sect_len += sect_len_incr
                sect_len_incr = ld.get(sect_bits)
            sect_len += sect_len_incr
            ics.sect_start[g][i] = k
            ics.sect_end[g][i] = k + sect_len
            if k + sect_len > 8 * 15 and \
                    ics.window_sequence == EIGHT_SHORT_SEQUENCE:
                raise AacError("section overflow")
            for sfb in range(k, k + sect_len):
                ics.sfb_cb[g][sfb] = ics.sect_cb[g][i]
            k += sect_len
            i += 1
        ics.num_sec[g] = i
        if k != ics.max_sfb:
            raise AacError("section sum != max_sfb")


def decode_scale_factors(ics: ICStream, ld: Bits) -> None:
    """decode_scale_factors (syntax.c:1815-1897)."""
    scale_factor = ics.global_gain
    is_position = 0
    noise_energy = ics.global_gain - 90
    noise_pcm_flag = True

    for g in range(ics.num_window_groups):
        for sfb in range(ics.max_sfb):
            cb = ics.sfb_cb[g][sfb]
            if cb == ZERO_HCB:
                ics.scale_factors[g][sfb] = 0
            elif cb in (INTENSITY_HCB, INTENSITY_HCB2):
                t = huffman_scale_factor(ld)
                is_position += t - 60
                ics.scale_factors[g][sfb] = is_position
            elif cb == NOISE_HCB:
                if noise_pcm_flag:
                    noise_pcm_flag = False
                    t = ld.get(9) - 256
                else:
                    t = huffman_scale_factor(ld) - 60
                noise_energy += t
                ics.scale_factors[g][sfb] = noise_energy
            else:
                t = huffman_scale_factor(ld)
                scale_factor += t - 60
                if scale_factor < 0 or scale_factor > 255:
                    raise AacError("scalefactor out of range")
                ics.scale_factors[g][sfb] = scale_factor


def tns_data(ics: ICStream, ld: Bits) -> TnsInfo:
    """tns_data (syntax.c:1930-2004)."""
    tns = TnsInfo()
    if ics.window_sequence == EIGHT_SHORT_SEQUENCE:
        n_filt_bits, length_bits, order_bits = 1, 4, 3
    else:
        n_filt_bits, length_bits, order_bits = 2, 6, 5
    for w in range(ics.num_windows):
        tns.n_filt[w] = ld.get(n_filt_bits)
        if tns.n_filt[w]:
            tns.coef_res[w] = ld.get1()
            start_coef_bits = 4 if tns.coef_res[w] else 3
        for f in range(tns.n_filt[w]):
            tns.length[w][f] = ld.get(length_bits)
            tns.order[w][f] = ld.get(order_bits)
            if tns.order[w][f]:
                tns.direction[w][f] = ld.get1()
                tns.coef_compress[w][f] = ld.get1()
                coef_bits = start_coef_bits - tns.coef_compress[w][f]
                for i in range(tns.order[w][f]):
                    tns.coef[w][f][i] = ld.get(coef_bits)
    return tns


def pulse_data(ics: ICStream, ld: Bits):
    """pulse_data (syntax.c:888-918)."""
    number_pulse = ld.get(2)
    pulse_start_sfb = ld.get(6)
    if pulse_start_sfb > ics.num_swb:
        raise AacError("pulse_start_sfb range")
    offsets, amps = [], []
    for _ in range(number_pulse + 1):
        offsets.append(ld.get(5))
        amps.append(ld.get(4))
    return pulse_start_sfb, offsets, amps


def spectral_data(ics: ICStream, ld: Bits, frame_len: int) -> np.ndarray:
    """spectral_data (syntax.c:2070-2148) -> int16[frame_len]."""
    nshort = frame_len // 8
    spec = np.zeros(frame_len, np.int64)
    groups = 0
    for g in range(ics.num_window_groups):
        p = groups * nshort
        for i in range(ics.num_sec[g]):
            sect_cb = ics.sect_cb[g][i]
            inc = 2 if sect_cb >= FIRST_PAIR_HCB else 4
            if sect_cb in (ZERO_HCB, NOISE_HCB, INTENSITY_HCB,
                           INTENSITY_HCB2):
                p += (ics.sect_sfb_offset[g][ics.sect_end[g][i]] -
                      ics.sect_sfb_offset[g][ics.sect_start[g][i]])
            else:
                k = ics.sect_sfb_offset[g][ics.sect_start[g][i]]
                end = ics.sect_sfb_offset[g][ics.sect_end[g][i]]
                while k < end:
                    vals = huffman_spectral_data(sect_cb, ld)
                    spec[p:p + inc] = vals
                    p += inc
                    k += inc
        groups += ics.window_group_length[g]
    return spec


def pulse_decode(ics: ICStream, spec: np.ndarray, pul) -> None:
    """pulse_decode (pulse.c)."""
    start_sfb, offsets, amps = pul
    k = int(ics.swb_offset[start_sfb])
    for off, amp in zip(offsets, amps):
        k += off
        if k >= len(spec):
            raise AacError("pulse offset range")
        if spec[k] > 0:
            spec[k] += amp
        else:
            spec[k] -= amp


# --------------------------------------------------------------------------
# dequant + scaling (specrec.c quant_to_spec), float path
# --------------------------------------------------------------------------

def _iquant(q: np.ndarray) -> np.ndarray:
    """iquant (specrec.c:431-497), float branch: sign(q)*iq_table[|q|]."""
    aq = np.abs(q)
    if np.any(aq >= 8192):
        raise AacError("quantized value out of iq_table range")
    return np.where(q < 0, -T.IQ_TABLE[aq], T.IQ_TABLE[aq]).astype(F32)


def quant_to_spec(ics: ICStream, quant: np.ndarray,
                  frame_len: int) -> np.ndarray:
    """quant_to_spec (specrec.c:525-676): dequant, scale, deinterleave."""
    spec = np.zeros(frame_len, F32)
    nshort = frame_len // 8
    k = 0
    gindex = 0
    for g in range(ics.num_window_groups):
        j = 0
        gincrease = 0
        win_inc = int(ics.swb_offset[ics.num_swb])
        for sfb in range(ics.num_swb):
            width = int(ics.swb_offset[sfb + 1]) - int(ics.swb_offset[sfb])
            sf = ics.scale_factors[g][sfb] if sfb < ics.max_sfb else 0
            if sf < 0 or sf > 255:
                exp, frac = 0, 0
            else:
                exp, frac = sf >> 2, sf & 3
            scf = F32(T.POW2SF_TAB[exp] * T.POW2_TABLE[frac])
            wa = gindex + j
            for win in range(ics.window_group_length[g]):
                wb = wa
                qs = quant[k:k + width]
                spec[wb:wb + width] = _iquant(qs) * scf
                gincrease += width
                k += width
                wa += win_inc
            j += width
        gindex += gincrease
    return spec


# --------------------------------------------------------------------------
# PNS / MS / IS (pns.c, ms.c, is.c)
# --------------------------------------------------------------------------

def _parity(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1") & 1


def ne_rng(state) -> int:
    """ne_rng (common.c:235-245); state = [r1, r2] uint32."""
    r1, r2 = state
    t1 = r1 & 0xF5
    t2 = (r2 >> 25) & 0x63
    t1 = _parity(t1) << 31
    t2 = _parity(t2)
    state[0] = ((r1 >> 1) | t1) & 0xFFFFFFFF
    state[1] = ((r2 + r2) | t2) & 0xFFFFFFFF
    return (state[0] ^ state[1]) & 0xFFFFFFFF


def gen_rand_vector(sf: int, size: int, rng) -> np.ndarray:
    """gen_rand_vector (pns.c:76-102), float branch."""
    scale = F32(F32(1.0) / F32(size))
    vals = np.empty(size, F32)
    energy = F32(0.0)
    for i in range(size):
        r = ne_rng(rng)
        if r >= 0x80000000:
            r -= 0x100000000
        tmp = F32(scale * F32(r))
        vals[i] = tmp
        energy = F32(energy + F32(tmp * tmp))
    scale = F32(F32(1.0) / F32(math.sqrt(float(energy))))
    scale = F32(scale * F32(math.pow(2.0, 0.25 * sf)))
    return (vals * scale).astype(F32)


def pns_decode(ics_l: ICStream, ics_r: Optional[ICStream],
               spec_l: np.ndarray, spec_r: Optional[np.ndarray],
               frame_len: int, channel_pair: bool, rng) -> None:
    """pns_decode (pns.c:114-275), LC float path."""
    nshort = frame_len >> 3
    group = 0
    rng_dep = None
    for g in range(ics_l.num_window_groups):
        for b in range(ics_l.window_group_length[g]):
            for sfb in range(ics_l.max_sfb):
                if ics_l.is_noise(g, sfb):
                    offs = int(ics_l.swb_offset[sfb])
                    size = min(int(ics_l.swb_offset[sfb + 1]),
                               ics_l.swb_offset_max) - offs
                    if channel_pair and ics_r is not None and \
                            ics_r.is_noise(g, sfb) and \
                            (((ics_l.ms_mask_present == 1) and
                              ics_l.ms_used[g][sfb]) or
                             (ics_l.ms_mask_present == 2)):
                        # save RNG state for the correlated right channel
                        rng_dep = list(rng)
                    base = group * nshort + offs
                    spec_l[base:base + size] = gen_rand_vector(
                        ics_l.scale_factors[g][sfb], size, rng)
                if ics_r is not None and ics_r.is_noise(g, sfb):
                    offs = int(ics_r.swb_offset[sfb])
                    size = min(int(ics_r.swb_offset[sfb + 1]),
                               ics_r.swb_offset_max) - offs
                    base = group * nshort + offs
                    if channel_pair and \
                            (((ics_l.ms_mask_present == 1) and
                              ics_l.ms_used[g][sfb]) or
                             (ics_l.ms_mask_present == 2)):
                        spec_r[base:base + size] = gen_rand_vector(
                            ics_r.scale_factors[g][sfb], size, rng_dep)
                    else:
                        spec_r[base:base + size] = gen_rand_vector(
                            ics_r.scale_factors[g][sfb], size, rng)
            group += 1


def ms_decode(ics: ICStream, icsr: ICStream, l_spec, r_spec,
              frame_len: int) -> None:
    """ms_decode (ms.c:40-76)."""
    if ics.ms_mask_present < 1:
        return
    nshort = frame_len // 8
    group = 0
    for g in range(ics.num_window_groups):
        for b in range(ics.window_group_length[g]):
            for sfb in range(ics.max_sfb):
                if (ics.ms_used[g][sfb] or ics.ms_mask_present == 2) and \
                        not icsr.is_intensity(g, sfb) and \
                        not ics.is_noise(g, sfb):
                    lo = int(ics.swb_offset[sfb])
                    hi = min(int(ics.swb_offset[sfb + 1]),
                             ics.swb_offset_max)
                    k = group * nshort
                    tmp = l_spec[k + lo:k + hi] - r_spec[k + lo:k + hi]
                    l_spec[k + lo:k + hi] = (l_spec[k + lo:k + hi] +
                                             r_spec[k + lo:k + hi])
                    r_spec[k + lo:k + hi] = tmp
            group += 1


def is_decode(ics: ICStream, icsr: ICStream, l_spec, r_spec,
              frame_len: int) -> None:
    """is_decode (is.c:50-119), float path."""
    nshort = frame_len // 8
    group = 0
    for g in range(icsr.num_window_groups):
        for b in range(icsr.window_group_length[g]):
            for sfb in range(icsr.max_sfb):
                if icsr.is_intensity(g, sfb):
                    scale = F32(math.pow(
                        0.5, 0.25 * icsr.scale_factors[g][sfb]))
                    lo = int(icsr.swb_offset[sfb])
                    hi = min(int(icsr.swb_offset[sfb + 1]),
                             ics.swb_offset_max)
                    k = group * nshort
                    seg = (l_spec[k + lo:k + hi] * scale).astype(F32)
                    # invert_intensity(ics, g, sfb): ms_mask 1 -> 1-2*ms_used
                    if ics.ms_mask_present == 1 and ics.ms_used[g][sfb]:
                        inv = -1
                    else:
                        inv = 1
                    if icsr.is_intensity(g, sfb) != inv:
                        seg = -seg
                    r_spec[k + lo:k + hi] = seg
            group += 1


# --------------------------------------------------------------------------
# TNS (tns.c)
# --------------------------------------------------------------------------

TNS_TABS = {(0, 3): T.TNS_COEF_0_3, (0, 4): T.TNS_COEF_0_4,
            (1, 3): T.TNS_COEF_1_3, (1, 4): T.TNS_COEF_1_4}


def tns_decode_coef(order: int, coef_res_bits: int, coef_compress: int,
                    coef: list) -> np.ndarray:
    """tns_decode_coef (tns.c:188-227) -> lpc[order+1] float32."""
    tab = TNS_TABS[(coef_compress, coef_res_bits)]
    tmp2 = [F32(tab[coef[i]]) for i in range(order)]
    a = np.zeros(TNS_MAX_ORDER + 1, F32)
    a[0] = F32(1.0)
    for m in range(1, order + 1):
        b = np.zeros(TNS_MAX_ORDER + 1, F32)
        for i in range(1, m):
            b[i] = F32(a[i] + F32(tmp2[m - 1] * a[m - i]))
        for i in range(1, m):
            a[i] = b[i]
        a[m] = tmp2[m - 1]
    return a


def tns_ar_filter(spec: np.ndarray, start: int, size: int, inc: int,
                  lpc: np.ndarray, order: int) -> None:
    """tns_ar_filter (tns.c:230-271): in-place all-pole, float32."""
    state = np.zeros(2 * TNS_MAX_ORDER, F32)
    state_index = 0
    pos = start
    for _ in range(size):
        y = spec[pos]
        for j in range(order):
            y = F32(y - F32(state[state_index + j] * lpc[j + 1]))
        state_index -= 1
        if state_index < 0:
            state_index = order - 1
        state[state_index] = y
        state[state_index + order] = y
        spec[pos] = y
        pos += inc


def tns_decode_frame(ics: ICStream, tns: Optional[TnsInfo], sf_index: int,
                     spec: np.ndarray, frame_len: int) -> None:
    """tns_decode_frame (tns.c:82-131), LC."""
    if not ics.tns_data_present or tns is None:
        return
    nshort = frame_len // 8
    is_short = ics.window_sequence == EIGHT_SHORT_SEQUENCE
    sbf_max = TNS_SBF_MAX[sf_index][1 if is_short else 0]
    for w in range(ics.num_windows):
        bottom = ics.num_swb
        for f in range(tns.n_filt[w]):
            top = bottom
            bottom = max(top - tns.length[w][f], 0)
            tns_order = min(tns.order[w][f], TNS_MAX_ORDER)
            if not tns_order:
                continue
            lpc = tns_decode_coef(tns_order, tns.coef_res[w] + 3,
                                  tns.coef_compress[w][f], tns.coef[w][f])
            start = min(bottom, sbf_max)
            start = min(start, ics.max_sfb)
            start = min(int(ics.swb_offset[start]), ics.swb_offset_max)
            end = min(top, sbf_max)
            end = min(end, ics.max_sfb)
            end = min(int(ics.swb_offset[end]), ics.swb_offset_max)
            size = end - start
            if size <= 0:
                continue
            if tns.direction[w][f]:
                inc = -1
                start = end - 1
            else:
                inc = 1
            tns_ar_filter(spec, w * nshort + start, size, inc, lpc,
                          tns_order)


# --------------------------------------------------------------------------
# complex FFT (cfft.c, cfftf1pos path used by the IMDCT) — float32 numpy
# --------------------------------------------------------------------------

def _cffti1(n: int):
    """cffti1 (cfft.c:863-957): factorization + float twiddles."""
    ntryh = [3, 4, 2, 5]
    nl, nf = n, 0
    facs = []
    j = 0
    while nl != 1:
        j += 1
        ntry = ntryh[j - 1] if j <= 4 else ntry + 2
        while nl % ntry == 0:
            nl //= ntry
            nf += 1
            facs.append(ntry)
            if ntry == 2 and nf != 1:
                facs = [2] + facs[:-1]
    ifac = facs

    wa_re = np.zeros(n, F32)
    wa_im = np.zeros(n, F32)
    argh = F32(F32(F32(2.0) * F32(math.pi)) / F32(n))
    i = 0
    l1 = 1
    for ip in ifac:
        ld = 0
        l2 = l1 * ip
        ido = n // l2
        for _ in range(ip - 1):
            i1 = i
            wa_re[i] = 1.0
            wa_im[i] = 0.0
            ld += l1
            fi = F32(0.0)
            argld = F32(F32(ld) * argh)
            for _ii in range(ido):
                i += 1
                fi = F32(fi + F32(1.0))
                arg = F32(fi * argld)
                wa_re[i] = F32(math.cos(float(arg)))
                wa_im[i] = F32(math.sin(float(arg)))
            if ip > 5:
                wa_re[i1] = wa_re[i]
                wa_im[i1] = wa_im[i]
        l1 = l2
    return ifac, wa_re, wa_im


_CFFT_CACHE = {}


def _cfft_plan(n: int):
    if n not in _CFFT_CACHE:
        _CFFT_CACHE[n] = _cffti1(n)
    return _CFFT_CACHE[n]


def _passf2pos(ido, l1, cre, cim, wre, wim):
    """passf2pos (cfft.c:56-105), vectorized over (k, i)."""
    cc_re = cre.reshape(l1, 2, ido)
    cc_im = cim.reshape(l1, 2, ido)
    out_re = np.empty((2, l1, ido), F32)
    out_im = np.empty((2, l1, ido), F32)
    out_re[0] = cc_re[:, 0] + cc_re[:, 1]
    out_im[0] = cc_im[:, 0] + cc_im[:, 1]
    t2_re = cc_re[:, 0] - cc_re[:, 1]
    t2_im = cc_im[:, 0] - cc_im[:, 1]
    if ido == 1:
        out_re[1] = t2_re
        out_im[1] = t2_im
    else:
        # ComplexMult(&IM, &RE, IM(t2), RE(t2), RE(wa), IM(wa)):
        # im = im_t2*wr + re_t2*wi ; re = re_t2*wr - im_t2*wi
        out_im[1] = t2_im * wre + t2_re * wim
        out_re[1] = t2_re * wre - t2_im * wim
    return out_re.reshape(-1), out_im.reshape(-1)


def _passf4pos(ido, l1, cre, cim, w1re, w1im, w2re, w2im, w3re, w3im):
    """passf4pos (cfft.c:334-430), vectorized over (k, i)."""
    cc_re = cre.reshape(l1, 4, ido)
    cc_im = cim.reshape(l1, 4, ido)
    t2_re = cc_re[:, 0] + cc_re[:, 2]
    t1_re = cc_re[:, 0] - cc_re[:, 2]
    t2_im = cc_im[:, 0] + cc_im[:, 2]
    t1_im = cc_im[:, 0] - cc_im[:, 2]
    t3_re = cc_re[:, 1] + cc_re[:, 3]
    t4_im = cc_re[:, 1] - cc_re[:, 3]
    t3_im = cc_im[:, 3] + cc_im[:, 1]
    t4_re = cc_im[:, 3] - cc_im[:, 1]

    out_re = np.empty((4, l1, ido), F32)
    out_im = np.empty((4, l1, ido), F32)
    out_re[0] = t2_re + t3_re
    out_im[0] = t2_im + t3_im
    c3_re = t2_re - t3_re
    c3_im = t2_im - t3_im
    c2_re = t1_re + t4_re
    c2_im = t1_im + t4_im
    c4_re = t1_re - t4_re
    c4_im = t1_im - t4_im
    if ido == 1:
        out_re[1], out_im[1] = c2_re, c2_im
        out_re[2], out_im[2] = c3_re, c3_im
        out_re[3], out_im[3] = c4_re, c4_im
    else:
        out_im[1] = c2_im * w1re + c2_re * w1im
        out_re[1] = c2_re * w1re - c2_im * w1im
        out_im[2] = c3_im * w2re + c3_re * w2im
        out_re[2] = c3_re * w2re - c3_im * w2im
        out_im[3] = c4_im * w3re + c4_re * w3im
        out_re[3] = c4_re * w3re - c4_im * w3im
    return out_re.reshape(-1), out_im.reshape(-1)


def cfftb(n: int, re: np.ndarray, im: np.ndarray):
    """cfftb (cfft.c:858-861) = cfftf1pos with isign=+1."""
    ifac, wa_re, wa_im = _cfft_plan(n)
    l1 = 1
    iw = 0
    for ip in ifac:
        l2 = ip * l1
        ido = n // l2
        if ip == 4:
            w1re = wa_re[iw:iw + ido]
            w1im = wa_im[iw:iw + ido]
            w2re = wa_re[iw + ido:iw + 2 * ido]
            w2im = wa_im[iw + ido:iw + 2 * ido]
            w3re = wa_re[iw + 2 * ido:iw + 3 * ido]
            w3im = wa_im[iw + 2 * ido:iw + 3 * ido]
            re, im = _passf4pos(ido, l1, re, im, w1re, w1im, w2re, w2im,
                                w3re, w3im)
        elif ip == 2:
            w1re = wa_re[iw:iw + ido]
            w1im = wa_im[iw:iw + ido]
            re, im = _passf2pos(ido, l1, re, im, w1re, w1im)
        else:
            raise AacError(f"cfft radix {ip} not needed for LC")
        l1 = l2
        iw += (ip - 1) * ido
    return re, im


# --------------------------------------------------------------------------
# IMDCT + filterbank (mdct.c faad_imdct, filtbank.c ifilter_bank)
# --------------------------------------------------------------------------

def faad_imdct(N: int, x_in: np.ndarray) -> np.ndarray:
    """faad_imdct (mdct.c:122-230), float path."""
    tab = T.MDCT_TAB_2048 if N == 2048 else T.MDCT_TAB_256
    N2, N4, N8 = N // 2, N // 4, N // 8
    sc_re = tab[:, 0]
    sc_im = tab[:, 1]

    # pre-IFFT: ComplexMult(&IM(Z1), &RE(Z1), x[2k], x[N2-1-2k], re, im)
    a = x_in[0:N2:2].astype(F32)
    b = x_in[N2 - 1::-2][:N4].astype(F32)
    z_im = a * sc_re + b * sc_im
    z_re = b * sc_re - a * sc_im

    z_re, z_im = cfftb(N4, z_re.copy(), z_im.copy())

    # post-IFFT: ComplexMult(&IM, &RE, IM(x), RE(x), re, im)
    new_im = z_im * sc_re + z_re * sc_im
    new_re = z_re * sc_re - z_im * sc_im
    z_re, z_im = new_re, new_im

    out = np.empty(N, F32)
    k = np.arange(N8)
    out[0:N4:2] = z_im[N8 + k[: N8]]
    out[1:N4:2] = -z_re[N8 - 1 - k[: N8]]
    out[N4:N2:2] = z_re[k[: N8]]
    out[N4 + 1:N2:2] = -z_im[N4 - 1 - k[: N8]]
    out[N2:N2 + N4:2] = z_re[N8 + k[: N8]]
    out[N2 + 1:N2 + N4:2] = -z_im[N8 - 1 - k[: N8]]
    out[N2 + N4::2] = -z_im[k[: N8]]
    out[N2 + N4 + 1::2] = z_re[N4 - 1 - k[: N8]]
    return out


def ifilter_bank(window_sequence: int, window_shape: int,
                 window_shape_prev: int, freq_in: np.ndarray,
                 overlap: np.ndarray, frame_len: int = 1024):
    """ifilter_bank (filtbank.c:165-330), LC.  Returns (time_out,
    new_overlap); overlap is the fb_intermed state."""
    nlong = frame_len
    nshort = frame_len // 8
    trans = nshort // 2
    nflat_ls = (nlong - nshort) // 2

    long_w = [T.SINE_LONG_1024, T.KBD_LONG_1024]
    short_w = [T.SINE_SHORT_128, T.KBD_SHORT_128]
    window_long = long_w[window_shape]
    window_long_prev = long_w[window_shape_prev]
    window_short = short_w[window_shape]
    window_short_prev = short_w[window_shape_prev]

    time_out = np.zeros(nlong, F32)
    new_overlap = np.zeros(nlong, F32)

    if window_sequence == ONLY_LONG_SEQUENCE:
        transf = faad_imdct(2 * nlong, freq_in)
        time_out[:] = overlap + (transf[:nlong] * window_long_prev)
        new_overlap[:] = transf[nlong:] * window_long[::-1]
    elif window_sequence == LONG_START_SEQUENCE:
        transf = faad_imdct(2 * nlong, freq_in)
        time_out[:] = overlap + (transf[:nlong] * window_long_prev)
        new_overlap[:nflat_ls] = transf[nlong:nlong + nflat_ls]
        new_overlap[nflat_ls:nflat_ls + nshort] = (
            transf[nlong + nflat_ls:nlong + nflat_ls + nshort] *
            window_short[::-1])
        # rest stays zero
    elif window_sequence == EIGHT_SHORT_SEQUENCE:
        transf = np.zeros(2 * nlong, F32)
        for w in range(8):
            transf[2 * nshort * w:2 * nshort * (w + 1)] = \
                faad_imdct(2 * nshort, freq_in[w * nshort:(w + 1) * nshort])
        ws = window_short
        wsr = window_short[::-1]
        wsp = window_short_prev
        time_out[:nflat_ls] = overlap[:nflat_ls]
        i = np.arange(nshort)
        time_out[nflat_ls:nflat_ls + nshort] = (
            overlap[nflat_ls:nflat_ls + nshort] +
            transf[0 * nshort + i] * wsp)
        for blk in range(1, 4):
            seg = (overlap[nflat_ls + blk * nshort + i] +
                   (transf[(2 * blk - 1) * nshort + i] * wsr) +
                   (transf[(2 * blk) * nshort + i] * ws))
            time_out[nflat_ls + blk * nshort + i] = seg
        it = np.arange(trans)
        time_out[nflat_ls + 4 * nshort + it] = (
            overlap[nflat_ls + 4 * nshort + it] +
            (transf[7 * nshort + it] * wsr[it]) +
            (transf[8 * nshort + it] * ws[it]))

        ih = np.arange(trans, nshort)
        new_overlap[nflat_ls + 4 * nshort + ih - nlong] = (
            (transf[7 * nshort + ih] * wsr[ih]) +
            (transf[8 * nshort + ih] * ws[ih]))
        for blk in range(5, 8):
            new_overlap[nflat_ls + blk * nshort + i - nlong] = (
                (transf[(2 * blk - 1) * nshort + i] * wsr) +
                (transf[(2 * blk) * nshort + i] * ws))
        new_overlap[nflat_ls + 8 * nshort + i - nlong] = (
            transf[15 * nshort + i] * wsr)
        # [nflat_ls+nshort ...] stays zero
    elif window_sequence == LONG_STOP_SEQUENCE:
        transf = faad_imdct(2 * nlong, freq_in)
        time_out[:nflat_ls] = overlap[:nflat_ls]
        i = np.arange(nshort)
        time_out[nflat_ls + i] = (overlap[nflat_ls + i] +
                                  transf[nflat_ls + i] * window_short_prev)
        j = np.arange(nflat_ls)
        time_out[nflat_ls + nshort + j] = (
            overlap[nflat_ls + nshort + j] + transf[nflat_ls + nshort + j])
        new_overlap[:] = transf[nlong:] * window_long[::-1]
    else:
        raise AacError("bad window sequence")
    return time_out, new_overlap


# --------------------------------------------------------------------------
# output conversion (output.c to_PCM_16bit, HAS_LRINTF path)
# --------------------------------------------------------------------------

def to_pcm_16bit(channel_data: list) -> np.ndarray:
    """float -> int16 per output.c to_PCM_16bit with HAS_LRINTF UNSET —
    the reference build's config.h has `#undef HAVE_LRINTF`, so `lrintf`
    is `(int32_t)(f)` truncation and CLIP adds +/-0.5 first:
    round-half-away-from-zero with saturation (output.c:64-77,399-402)."""
    chans = []
    for x in channel_data:
        x = np.asarray(x, F32)
        pos = x >= F32(0.0)
        x = np.where(pos, x + F32(0.5), x + F32(-0.5)).astype(F32)
        x = np.where(pos & (x >= F32(32767.0)), F32(32767.0), x)
        x = np.where(~pos & (x <= F32(-32768.0)), F32(-32768.0), x)
        chans.append(np.trunc(x).astype(np.int64).astype(np.int16))
    out = np.empty(len(chans[0]) * len(chans), np.int16)
    for c, x in enumerate(chans):
        out[c::len(chans)] = x
    return out


# --------------------------------------------------------------------------
# decoder object (decoder.c NeAACDec* semantics for ADTS LC)
# --------------------------------------------------------------------------

class AacDecoder:
    """NeAACDec{Open,Init,Decode} equivalent for ADTS AAC-LC streams
    (decoder.c; state per internal channel: overlap buffer + previous
    window shape; PNS RNG r1=r2=1 at open, decoder.c:151-152)."""

    def __init__(self):
        self.sf_index = None
        self.channels = None
        self.frame_len = 1024
        self.fb_intermed = {}
        self.window_shape_prev = {}
        self.rng = [1, 1]
        self.frame = 0
        # HE-AAC (SBR/PS) state, one sbr_info per channel element
        self.sbr = {}
        self.ps_used = {}
        self.ps_used_global = False
        self.sbr_present = False
        self.force_up = False        # implicit signalling (<= 24 kHz)
        self.fr_ch_ele = 0
        self.element_output_channels = {}
        # batched device filterbank support (codecs/aac_batch.py):
        # when a list, _reconstruct appends (ch, seq, shape, spec) jobs
        # instead of running ifilter_bank on host
        self._defer_jobs = None

    # -- NeAACDecInit: parse the first ADTS header only --
    def init(self, data: bytes) -> tuple:
        ld = Bits(data)
        adts = self._adts_header(ld)
        self.sf_index = adts["sf_index"]
        self.channels = adts["channel_configuration"]
        return SAMPLE_RATES[self.sf_index], self.channels

    def _adts_header(self, ld: Bits) -> dict:
        """adts_fixed/variable_header (syntax.c:2271-2337)."""
        syncword = ld.get(12)
        if syncword != 0xFFF:
            raise AacError("bad ADTS sync")
        h = {}
        h["id"] = ld.get1()
        h["layer"] = ld.get(2)
        h["protection_absent"] = ld.get1()
        h["profile"] = ld.get(2)
        h["sf_index"] = ld.get(4)
        h["private_bit"] = ld.get1()
        h["channel_configuration"] = ld.get(3)
        h["original"] = ld.get1()
        h["home"] = ld.get1()
        h["copyright_id_bit"] = ld.get1()
        h["copyright_id_start"] = ld.get1()
        h["frame_length"] = ld.get(13)
        h["buffer_fullness"] = ld.get(11)
        h["raw_data_blocks"] = ld.get(2)
        if not h["protection_absent"]:
            ld.get(16)  # crc_check
        if h["profile"] not in (0, 1):
            raise AacError(f"profile {h['profile']} unsupported (LC only)")
        return h

    def _overlap(self, ch: int) -> np.ndarray:
        if ch not in self.fb_intermed:
            self.fb_intermed[ch] = np.zeros(self.frame_len, F32)
            self.window_shape_prev[ch] = 0
        return self.fb_intermed[ch]

    # -- element decoders --

    def _individual_channel_stream(self, ld: Bits, ics: ICStream,
                                   common_window: bool):
        ics.global_gain = ld.get(8)
        if not common_window:
            ics_info(ics, ld, self.sf_index, self.frame_len)
        section_data(ics, ld)
        decode_scale_factors(ics, ld)
        ics.pulse_data_present = ld.get1()
        if ics.pulse_data_present:
            if ics.window_sequence == EIGHT_SHORT_SEQUENCE:
                raise AacError("pulse data in short block")
            ics.pulse = pulse_data(ics, ld)
        ics.tns_data_present = ld.get1()
        if ics.tns_data_present:
            ics.tns = tns_data(ics, ld)
        if ld.get1():
            raise AacError("gain control (SSR) unsupported")
        spec = spectral_data(ics, ld, self.frame_len)
        if ics.pulse_data_present:
            pulse_decode(ics, spec, ics.pulse)
        return spec

    def _reconstruct(self, ics: ICStream, spec_f32: np.ndarray, ch: int):
        tns_decode_frame(ics, ics.tns, self.sf_index, spec_f32,
                         self.frame_len)
        if self._defer_jobs is not None:
            if self.sbr_present or self.force_up:
                raise AacError("deferred filterbank is plain-LC only "
                               "(SBR consumes time_out mid-frame)")
            self._defer_jobs.append((ch, ics.window_sequence,
                                     ics.window_shape, spec_f32))
            return None
        overlap = self._overlap(ch)
        time_out, new_overlap = ifilter_bank(
            ics.window_sequence, ics.window_shape,
            self.window_shape_prev[ch], spec_f32, overlap, self.frame_len)
        self.fb_intermed[ch] = new_overlap
        self.window_shape_prev[ch] = ics.window_shape
        return time_out

    def _decode_sce(self, ld: Bits, ch: int):
        _tag = ld.get(4)
        ics = ICStream()
        spec = self._individual_channel_stream(ld, ics, False)
        # peek: an immediately following fill element carries this
        # element's SBR data and must be read before reconstruction
        # (syntax.c:92-103 in single_lfe_channel_element)
        if ld.show(3) == ID_FIL:
            ld.flush(3)
            self._fill_element(ld, sbr_ele=self.fr_ch_ele,
                               ele_id=ID_SCE)
        coef = quant_to_spec(ics, spec, self.frame_len)
        if ics.noise_used:
            pns_decode(ics, None, coef, None, self.frame_len, False,
                       self.rng)
        time_out = self._reconstruct(ics, coef, ch)
        return self._apply_sbr_sce(time_out, ch)

    def _sbr_for(self, ele: int, ele_id: int):
        """specrec.c:1046-1054 / syntax.c:1070-1080 lazy init."""
        from wmix_tpu_torch.codecs import sbr as sbr_mod
        if ele not in self.sbr:
            self.sbr[ele] = sbr_mod.SbrInfo(
                self.frame_len, ele_id,
                2 * SAMPLE_RATES[self.sf_index], 0)
        return self.sbr[ele]

    def _apply_sbr_sce(self, time_out, ch):
        """reconstruct_single_channel SBR tail (specrec.c:1038-1100)."""
        from wmix_tpu_torch.codecs import sbr as sbr_mod
        ele = self.fr_ch_ele
        if not (self.sbr_present or self.force_up):
            self.element_output_channels[ele] = 1
            return time_out
        sbr = self._sbr_for(ele, ID_SCE)
        if self.ps_used.get(ele):
            left, right, _ret = sbr_mod.sbr_decode_single_frame_ps(
                sbr, np.asarray(time_out, F32))
            self.element_output_channels[ele] = 2
            return (left, right)
        out, _ret = sbr_mod.sbr_decode_single_frame(
            sbr, np.asarray(time_out, F32))
        if self.element_output_channels.get(ele) == 2:
            # copy L to R when PS vanished mid-stream (specrec.c:1086)
            return (out, out.copy())
        self.element_output_channels[ele] = 1
        return out

    def _decode_cpe(self, ld: Bits, ch: int):
        _tag = ld.get(4)
        ics1, ics2 = ICStream(), ICStream()
        common_window = bool(ld.get1())
        if common_window:
            ics_info(ics1, ld, self.sf_index, self.frame_len)
            ics1.ms_mask_present = ld.get(2)
            if ics1.ms_mask_present == 3:
                raise AacError("ms_mask_present == 3")
            if ics1.ms_mask_present == 1:
                for g in range(ics1.num_window_groups):
                    for sfb in range(ics1.max_sfb):
                        ics1.ms_used[g][sfb] = ld.get1()
            # copy ics info into ics2 (memcpy in C)
            import copy
            ics2 = copy.deepcopy(ics1)
            # per-channel fields reset by individual_channel_stream parse
        else:
            ics1.ms_mask_present = 0

        spec1 = self._individual_channel_stream(ld, ics1, common_window)
        spec2 = self._individual_channel_stream(ld, ics2, common_window)

        coef1 = quant_to_spec(ics1, spec1, self.frame_len)
        coef2 = quant_to_spec(ics2, spec2, self.frame_len)

        pns_decode(ics1, ics2, coef1, coef2, self.frame_len,
                   bool(ics1.ms_mask_present), self.rng)
        ms_decode(ics1, ics2, coef1, coef2, self.frame_len)
        is_decode(ics1, ics2, coef1, coef2, self.frame_len)

        if ld.show(3) == ID_FIL:
            ld.flush(3)
            self._fill_element(ld, sbr_ele=self.fr_ch_ele,
                               ele_id=ID_CPE)

        t1 = self._reconstruct(ics1, coef1, ch)
        t2 = self._reconstruct(ics2, coef2, ch + 1)
        if self.sbr_present or self.force_up:
            from wmix_tpu_torch.codecs import sbr as sbr_mod
            sbr = self._sbr_for(self.fr_ch_ele, ID_CPE)
            t1, t2, _ret = sbr_mod.sbr_decode_couple_frame(
                sbr, np.asarray(t1, F32), np.asarray(t2, F32))
        return t1, t2

    def _fill_element(self, ld: Bits, sbr_ele: int = -1,
                      ele_id: int = ID_SCE):
        """fill_element (syntax.c:1042-1120): SBR data or skip."""
        from wmix_tpu_torch.codecs import sbr as sbr_mod
        count = ld.get(4)
        if count == 15:
            count += ld.get(8) - 1
        if count > 0 and ld.show(4) in (13, 14):
            # EXT_SBR_DATA(_CRC)
            if sbr_ele < 0:
                raise AacError("SBR data outside channel element")
            sbr = self._sbr_for(sbr_ele, ele_id)
            self.sbr_present = True
            sbr.ret = sbr_mod.sbr_extension_data(ld, sbr, count, 0)
            if sbr.ps_used:
                self.ps_used[sbr_ele] = 1
                self.ps_used_global = True
            return
        # extension_payload consumed as opaque bytes (no DRC use)
        for _ in range(count):
            ld.get(8)

    def _data_stream_element(self, ld: Bits):
        _tag = ld.get(4)
        byte_aligned = ld.get1()
        count = ld.get(8)
        if count == 255:
            count += ld.get(8)
        if byte_aligned:
            ld.byte_align()
        for _ in range(count):
            ld.get(8)

    def _program_config_element(self, ld: Bits):
        """program_config_element (syntax.c:174-322): parse/skip."""
        ld.get(4)   # element_instance_tag
        ld.get(2)   # object_type
        ld.get(4)   # sf_index
        num_front = ld.get(4)
        num_side = ld.get(4)
        num_back = ld.get(4)
        num_lfe = ld.get(2)
        num_assoc = ld.get(3)
        num_cc = ld.get(4)
        if ld.get1():
            ld.get(4)
        if ld.get1():
            ld.get(4)
        if ld.get1():
            ld.get(3)
        for _ in range(num_front + num_side + num_back):
            ld.get(1 + 4)
        for _ in range(num_lfe + num_assoc):
            ld.get(4)
        for _ in range(num_cc):
            ld.get(1 + 4)
        ld.byte_align()
        n = ld.get(8)
        for _ in range(n):
            ld.get(8)

    # -- NeAACDecDecode --
    def decode(self, data: bytes):
        """Decode one ADTS frame; returns (pcm int16 interleaved,
        bytes_consumed, channels, samplerate).  `data` must start at the
        ADTS header and contain the full frame."""
        ld = Bits(data)
        adts = self._adts_header(ld)
        if self.sf_index is None:
            self.sf_index = adts["sf_index"]
            self.channels = adts["channel_configuration"]
        # implicit signalling: faad (default dontUpSampleImplicitSBR=0)
        # always upsamples <=24 kHz streams 2x through the SBR QMF bank
        # (decoder.c:363-371); PS up-matrixes mono to stereo when the
        # SBR extension carries PS data
        self.force_up = SAMPLE_RATES[self.sf_index] <= 24000

        chans = {}
        ch_base = 0
        self.fr_ch_ele = 0
        while True:
            el = ld.get(3)
            if el == ID_END:
                break
            if el == ID_SCE:
                out = self._decode_sce(ld, ch_base)
                if isinstance(out, tuple):      # PS produced stereo
                    chans[ch_base] = out[0]
                    chans[ch_base + 1] = out[1]
                    ch_base += 2
                else:
                    chans[ch_base] = out
                    ch_base += 1
                self.fr_ch_ele += 1
            elif el == ID_CPE:
                t1, t2 = self._decode_cpe(ld, ch_base)
                chans[ch_base] = t1
                chans[ch_base + 1] = t2
                ch_base += 2
                self.fr_ch_ele += 1
            elif el == ID_FIL:
                self._fill_element(ld)
            elif el == ID_DSE:
                self._data_stream_element(ld)
            elif el == ID_PCE:
                self._program_config_element(ld)
            else:
                raise AacError(f"element {el} unsupported (LC)")
        ld.byte_align()

        # upMatrix: a PS-capable build always outputs 2 channels for
        # mono streams, duplicating the single channel (decoder.c:
        # 1056-1063, output.c:110-121) — PS itself replaces the copy
        # when present
        if len(chans) == 1:
            only = chans[sorted(chans)[0]]
            chans = {0: only, 1: only}

        self.frame += 1
        if self.frame <= 1 or self._defer_jobs is not None:
            # faad suppresses the first frame's output (filterbank
            # priming, decoder.c:1187-1193); state still advances.
            # Deferred mode: pcm is assembled by the batch driver.
            pcm = np.zeros(0, np.int16)
        else:
            pcm = to_pcm_16bit([chans[c] for c in sorted(chans)])
        consumed = (ld.processed() + 7) // 8
        freq = SAMPLE_RATES[self.sf_index]
        if self.sbr_present or self.force_up:
            freq *= 2      # decoder.c:1143-1148
        return pcm, consumed, len(chans), freq

    def decode_deferred(self, data: bytes):
        """One ADTS frame with the inverse filterbank deferred to a
        batched device program (codecs/aac_batch.py).  Host work stops
        after TNS; returns (jobs, consumed, nch, freq, emit) where jobs
        is [(ch, window_sequence, window_shape, spec_f32[1024]), ...]
        and emit is False while faad's first-frame suppression holds."""
        self._defer_jobs = []
        try:
            _pcm, consumed, nch, freq = self.decode(data)
        finally:
            jobs, self._defer_jobs = self._defer_jobs, None
        return jobs, consumed, nch, freq, self.frame > 1


# --------------------------------------------------------------------------
# aacType.c wrapper semantics (aac_decode :125-188, aac_decode2 :198-255)
# --------------------------------------------------------------------------

def _find_adts(data: bytes):
    """The header scan loop in aac_decode (aacType.c:138-158): find sync,
    return (offset, frame_len) or (None, 0)."""
    count = 0
    n = len(data)
    while count < n - 7:
        if data[count] == 0xFF and (data[count + 1] & 0xF0) == 0xF0:
            frame_len = ((data[count + 3] & 0x3) << 11) | \
                (data[count + 4] << 3) | (data[count + 5] >> 5)
            return count, frame_len
        count += 1
    return None, 0


def aac_decode(dec: Optional[AacDecoder], data: bytes):
    """aac_decode (aacType.c:125-188) semantics.

    Returns (dec, pcm_bytes, bytes_consumed, chn, freq) — pcm_bytes is
    hInfo.samples * hInfo.channels BYTES like the C (which conflates
    channels with bytes-per-sample; for 16-bit output the two coincide).
    pcm_bytes is None when data is insufficient (C returns 0 with
    bytesConsumed = missing byte count)."""
    off, frame_len = _find_adts(data)
    if off is None or frame_len == 0:
        return dec, None, 0, 0, 0
    if len(data) - off < frame_len:
        return dec, None, frame_len - (len(data) - off), 0, 0
    if dec is None:
        dec = AacDecoder()
        dec.init(data[off:off + frame_len])
    pcm, consumed, chn, freq = dec.decode(data[off:off + frame_len])
    # hInfo.samples = total samples (frames*channels); the C memcpy moves
    # samples * channels BYTES = all bytes iff channels == 2, half for
    # mono (a reference quirk preserved at the wrapper layer by callers)
    raw = pcm.tobytes()
    n_bytes = pcm.size * chn
    return dec, raw[:n_bytes], consumed + off, chn, freq


def aac_decode2(dec: Optional[AacDecoder], f):
    """aac_decode2 (aacType.c:198-255): fd-based single-frame decode.
    `f` is a binary file object.  Returns (dec, pcm_bytes, chn, freq) or
    (dec, None, 0, 0) on EOF."""
    # scan for sync byte pair
    while True:
        b = f.read(2)
        if len(b) != 2:
            return dec, None, 0, 0
        if b[0] == 0xFF and (b[1] & 0xF0) == 0xF0:
            rest = f.read(5)
            if len(rest) != 5:
                return dec, None, 0, 0
            hdr = b + rest
            frame_len = ((hdr[3] & 0x3) << 11) | (hdr[4] << 3) | \
                (hdr[5] >> 5)
            break
        f.seek(-1, 1)
    body = f.read(frame_len - 7)
    if len(body) != frame_len - 7:
        return dec, None, 0, 0
    frame = hdr + body
    if dec is None:
        dec = AacDecoder()
        dec.init(frame)
    pcm, _consumed, chn, freq = dec.decode(frame)
    raw = pcm.tobytes()
    return dec, raw[:pcm.size * chn], chn, freq
