"""MPEG-1/2 Layer III decoder, bit-exact vs the reference's libmad build.

The daemon plays MP3 through libmad 0.15.1b compiled with FPM_DEFAULT +
OPT_SPEED (pkg/libmad-0.15.1b.tar.gz via Makefile:258-266), whose entire
pipeline is 32-bit integer arithmetic:

    mad_f_mul(x, y) = (x >> 12) * (y >> 16)        (fixed.h:436)

with Q28 fixed-point values, OPT_SSO synthesis (dct32 outputs rounded
``(x + 2048) >> 12``, a pre-shifted D window, plain int32 MACs and a
final ``>> 2`` — synth.c:97-530).  This module reproduces that pipeline
in numpy int32/int64 with identical wraparound and shift semantics:

  frame sync + header        (frame.c:120-432)
  side info / scalefactors   (layer3.c:505-780)
  Huffman + requantization   (layer3.c:922-1260, rq_table x^(4/3))
  joint stereo / reorder     (layer3.c:1281-1530)
  alias reduction            (layer3.c:1532-1563)
  IMDCT 36 (Lee fast DCT-IV) (layer3.c:1589-1763)
  windowing + overlap-add    (layer3.c:1909-2270)
  polyphase synthesis dct32  (synth.c:126-660)

Constant data lives in _mp3_tables.py (generated, see
oracle/gen_mp3_tables.py).  The bitstream layer (sync, bit reservoir,
recoverable-error skipping) matches the mad_decoder sync flow the daemon
uses (wmixTask.c:1809-2102), including its PCM rounding/clip
(mad_scale, wmixTask.c:1837-1845).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from wmix_tpu_torch.codecs import _mp3_tables as T

np.seterr(over="ignore")

I32 = np.int32
I64 = np.int64

# ISO/IEC 11172-3 Table headers (frame.c:40-52)
BITRATE_TABLE = [
    # MPEG-1 layer I, II, III (kbps)
    [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448],
    [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384],
    [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320],
    # MPEG-2 LSF layer I, II/III
    [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256],
    [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
]
SAMPLERATE_TABLE = [44100, 48000, 32000]

BUFFER_GUARD = 8
BUFFER_MDLEN = 511 + 2048 + BUFFER_GUARD

# header flags (mad.h)
F_LSF_EXT = 0x1000
F_MPEG_2_5_EXT = 0x2000
F_PROTECTION = 0x0010
F_PADDING = 0x0080
F_I_STEREO = 0x0100
F_MS_STEREO = 0x0200

MODE_SINGLE = 0
MODE_DUAL = 1
MODE_JOINT = 2
MODE_STEREO = 3

I_STEREO = 0x1
MS_STEREO = 0x2

# channel flags (layer3.c:72-79)
COUNT1TABLE_SELECT = 0x01
SCALEFAC_SCALE = 0x02
PREFLAG = 0x04
MIXED_BLOCK_FLAG = 0x08


def f_mul(x, y):
    """mad_f_mul, FPM_DEFAULT + OPT_SPEED: (x>>12)*(y>>16) in int32."""
    return I32(I32(I32(x) >> 12) * I32(I32(y) >> 16))


def f_mul_arr(x, y):
    x = np.asarray(x, I32)
    y = np.asarray(y, I32)
    return ((x >> 12) * (y >> 16)).astype(I32)


# ---------------------------------------------------------------------
# bit reader (bit.c: MSB-first)
# ---------------------------------------------------------------------

class Bits:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.pos = bitpos          # absolute bit position

    def copy(self) -> "Bits":
        return Bits(self.data, self.pos)

    def read(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            byte = data[pos >> 3] if (pos >> 3) < len(data) else 0
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def skip(self, n: int):
        self.pos += n

    def nextbyte(self) -> int:
        return (self.pos + 7) >> 3


# ---------------------------------------------------------------------
# header (frame.c decode_header:120-236)
# ---------------------------------------------------------------------

@dataclass
class Header:
    layer: int = 3
    mode: int = 0
    mode_extension: int = 0
    bitrate: int = 0
    samplerate: int = 0
    flags: int = 0
    crc_target: int = 0
    crc_target_init: int = 0   # crc_check seed (frame.c:155)

    @property
    def nchannels(self) -> int:
        return 1 if self.mode == MODE_SINGLE else 2

    @property
    def nbsamples(self) -> int:
        """MAD_NSBSAMPLES: 12 for Layer I, else 36 (18 for LSF III)."""
        if self.layer == 1:
            return 12
        if self.layer == 3 and (self.flags & F_LSF_EXT):
            return 18
        return 36


class MadError(Exception):
    def __init__(self, code, recoverable=True):
        super().__init__(code)
        self.code = code
        self.recoverable = recoverable


def decode_header(b: Bits) -> Header:
    h = Header()
    b.skip(11)
    if b.read(1) == 0:
        h.flags |= F_MPEG_2_5_EXT
    if b.read(1) == 0:
        h.flags |= F_LSF_EXT
    elif h.flags & F_MPEG_2_5_EXT:
        raise MadError("LOSTSYNC")
    h.layer = 4 - b.read(2)
    if h.layer == 4:
        raise MadError("BADLAYER")
    if b.read(1) == 0:
        h.flags |= F_PROTECTION
    index = b.read(4)
    if index == 15:
        raise MadError("BADBITRATE")
    if h.flags & F_LSF_EXT:
        h.bitrate = BITRATE_TABLE[3 + (h.layer >> 1)][index] * 1000
    else:
        h.bitrate = BITRATE_TABLE[h.layer - 1][index] * 1000
    index = b.read(2)
    if index == 3:
        raise MadError("BADSAMPLERATE")
    h.samplerate = SAMPLERATE_TABLE[index]
    if h.flags & F_LSF_EXT:
        h.samplerate //= 2
        if h.flags & F_MPEG_2_5_EXT:
            h.samplerate //= 2
    if b.read(1):
        h.flags |= F_PADDING
    b.read(1)                       # private
    h.mode = 3 - b.read(2)
    h.mode_extension = b.read(2)
    b.read(1)                       # copyright
    b.read(1)                       # original
    b.read(2)                       # emphasis
    if h.flags & F_PROTECTION:
        h.crc_target = b.read(16)
    return h


# ---------------------------------------------------------------------
# side info / scalefactors (layer3.c:505-780)
# ---------------------------------------------------------------------

@dataclass
class Channel:
    part2_3_length: int = 0
    big_values: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    flags: int = 0
    block_type: int = 0
    table_select: list = field(default_factory=lambda: [0, 0, 0])
    subblock_gain: list = field(default_factory=lambda: [0, 0, 0])
    region0_count: int = 0
    region1_count: int = 0
    scalefac: list = field(default_factory=lambda: [0] * 39)


@dataclass
class SideInfo:
    main_data_begin: int = 0
    private_bits: int = 0
    scfsi: list = field(default_factory=lambda: [0, 0])
    gr: list = field(default_factory=lambda: [
        [Channel(), Channel()], [Channel(), Channel()]])


def read_sideinfo(b: Bits, nch: int, lsf: bool):
    si = SideInfo()
    data_bitlen = 0
    priv_bitlen = (1 if nch == 1 else 2) if lsf else (5 if nch == 1 else 3)
    si.main_data_begin = b.read(8 if lsf else 9)
    si.private_bits = b.read(priv_bitlen)
    ngr = 1
    if not lsf:
        ngr = 2
        for ch in range(nch):
            si.scfsi[ch] = b.read(4)
    for gr in range(ngr):
        for ch in range(nch):
            c = si.gr[gr][ch]
            c.part2_3_length = b.read(12)
            c.big_values = b.read(9)
            c.global_gain = b.read(8)
            c.scalefac_compress = b.read(9 if lsf else 4)
            data_bitlen += c.part2_3_length
            if c.big_values > 288:
                raise MadError("BADBIGVALUES")
            c.flags = 0
            if b.read(1):               # window_switching_flag
                c.block_type = b.read(2)
                if c.block_type == 0:
                    raise MadError("BADBLOCKTYPE")
                if not lsf and c.block_type == 2 and si.scfsi[ch]:
                    raise MadError("BADSCFSI")
                c.region0_count = 7
                c.region1_count = 36
                if b.read(1):
                    c.flags |= MIXED_BLOCK_FLAG
                elif c.block_type == 2:
                    c.region0_count = 8
                for i in range(2):
                    c.table_select[i] = b.read(5)
                for i in range(3):
                    c.subblock_gain[i] = b.read(3)
            else:
                c.block_type = 0
                for i in range(3):
                    c.table_select[i] = b.read(5)
                c.region0_count = b.read(4)
                c.region1_count = b.read(3)
            c.flags |= b.read(2 if lsf else 3)
    return si, data_bitlen


def read_scalefactors(b: Bits, ch: Channel, gr0ch: Optional[Channel],
                      scfsi: int) -> int:
    """III_scalefactors (layer3.c:713-780)."""
    start = b.pos
    slen1 = int(T.SFLEN1[ch.scalefac_compress])
    slen2 = int(T.SFLEN2[ch.scalefac_compress])
    if ch.block_type == 2:
        sfbi = 0
        nsfb = 8 + 3 * 3 if (ch.flags & MIXED_BLOCK_FLAG) else 6 * 3
        for _ in range(nsfb):
            ch.scalefac[sfbi] = b.read(slen1)
            sfbi += 1
        for _ in range(6 * 3):
            ch.scalefac[sfbi] = b.read(slen2)
            sfbi += 1
        for _ in range(3):
            ch.scalefac[sfbi] = 0
            sfbi += 1
    else:
        for lo, hi, slen, bit in ((0, 6, slen1, 0x8), (6, 11, slen1, 0x4),
                                  (11, 16, slen2, 0x2), (16, 21, slen2,
                                                         0x1)):
            if scfsi & bit:
                for i in range(lo, hi):
                    ch.scalefac[i] = gr0ch.scalefac[i]
            else:
                for i in range(lo, hi):
                    ch.scalefac[i] = b.read(slen)
        ch.scalefac[21] = 0
    return b.pos - start


def read_scalefactors_lsf(b: Bits, ch: Channel, gr1ch: Optional[Channel],
                          mode_extension: int) -> int:
    """III_scalefactors_lsf (layer3.c:595-707)."""
    start = b.pos
    sfc = ch.scalefac_compress
    index = (2 if (ch.flags & MIXED_BLOCK_FLAG) else 1) \
        if ch.block_type == 2 else 0
    if not ((mode_extension & I_STEREO) and gr1ch is not None):
        if sfc < 400:
            slen = [(sfc >> 4) // 5, (sfc >> 4) % 5, (sfc % 16) >> 2,
                    sfc % 4]
            nsfb = T.NSFB[0][index]
        elif sfc < 500:
            sfc -= 400
            slen = [(sfc >> 2) // 5, (sfc >> 2) % 5, sfc % 4, 0]
            nsfb = T.NSFB[1][index]
        else:
            sfc -= 500
            slen = [sfc // 3, sfc % 3, 0, 0]
            nsfb = T.NSFB[2][index]
            ch.flags |= PREFLAG
        n = 0
        for part in range(4):
            for _ in range(nsfb[part]):
                ch.scalefac[n] = b.read(slen[part])
                n += 1
        while n < 39:
            ch.scalefac[n] = 0
            n += 1
    else:
        sfc >>= 1
        if sfc < 180:
            slen = [sfc // 36, (sfc % 36) // 6, (sfc % 36) % 6, 0]
            nsfb = T.NSFB[3][index]
        elif sfc < 244:
            sfc -= 180
            slen = [(sfc % 64) >> 4, (sfc % 16) >> 2, sfc % 4, 0]
            nsfb = T.NSFB[4][index]
        else:
            sfc -= 244
            slen = [sfc // 3, sfc % 3, 0, 0]
            nsfb = T.NSFB[5][index]
        n = 0
        for part in range(4):
            maxv = (1 << slen[part]) - 1
            for _ in range(nsfb[part]):
                is_pos = b.read(slen[part])
                ch.scalefac[n] = is_pos
                gr1ch.scalefac[n] = 1 if is_pos == maxv else 0
                n += 1
        while n < 39:
            ch.scalefac[n] = 0
            gr1ch.scalefac[n] = 0
            n += 1
    return b.pos - start


# ---------------------------------------------------------------------
# requantization (layer3.c:826-920)
# ---------------------------------------------------------------------

def exponents(ch: Channel, sfbwidth) -> list:
    """III_exponents (layer3.c:829-887)."""
    gain = ch.global_gain - 210
    mult = 2 if (ch.flags & SCALEFAC_SCALE) else 1
    exps = [0] * 39
    if ch.block_type == 2:
        sfbi = 0
        el = 0
        if ch.flags & MIXED_BLOCK_FLAG:
            pre = (ch.flags & PREFLAG) != 0
            while el < 36:
                exps[sfbi] = gain - (
                    (ch.scalefac[sfbi] +
                     (int(T.PRETAB[sfbi]) if pre else 0)) << mult)
                el += sfbwidth[sfbi]
                sfbi += 1
        g = [gain - 8 * ch.subblock_gain[w] for w in range(3)]
        while el < 576:
            for w in range(3):
                exps[sfbi + w] = g[w] - (ch.scalefac[sfbi + w] << mult)
            el += 3 * sfbwidth[sfbi]
            sfbi += 3
    else:
        pre = (ch.flags & PREFLAG) != 0
        for sfbi in range(22):
            p = int(T.PRETAB[sfbi]) if pre else 0
            exps[sfbi] = gain - ((ch.scalefac[sfbi] + p) << mult)
    return exps


def requantize(value: int, exp: int) -> int:
    """III_requantize (layer3.c:893-920), int32 result."""
    if exp < 0:
        frac = -((-exp) % 4)
        e = -((-exp) // 4)
    else:
        frac = exp % 4
        e = exp // 4
    requantized = int(T.RQ_MANT[value])
    e += int(T.RQ_EXP[value])
    if e < 0:
        if -e >= 32:
            requantized = 0
        else:
            requantized = (requantized + (1 << (-e - 1))) >> (-e)
    else:
        if e >= 5:
            requantized = 0x7FFFFFFF
        else:
            requantized = _w32(requantized << e)
    if frac:
        return int(f_mul(requantized, int(T.ROOT_TABLE[3 + frac])))
    return requantized


def _w32(v: int) -> int:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


# ---------------------------------------------------------------------
# Huffman decoding (layer3.c:929-1260)
# ---------------------------------------------------------------------

def huffdecode(b: Bits, ch: Channel, sfbwidth, part2_length: int
               ) -> np.ndarray:
    """III_huffdecode: returns xr[576] int32."""
    bits_left = ch.part2_3_length - part2_length
    if bits_left < 0:
        raise MadError("BADPART3LEN")
    exps = exponents(ch, sfbwidth)
    xr = np.zeros(576, I32)

    peek = b.copy()
    b.skip(bits_left)

    # cache alignment (layer3.c:955-960): mad_bit_bitsleft is the unread
    # bit count of the current byte — 8 when byte-aligned
    cachesz = 8 - (peek.pos & 7)
    cachesz += ((32 - 1 - 24) + (24 - cachesz)) & ~7
    bitcache = peek.read(cachesz)
    bits_left -= cachesz

    sfb_iter = iter(sfbwidth)
    sfbound = next(sfb_iter)
    exp = exps[0]
    exp_idx = 1

    xi = 0
    region = 0
    rcount = ch.region0_count + 1
    tab, linbits, startbits = T.HUFF_PAIR[ch.table_select[0]]
    if tab is None:
        raise MadError("BADHUFFTABLE")
    reqcache = [0] * 16
    reqhits = 0

    big_values = ch.big_values
    while big_values > 0 and cachesz + bits_left > 0:
        big_values -= 1
        if xi == sfbound:
            sfbound += next(sfb_iter)
            rcount -= 1
            if rcount == 0:
                if region == 0:
                    rcount = ch.region1_count + 1
                else:
                    rcount = 0
                region += 1
                tab, linbits, startbits = \
                    T.HUFF_PAIR[ch.table_select[region]]
                if tab is None:
                    raise MadError("BADHUFFTABLE")
            if exp != exps[exp_idx]:
                exp = exps[exp_idx]
                reqhits = 0
            exp_idx += 1

        if cachesz < 21:
            nbits = ((32 - 1 - 21) + (21 - cachesz)) & ~7
            bitcache = ((bitcache << nbits) | peek.read(nbits)) & \
                0xFFFFFFFFFFFFFFFF
            cachesz += nbits
            bits_left -= nbits

        clumpsz = startbits
        v = tab[(bitcache >> (cachesz - clumpsz)) & ((1 << clumpsz) - 1)]
        while not (v & 1):
            cachesz -= clumpsz
            clumpsz = (v >> 1) & 0x7
            offset = (v >> 4) & 0xFFF
            v = tab[offset +
                    ((bitcache >> (cachesz - clumpsz)) &
                     ((1 << clumpsz) - 1))]
        cachesz -= (v >> 1) & 0x7         # hlen

        if linbits:
            for slot, val in ((0, (v >> 4) & 0xF), (1, (v >> 8) & 0xF)):
                if val == 0:
                    xr[xi + slot] = 0
                    continue
                if val == 15:
                    if cachesz < linbits + 2 - slot:
                        bitcache = ((bitcache << 16) | peek.read(16)) & \
                            0xFFFFFFFFFFFFFFFF
                        cachesz += 16
                        bits_left -= 16
                    val += (bitcache >> (cachesz - linbits)) & \
                        ((1 << linbits) - 1)
                    cachesz -= linbits
                    req = requantize(val, exp)
                else:
                    if reqhits & (1 << val):
                        req = reqcache[val]
                    else:
                        reqhits |= 1 << val
                        req = reqcache[val] = requantize(val, exp)
                neg = bitcache & (1 << (cachesz - 1))
                cachesz -= 1
                xr[xi + slot] = _w32(-req) if neg else req
        else:
            for slot, val in ((0, (v >> 4) & 0xF), (1, (v >> 8) & 0xF)):
                if val == 0:
                    xr[xi + slot] = 0
                    continue
                if reqhits & (1 << val):
                    req = reqcache[val]
                else:
                    reqhits |= 1 << val
                    req = reqcache[val] = requantize(val, exp)
                neg = bitcache & (1 << (cachesz - 1))
                cachesz -= 1
                xr[xi + slot] = _w32(-req) if neg else req
        xi += 2

    if cachesz + bits_left < 0:
        raise MadError("BADHUFFDATA")

    # count1
    qtab = T.HUFF_QUAD[ch.flags & COUNT1TABLE_SELECT]
    req1 = requantize(1, exp)
    while cachesz + bits_left > 0 and xi <= 572:
        if cachesz < 10:
            bitcache = ((bitcache << 16) | peek.read(16)) & \
                0xFFFFFFFFFFFFFFFF
            cachesz += 16
            bits_left -= 16
        v = qtab[(bitcache >> (cachesz - 4)) & 0xF]
        if not (v & 1):
            cachesz -= 4
            bits = (v >> 1) & 0x7
            offset = (v >> 4) & 0xFFF
            v = qtab[offset + ((bitcache >> (cachesz - bits)) &
                               ((1 << bits) - 1))]
        cachesz -= (v >> 1) & 0x7

        if xi == sfbound:
            sfbound += next(sfb_iter)
            if exp != exps[exp_idx]:
                exp = exps[exp_idx]
                req1 = requantize(1, exp)
            exp_idx += 1
        for bit in (4, 5):              # v, w
            if (v >> bit) & 1:
                neg = bitcache & (1 << (cachesz - 1))
                cachesz -= 1
                xr[xi] = _w32(-req1) if neg else req1
            else:
                xr[xi] = 0
            xi += 1
        if xi == sfbound:
            sfbound += next(sfb_iter)
            if exp != exps[exp_idx]:
                exp = exps[exp_idx]
                req1 = requantize(1, exp)
            exp_idx += 1
        for bit in (6, 7):              # x, y
            if (v >> bit) & 1:
                neg = bitcache & (1 << (cachesz - 1))
                cachesz -= 1
                xr[xi] = _w32(-req1) if neg else req1
            else:
                xr[xi] = 0
            xi += 1

    if cachesz + bits_left < 0:
        xi -= 4
        if xi < 0:
            xi = 0

    xr[xi:] = 0
    return xr


# ---------------------------------------------------------------------
# joint stereo (layer3.c:1323-1530)
# ---------------------------------------------------------------------

def stereo(xr0: np.ndarray, xr1: np.ndarray, granule, header: Header,
           sfbwidth, gr1ch1: Optional[Channel]):
    """III_stereo; mutates xr0/xr1."""
    ch0, ch1 = granule
    if ch0.block_type != ch1.block_type or \
            (ch0.flags & MIXED_BLOCK_FLAG) != (ch1.flags &
                                               MIXED_BLOCK_FLAG):
        raise MadError("BADSTEREO")
    modes = [header.mode_extension] * 39

    if header.mode_extension & I_STEREO:
        right_ch = ch1
        header.flags |= F_I_STEREO
        if right_ch.block_type == 2:
            lower = start = maxv = 0
            bound = [0, 0, 0]
            sfbi = el = 0
            ri = 0
            if right_ch.flags & MIXED_BLOCK_FLAG:
                while el < 36:
                    n = sfbwidth[sfbi]
                    sfbi += 1
                    if np.any(xr1[ri:ri + n]):
                        lower = sfbi
                    ri += n
                    el += n
                start = sfbi
            w = 0
            while el < 576:
                n = sfbwidth[sfbi]
                sfbi += 1
                if np.any(xr1[ri:ri + n]):
                    maxv = bound[w] = sfbi
                ri += n
                el += n
                w = (w + 1) % 3
            if maxv:
                lower = start
            for i in range(lower):
                modes[i] = header.mode_extension & ~I_STEREO
            w = 0
            for i in range(start, maxv):
                if i < bound[w]:
                    modes[i] = header.mode_extension & ~I_STEREO
                w = (w + 1) % 3
        else:
            bnd = 0
            sfbi = el = ri = 0
            while el < 576:
                n = sfbwidth[sfbi]
                sfbi += 1
                if np.any(xr1[ri:ri + n]):
                    bnd = sfbi
                ri += n
                el += n
            for i in range(bnd):
                modes[i] = header.mode_extension & ~I_STEREO

        if header.flags & F_LSF_EXT:
            illegal_pos = gr1ch1.scalefac
            lsf_scale = T.IS_LSF_TABLE[
                (right_ch.scalefac_compress & 0x1) * 15:
                (right_ch.scalefac_compress & 0x1) * 15 + 15]
            el = 0
            for sfbi in range(39):
                if el >= 576:
                    break
                n = sfbwidth[sfbi]
                if not (modes[sfbi] & I_STEREO):
                    el += n
                    continue
                if illegal_pos[sfbi]:
                    modes[sfbi] &= ~I_STEREO
                    el += n
                    continue
                is_pos = right_ch.scalefac[sfbi]
                sl = slice(el, el + n)
                left = xr0[sl].copy()
                if is_pos == 0:
                    xr1[sl] = left
                else:
                    opp = f_mul_arr(left,
                                    int(lsf_scale[(is_pos - 1) // 2]))
                    if is_pos & 1:
                        xr0[sl] = opp
                        xr1[sl] = left
                    else:
                        xr1[sl] = opp
                el += n
        else:
            el = 0
            for sfbi in range(39):
                if el >= 576:
                    break
                n = sfbwidth[sfbi]
                if not (modes[sfbi] & I_STEREO):
                    el += n
                    continue
                is_pos = right_ch.scalefac[sfbi]
                if is_pos >= 7:
                    modes[sfbi] &= ~I_STEREO
                    el += n
                    continue
                sl = slice(el, el + n)
                left = xr0[sl].copy()
                xr0[sl] = f_mul_arr(left, int(T.IS_TABLE[is_pos]))
                xr1[sl] = f_mul_arr(left, int(T.IS_TABLE[6 - is_pos]))
                el += n

    if header.mode_extension & MS_STEREO:
        header.flags |= F_MS_STEREO
        invsqrt2 = int(T.ROOT_TABLE[3 - 2])
        el = 0
        for sfbi in range(39):
            if el >= 576:
                break
            n = sfbwidth[sfbi]
            if modes[sfbi] != MS_STEREO:
                el += n
                continue
            sl = slice(el, el + n)
            m = xr0[sl].copy()
            s = xr1[sl].copy()
            xr0[sl] = f_mul_arr(m + s, invsqrt2)
            xr1[sl] = f_mul_arr(m - s, invsqrt2)
            el += n


def reorder(xr: np.ndarray, ch: Channel, sfbwidth):
    """III_reorder (layer3.c:1265-1321); mutates xr."""
    tmp = np.zeros((32, 3, 6), I32)
    sb = 0
    si = 0
    if ch.flags & MIXED_BLOCK_FLAG:
        sb = 2
        el = 0
        while el < 36:
            el += sfbwidth[si]
            si += 1
    sbw = [sb, sb, sb]
    sw = [0, 0, 0]
    f = sfbwidth[si]
    si += 1
    w = 0
    for el in range(18 * sb, 576):
        if f == 0:
            f = sfbwidth[si] - 1
            si += 1
            w = (w + 1) % 3
        else:
            f -= 1
        tmp[sbw[w], w, sw[w]] = xr[el]
        sw[w] += 1
        if sw[w] == 6:
            sw[w] = 0
            sbw[w] += 1
    xr[18 * sb:] = tmp.reshape(-1)[18 * sb:576]


def aliasreduce(xr: np.ndarray, lines: int):
    """III_aliasreduce (layer3.c:1538-1563); int32 MACs."""
    cs = T.CS
    ca = T.CA
    for x0 in range(18, lines, 18):
        a = xr[x0 - 1 - np.arange(8)]
        bq = xr[x0 + np.arange(8)]
        lo = (a >> 12) * (cs[:8] >> 16) + \
            ((-bq) >> 12) * (ca[:8] >> 16)
        xr[x0 - 1 - np.arange(8)] = lo
        lo2 = (bq >> 12) * (cs[:8] >> 16) + (a >> 12) * (ca[:8] >> 16)
        xr[x0 + np.arange(8)] = lo2


# ---------------------------------------------------------------------
# IMDCT (layer3.c:1589-1763): Lee fast DCT-IV path, int32
# ---------------------------------------------------------------------

def _fastsdct(x: np.ndarray) -> np.ndarray:
    """fastsdct (layer3.c:1595-1656): 9-point SDCT, output in the even
    slots of an 18-vector."""
    c = T.FASTSDCT_C
    a0 = x[3] + x[5]
    a1 = x[3] - x[5]
    a2 = x[6] + x[2]
    a3 = x[6] - x[2]
    a4 = x[1] + x[7]
    a5 = x[1] - x[7]
    a6 = x[8] + x[0]
    a7 = x[8] - x[0]
    a8 = a0 + a2
    a9 = a0 - a2
    a10 = a0 - a6
    a11 = a2 - a6
    a12 = a8 + a6
    a13 = a1 - a3
    a14 = a13 + a7
    a15 = a3 + a7
    a16 = a1 - a7
    a17 = a1 + a3
    m0 = f_mul(a17, -int(c[3]))
    m1 = f_mul(a16, -int(c[0]))
    m2 = f_mul(a15, -int(c[4]))
    m3 = f_mul(a14, -int(c[1]))
    m4 = f_mul(a5, -int(c[1]))
    m5 = f_mul(a11, -int(c[6]))
    m6 = f_mul(a10, -int(c[5]))
    m7 = f_mul(a9, -int(c[2]))
    a18 = x[4] + a4
    a19 = I32(2) * x[4] - a4
    a20 = a19 + m5
    a21 = a19 - m5
    a22 = a19 + m6
    a23 = m4 + m2
    a24 = m4 - m2
    a25 = m4 + m1
    y = np.zeros(18, I32)
    y[0] = a18 + a12
    y[2] = m0 - a25
    y[4] = m7 - a20
    y[6] = m3
    y[8] = a21 - m6
    y[10] = a24 - m1
    y[12] = a12 - I32(2) * a18
    y[14] = a23 + m0
    y[16] = a22 + m7
    return y


def _sdct2(x: np.ndarray) -> np.ndarray:
    """sdctII (layer3.c:1658-1700)."""
    even = (x[:9] + x[17:8:-1]).astype(I32)
    X = _fastsdct(even)
    odd = f_mul_arr(x[:9] - x[17:8:-1], T.SDCT_SCALE)
    Xo = _fastsdct(odd)
    X = X + np.roll(Xo, 1)          # Xo lands in odd slots (offset 1)
    X[1::2] = Xo[0::2]
    for i in range(3, 18, 2):
        X[i] = I32(X[i] - X[i - 2])
    return X


def _dct4(y: np.ndarray) -> np.ndarray:
    """dctIV (layer3.c:1702-1734)."""
    tmp = f_mul_arr(y, T.DCTIV_SCALE)
    X = _sdct2(tmp)
    X = X.copy()
    X[0] = _c_div2(X[0])
    for i in range(1, 18):
        X[i] = I32(_c_div2(X[i]) - X[i - 1])
    return X


def _c_div2(v):
    """C `x / 2` on int32: truncates toward zero."""
    v = int(v)
    return I32(-((-v) // 2) if v < 0 else v // 2)


def imdct36(x: np.ndarray) -> np.ndarray:
    """imdct36 fast path (layer3.c:1736-1763)."""
    tmp = _dct4(x)
    y = np.zeros(36, I32)
    y[0:9] = tmp[9:18]
    y[9:27] = -tmp[26 - np.arange(9, 27)]
    y[27:36] = -tmp[0:9]
    return y


def imdct_l(X: np.ndarray, block_type: int) -> np.ndarray:
    """III_imdct_l (layer3.c:1909-2010): IMDCT + windowing."""
    z = imdct36(X)
    wl = T.WINDOW_L
    ws = T.WINDOW_S
    if block_type == 0:
        z = f_mul_arr(z, wl)
    elif block_type == 1:
        z = z.copy()
        z[:18] = f_mul_arr(z[:18], wl[:18])
        z[24:30] = f_mul_arr(z[24:30], ws[6:12])
        z[30:] = 0
    elif block_type == 3:
        z = z.copy()
        z[:6] = 0
        z[6:12] = f_mul_arr(z[6:12], ws[0:6])
        z[18:] = f_mul_arr(z[18:], wl[18:])
    return z


def imdct_s(X: np.ndarray) -> np.ndarray:
    """III_imdct_s (layer3.c:2144-2222)."""
    imd = T.IMDCT_S.reshape(6, 6)
    y = np.zeros(36, I32)
    for w in range(3):
        Xw = X[6 * w:6 * w + 6]
        prod = ((imd >> 12) * ((Xw >> 16)[None, :])).sum(axis=1)
        # NB operand order: C does MLA(hi,lo, X[k], (*s)[k]) = X>>12 * s>>16
        prod = (((Xw >> 12)[None, :] * (imd >> 16)).sum(axis=1)) \
            .astype(I32)
        base = 12 * w
        for i in range(3):
            v = I32(((Xw >> 12) * (imd[2 * i] >> 16)).sum())
            y[base + i] = v
            y[base + 5 - i] = -v
            v2 = I32(((Xw >> 12) * (imd[2 * i + 1] >> 16)).sum())
            y[base + i + 6] = v2
            y[base + 11 - i] = v2
    z = np.zeros(36, I32)
    ws = T.WINDOW_S
    for i in range(6):
        z[i + 6] = f_mul(y[i], int(ws[i]))
        z[i + 12] = I32(f_mul(y[i + 6], int(ws[i + 6])) +
                        f_mul(y[12 + i], int(ws[i])))
        z[i + 18] = I32(f_mul(y[12 + i + 6], int(ws[i + 6])) +
                        f_mul(y[24 + i], int(ws[i])))
        z[i + 24] = f_mul(y[24 + i + 6], int(ws[i + 6]))
    return z


# ---------------------------------------------------------------------
# polyphase synthesis (synth.c:547-660, OPT_SSO)
# ---------------------------------------------------------------------

_KOFFS = np.array([0, 14, 12, 10, 8, 6, 4, 2])
_ROWS = np.arange(1, 16)[:, None] * 32       # [15,1]


@lru_cache(maxsize=None)
def _d_mats(phase: int):
    """Per-phase D-window gather matrices (int32) for the synth MACs."""
    D = T.D_TABLE
    pe = phase & ~1
    po = ((phase - 1) & 0xF) | 1
    return (D[0 * 32 + po + _KOFFS].astype(I32),        # row0 odd-x
            D[0 * 32 + pe + _KOFFS].astype(I32),        # row0 even
            D[_ROWS + po + _KOFFS].astype(I32),         # [15,8] fo side
            D[_ROWS + pe + _KOFFS].astype(I32),         # [15,8] fe side
            D[_ROWS - pe + 31 - _KOFFS].astype(I32),    # [15,8] mirrored fe
            D[_ROWS - po + 31 - _KOFFS].astype(I32),    # [15,8] mirrored fo
            D[16 * 32 + po + _KOFFS].astype(I32))       # last row


class Synth:
    """mad_synth: filter FIFO [2][2][2][16][8] + phase."""

    def __init__(self):
        self.filter = np.zeros((2, 2, 2, 16, 8), I32)
        self.phase = 0

    def frame(self, sbsample: np.ndarray, nch: int, ns: int) -> np.ndarray:
        """synth_full: sbsample [2][36][32] int32 -> pcm [nch, 32*ns].

        dct32 is batched over all ns slots; the windowing MACs run as
        [15,8] row-dots per slot (bit-identical int32 arithmetic — sums
        of int32 products wrap the same in any association since
        wraparound addition is associative)."""
        from wmix_tpu_torch.codecs._mp3_dct32 import dct32
        pcm = np.zeros((nch, 32 * ns), I32)
        for ch in range(nch):
            HI, LO = dct32(sbsample[ch].T)   # [16, ns] each
            filt = self.filter[ch]
            phase = self.phase
            out_i = 0
            for s in range(ns):
                filt[0, phase & 1, :, phase >> 1] = LO[:, s]
                filt[1, phase & 1, :, phase >> 1] = HI[:, s]

                d0o, d0e, dfo, dfe, dme, dmo, dlast = _d_mats(phase)
                fe = filt[0, phase & 1]        # [16][8]
                fx = filt[0, (~phase) & 1]
                fo = filt[1, (~phase) & 1]

                d0 = (int(I32((fe[0] * d0e).sum())) -
                      int(I32((fx[0] * d0o).sum())))  # int32 wrap:
                d0 = ((d0 + 0x80000000) & 0xFFFFFFFF) - 0x80000000
                pcm[ch, out_i] = I32(d0) >> 2
                fwd = ((fe[1:] * dfe).sum(axis=1) -
                       (fo[:15] * dfo).sum(axis=1)).astype(I32)
                pcm[ch, out_i + 1:out_i + 16] = fwd >> 2
                rev = ((fe[1:] * dme).sum(axis=1) +
                       (fo[:15] * dmo).sum(axis=1)).astype(I32)
                pcm[ch, out_i + 31:out_i + 16:-1] = rev >> 2
                pcm[ch, out_i + 16] =                     I32(-I32((fo[15] * dlast).sum())) >> 2

                out_i += 32
                phase = (phase + 1) % 16
        self.phase = (self.phase + ns) % 16
        return pcm


# ---------------------------------------------------------------------
# frame decode (III_decode, layer3.c:2348-2510)
# ---------------------------------------------------------------------

# ---------------------------------------------------------------------
# Layer I / Layer II (layer12.c), same Q28 fixed-point pipeline feeding
# the shared polyphase synthesis
# ---------------------------------------------------------------------

from wmix_tpu_torch.codecs._mp3_l12_tables import (BITALLOC_TABLE, LINEAR_TABLE,
                                             OFFSET_TABLE, QC_TABLE,
                                             SBQUANT_TABLE, SF_TABLE)


def _bit_crc(data: bytes, bitpos: int, length: int, init: int) -> int:
    """mad_bit_crc: CRC-16 poly 0x8005, MSB-first, over `length` bits."""
    crc = init & 0xFFFF
    for k in range(length):
        p = bitpos + k
        bit = (data[p >> 3] >> (7 - (p & 7))) & 1
        fb = ((crc >> 15) & 1) ^ bit
        crc = (crc << 1) & 0xFFFF
        if fb:
            crc ^= 0x8005
    return crc


def _i_sample(b: Bits, nb: int) -> int:
    """I_sample (layer12.c:74-100): invert MSB, sign-extend, requantize
    s'' = (2^nb / (2^nb - 1)) * (s''' + 2^(-nb+1))."""
    sample = b.read(nb)
    sample ^= 1 << (nb - 1)
    sample |= -(sample & (1 << (nb - 1)))
    sample <<= 28 - (nb - 1)           # MAD_F_FRACBITS
    sample += 1 << (28 - (nb - 1))     # MAD_F_ONE >> (nb - 1)
    return f_mul(sample, LINEAR_TABLE[nb - 2])


def _layer_I(b: Bits, h: Header, sbsample: np.ndarray, data: bytes,
             start_bitpos: int):
    """mad_layer_I (layer12.c:106-213) -> fills sbsample[ch][0:12][sb]."""
    nch = h.nchannels
    bound = 32
    if h.mode == MODE_JOINT:
        bound = 4 + h.mode_extension * 4

    if h.flags & F_PROTECTION:
        crc = _bit_crc(data, start_bitpos,
                       4 * (bound * nch + (32 - bound)), h.crc_target_init)
        if crc != h.crc_target:
            raise MadError("BADCRC")

    allocation = np.zeros((2, 32), np.int64)
    scalefactor = np.zeros((2, 32), np.int64)
    for sb in range(bound):
        for ch in range(nch):
            nb = b.read(4)
            if nb == 15:
                raise MadError("BADBITALLOC")
            allocation[ch][sb] = nb + 1 if nb else 0
    for sb in range(bound, 32):
        nb = b.read(4)
        if nb == 15:
            raise MadError("BADBITALLOC")
        allocation[0][sb] = allocation[1][sb] = nb + 1 if nb else 0

    for sb in range(32):
        for ch in range(nch):
            if allocation[ch][sb]:
                scalefactor[ch][sb] = b.read(6)

    for s in range(12):
        for sb in range(bound):
            for ch in range(nch):
                nb = int(allocation[ch][sb])
                sbsample[ch][s][sb] = f_mul(
                    _i_sample(b, nb),
                    SF_TABLE[scalefactor[ch][sb]]) if nb else 0
        for sb in range(bound, 32):
            nb = int(allocation[0][sb])
            if nb:
                sample = _i_sample(b, nb)
                for ch in range(nch):
                    sbsample[ch][s][sb] = f_mul(
                        sample, SF_TABLE[scalefactor[ch][sb]])
            else:
                for ch in range(nch):
                    sbsample[ch][s][sb] = 0


def _ii_samples(b: Bits, qc, out):
    """II_samples (layer12.c:291-325): s'' = C * (s''' + D)."""
    nlevels, group, bits, c_q28, d_q28 = qc
    sample = [0, 0, 0]
    if group:
        nb = group
        c = b.read(bits)
        for s in range(3):
            sample[s] = c % nlevels
            c //= nlevels
    else:
        nb = bits
        for s in range(3):
            sample[s] = b.read(nb)
    for s in range(3):
        requantized = sample[s] ^ (1 << (nb - 1))
        requantized |= -(requantized & (1 << (nb - 1)))
        requantized <<= 28 - (nb - 1)
        out[s] = f_mul(requantized + d_q28, c_q28)


def _layer_II(b: Bits, h: Header, sbsample: np.ndarray, data: bytes,
              start_bitpos: int):
    """mad_layer_II (layer12.c:331-534)."""
    nch = h.nchannels
    if h.flags & F_LSF_EXT:
        index = 4
    else:
        bitrate_per_channel = h.bitrate
        if nch == 2:
            bitrate_per_channel //= 2
        else:
            if bitrate_per_channel > 192000:
                raise MadError("BADMODE")
        if bitrate_per_channel <= 48000:
            index = 3 if h.samplerate == 32000 else 2
        elif bitrate_per_channel <= 80000:
            index = 0
        else:
            index = 0 if h.samplerate == 48000 else 1

    sblimit, offsets = SBQUANT_TABLE[index]
    bound = 32
    if h.mode == MODE_JOINT:
        bound = 4 + h.mode_extension * 4
    if bound > sblimit:
        bound = sblimit

    crc_start = b.pos

    allocation = np.zeros((2, 32), np.int64)
    scfsi = np.zeros((2, 32), np.int64)
    scalefactor = np.zeros((2, 32, 3), np.int64)
    for sb in range(bound):
        nbal = BITALLOC_TABLE[offsets[sb]][0]
        for ch in range(nch):
            allocation[ch][sb] = b.read(nbal)
    for sb in range(bound, sblimit):
        nbal = BITALLOC_TABLE[offsets[sb]][0]
        allocation[0][sb] = allocation[1][sb] = b.read(nbal)

    for sb in range(sblimit):
        for ch in range(nch):
            if allocation[ch][sb]:
                scfsi[ch][sb] = b.read(2)

    if h.flags & F_PROTECTION:
        crc = _bit_crc(data, crc_start, b.pos - crc_start,
                       h.crc_target_init)
        if crc != h.crc_target:
            raise MadError("BADCRC")

    for sb in range(sblimit):
        for ch in range(nch):
            if allocation[ch][sb]:
                scalefactor[ch][sb][0] = b.read(6)
                si = int(scfsi[ch][sb])
                if si == 2:
                    scalefactor[ch][sb][2] = scalefactor[ch][sb][1] = \
                        scalefactor[ch][sb][0]
                else:
                    if si == 0:
                        scalefactor[ch][sb][1] = b.read(6)
                    scalefactor[ch][sb][2] = b.read(6)
                if si & 1:
                    scalefactor[ch][sb][1] = scalefactor[ch][sb][si - 1]

    samples = [0, 0, 0]
    for gr in range(12):
        for sb in range(bound):
            for ch in range(nch):
                idx = int(allocation[ch][sb])
                if idx:
                    qi = OFFSET_TABLE[
                        BITALLOC_TABLE[offsets[sb]][1]][idx - 1]
                    _ii_samples(b, QC_TABLE[qi], samples)
                    sf = SF_TABLE[scalefactor[ch][sb][gr // 4]]
                    for s in range(3):
                        sbsample[ch][3 * gr + s][sb] = f_mul(samples[s],
                                                             sf)
                else:
                    for s in range(3):
                        sbsample[ch][3 * gr + s][sb] = 0
        for sb in range(bound, sblimit):
            idx = int(allocation[0][sb])
            if idx:
                qi = OFFSET_TABLE[BITALLOC_TABLE[offsets[sb]][1]][idx - 1]
                _ii_samples(b, QC_TABLE[qi], samples)
                for ch in range(nch):
                    sf = SF_TABLE[scalefactor[ch][sb][gr // 4]]
                    for s in range(3):
                        sbsample[ch][3 * gr + s][sb] = f_mul(samples[s],
                                                             sf)
            else:
                for ch in range(nch):
                    for s in range(3):
                        sbsample[ch][3 * gr + s][sb] = 0
        for ch in range(nch):
            for s in range(3):
                sbsample[ch][3 * gr + s][sblimit:32] = 0


class FrameState:
    """Persistent mad_frame state: the 576-sample block overlap."""

    def __init__(self):
        self.overlap = np.zeros((2, 32, 18), I32)
        self.sbsample = np.zeros((2, 36, 32), I32)


def decode_granules(b: Bits, header: Header, si: SideInfo, nch: int,
                    fs: FrameState):
    """III_decode: main_data -> sbsample."""
    sfreq = header.samplerate
    if header.flags & F_MPEG_2_5_EXT:
        sfreq *= 2
    sfreqi = ((sfreq >> 7) & 0xF) + ((sfreq >> 15) & 0x1) - 8
    if header.flags & F_MPEG_2_5_EXT:
        sfreqi += 3

    ngr = 1 if (header.flags & F_LSF_EXT) else 2
    for gr in range(ngr):
        granule = si.gr[gr]
        xr = [None, None]
        sfbw = [None, None]
        for ch in range(nch):
            c = granule[ch]
            sfbwidth = T.SFBWIDTH[sfreqi][0]
            if c.block_type == 2:
                sfbwidth = T.SFBWIDTH[sfreqi][
                    2 if (c.flags & MIXED_BLOCK_FLAG) else 1]
            sfbw[ch] = sfbwidth
            if header.flags & F_LSF_EXT:
                part2 = read_scalefactors_lsf(
                    b, c, si.gr[1][1] if ch == 1 else None,
                    header.mode_extension)
            else:
                part2 = read_scalefactors(
                    b, c, si.gr[0][ch], 0 if gr == 0 else si.scfsi[ch])
            xr[ch] = huffdecode(b, c, sfbwidth, part2)

        if header.mode == MODE_JOINT and header.mode_extension:
            stereo(xr[0], xr[1], granule, header, sfbw[0],
                   si.gr[1][1] if (header.flags & F_LSF_EXT) else None)

        for ch in range(nch):
            c = granule[ch]
            sample = fs.sbsample[ch, 18 * gr:18 * gr + 18]   # [18][32]
            if c.block_type == 2:
                reorder(xr[ch], c, sfbw[ch])
                if c.flags & MIXED_BLOCK_FLAG:
                    aliasreduce(xr[ch], 36)
            else:
                aliasreduce(xr[ch], 576)

            el = 0
            if c.block_type != 2 or (c.flags & MIXED_BLOCK_FLAG):
                bt = 0 if (c.flags & MIXED_BLOCK_FLAG) else c.block_type
                for sb in range(2):
                    out = imdct_l(xr[ch][el:el + 18], bt)
                    sample[:, sb] = out[:18] + fs.overlap[ch, sb]
                    fs.overlap[ch, sb] = out[18:]
                    el += 18
            else:
                for sb in range(2):
                    out = imdct_s(xr[ch][el:el + 18])
                    sample[:, sb] = out[:18] + fs.overlap[ch, sb]
                    fs.overlap[ch, sb] = out[18:]
                    el += 18
            sample[1::2, 1] = -sample[1::2, 1]      # freqinver(sample, 1)

            i = 576
            while i > 36 and xr[ch][i - 1] == 0:
                i -= 1
            sblimit = 32 - (576 - i) // 18

            for sb in range(2, sblimit):
                if c.block_type != 2:
                    out = imdct_l(xr[ch][el:el + 18], c.block_type)
                else:
                    out = imdct_s(xr[ch][el:el + 18])
                sample[:, sb] = out[:18] + fs.overlap[ch, sb]
                fs.overlap[ch, sb] = out[18:]
                el += 18
                if sb & 1:
                    sample[1::2, sb] = -sample[1::2, sb]

            for sb in range(sblimit, 32):
                sample[:, sb] = fs.overlap[ch, sb]
                fs.overlap[ch, sb] = 0
                if sb & 1:
                    sample[1::2, sb] = -sample[1::2, sb]


# ---------------------------------------------------------------------
# stream layer: sync + bit reservoir (mad_layer_III, layer3.c:2512-2698;
# mad_header_decode, frame.c:297-432)
# ---------------------------------------------------------------------

def mad_scale(sample: np.ndarray) -> np.ndarray:
    """The daemon's mad_scale (wmixTask.c:1837-1845): round to 16 bits,
    clip, shift."""
    s = sample.astype(np.int64) + (1 << (28 - 16))
    s = np.clip(s, -(1 << 28), (1 << 28) - 1)
    return (s >> (28 + 1 - 16)).astype(np.int16)


class Mp3Decoder:
    """Streaming decoder over a complete buffer (the daemon mmaps whole
    files, wmixTask.c:2022-2102)."""

    def __init__(self):
        self.fs = FrameState()
        self.synth = Synth()
        self.md = bytearray()        # main_data reservoir
        self.md_len = 0

    def decode(self, data: bytes, max_frames: Optional[int] = None):
        """Returns (pcm int16 interleaved, samplerate, channels)."""
        out = []
        samplerate = channels = 0
        for pcm, sr, ch in self.frames(data, max_frames):
            out.append(pcm)
            samplerate, channels = sr, ch
        if not out:
            return np.zeros(0, np.int16), samplerate, channels
        pcm = np.concatenate(out, axis=1)
        return pcm.T.reshape(-1).copy(), samplerate, channels

    def frames(self, data: bytes, max_frames: Optional[int] = None):
        """Incremental decode: yields (pcm [nch, n] int16, rate, nch)
        per frame — playback can start before the file finishes (the
        daemon's mad_output flow loads the ring per frame,
        wmixTask.c:1847-1950)."""
        pos = 0
        end = len(data)
        nframes = 0
        # mad_stream_buffer starts synced; only header-decode failures
        # clear it, and the next-header verification below only runs
        # while unsynced (frame.c:332-424)
        sync = True

        def _syncword(p):
            return (p + 1 < end and data[p] == 0xFF and
                    (data[p + 1] & 0xE0) == 0xE0)

        while True:
            if sync:
                if end - pos < BUFFER_GUARD:
                    break               # MAD_ERROR_BUFLEN
                if not _syncword(pos):
                    sync = False        # MAD_ERROR_LOSTSYNC
                    pos += 1
                    continue
            else:
                while pos + 1 < end and not _syncword(pos):
                    pos += 1
                if end - pos < BUFFER_GUARD:
                    break
            b = Bits(data, pos * 8)
            try:
                h = decode_header(b)
            except MadError:
                sync = False
                pos += 1
                continue
            if h.bitrate == 0:
                sync = False
                pos += 1                # free-format unsupported
                continue
            pad = 1 if (h.flags & F_PADDING) else 0
            if h.layer == 1:
                # Layer I slots are 4 bytes (frame.c:439-446)
                N = (12 * h.bitrate // h.samplerate + pad) * 4
            else:
                slots = 72 if (h.layer == 3 and
                               (h.flags & F_LSF_EXT)) else 144
                N = slots * h.bitrate // h.samplerate + pad
            if pos + N + BUFFER_GUARD > end:
                break                   # incomplete tail frame (BUFLEN)
            next_frame = pos + N
            if not sync:
                # verify a valid frame header follows (frame.c:412-421)
                if not _syncword(next_frame):
                    pos += 1
                    continue
                sync = True

            if h.layer == 3:
                ok = self._decode_frame(data, b, h, pos, next_frame)
            else:
                ok = self._decode_frame_l12(data, b, h, pos)
            if ok:
                nframes += 1
                if getattr(self, "emit_sbsample", False):
                    yield h, self.fs.sbsample.copy()
                else:
                    yield (self._pcm_frame(h), h.samplerate,
                           h.nchannels)
                if max_frames and nframes >= max_frames:
                    break
            pos = next_frame

    def _frames_sbsample(self, data: bytes, max_frames=None):
        """Like frames() but yields (header, sbsample copy) BEFORE the
        polyphase synthesis — the batched device synth consumes these
        (codecs/mp3_batch.py; SURVEY §7 step 5 host/device split)."""
        self.emit_sbsample = True
        try:
            yield from self.frames(data, max_frames)
        finally:
            self.emit_sbsample = False

    def _pcm_frame(self, h: Header) -> np.ndarray:
        nch = h.nchannels
        ns = h.nbsamples
        pcm = self.synth.frame(self.fs.sbsample, nch, ns)
        return mad_scale(pcm)

    def _decode_frame_l12(self, data, b: Bits, h: Header,
                          this_frame: int) -> bool:
        """Layer I/II frame: no bit reservoir, decode at the stream
        pointer (after header + optional CRC word)."""
        if h.flags & F_PROTECTION:
            # CRC seed covers header bits 16..31 (frame.c:155)
            h.crc_target_init = _bit_crc(data, this_frame * 8 + 16, 16,
                                         0xFFFF)
        try:
            if h.layer == 1:
                _layer_I(b, h, self.fs.sbsample, data, b.pos)
            else:
                _layer_II(b, h, self.fs.sbsample, data, b.pos)
        except MadError:
            self.md_len = 0
            return False
        return True

    def _decode_frame(self, data, b: Bits, h: Header, this_frame: int,
                      next_frame: int) -> bool:
        nch = h.nchannels
        lsf = bool(h.flags & F_LSF_EXT)
        si_len = (9 if nch == 1 else 17) if lsf else \
            (17 if nch == 1 else 32)
        try:
            si, data_bitlen = read_sideinfo(b, nch, lsf)
        except MadError:
            self.md_len = 0
            return False

        # next frame's main_data_begin (mad_layer_III:2596-2611)
        next_md_begin = 0
        pk = Bits(data, next_frame * 8)
        hdr32 = pk.read(32)
        if (hdr32 & 0xFFE60000) == 0xFFE20000:
            if not (hdr32 & 0x00010000):
                pk.skip(16)
            next_md_begin = pk.read(9 if (hdr32 & 0x00080000) else 8)

        frame_space = next_frame - b.nextbyte()
        if next_md_begin > si.main_data_begin + frame_space:
            next_md_begin = 0
        md_len = si.main_data_begin + frame_space - next_md_begin
        frame_used = 0

        ok = True
        if si.main_data_begin == 0:
            ptr = b.copy()
            self.md_len = 0
            frame_used = md_len
            src_this = data[b.nextbyte():next_frame]
        else:
            if si.main_data_begin > self.md_len:
                ok = False          # BADDATAPTR (recoverable: skip frame)
                ptr = None
                src_this = b""
            else:
                reservoir = bytes(
                    self.md[self.md_len - si.main_data_begin:self.md_len])
                if md_len > si.main_data_begin:
                    frame_used = md_len - si.main_data_begin
                    take = data[b.nextbyte():b.nextbyte() + frame_used]
                    self.md[self.md_len:self.md_len + frame_used] = take
                    self.md_len += frame_used
                    reservoir = reservoir + take
                ptr = Bits(bytes(reservoir) +
                           data[b.nextbyte() + frame_used:next_frame] +
                           b"\0" * BUFFER_GUARD, 0)
        frame_free = frame_space - frame_used

        if ok:
            try:
                decode_granules(ptr, h, si, nch, self.fs)
            except MadError:
                ok = False

        # preload reservoir for next frame (mad_layer_III:2656-2690)
        if len(self.md) < BUFFER_MDLEN:
            self.md.extend(b"\0" * (BUFFER_MDLEN - len(self.md)))
        if frame_free >= next_md_begin:
            self.md[:next_md_begin] = data[next_frame - next_md_begin:
                                           next_frame]
            self.md_len = next_md_begin
        else:
            if md_len < si.main_data_begin:
                extra = si.main_data_begin - md_len
                if extra + frame_free > next_md_begin:
                    extra = next_md_begin - frame_free
                if extra < self.md_len:
                    self.md[:extra] = \
                        self.md[self.md_len - extra:self.md_len]
                    self.md_len = extra
            else:
                self.md_len = 0
            self.md[self.md_len:self.md_len + frame_free] = \
                data[next_frame - frame_free:next_frame]
            self.md_len += frame_free
        return ok


def decode(data: bytes, skip_id3: bool = True):
    """Decode an MP3 buffer to int16 PCM.

    Returns (pcm interleaved int16, samplerate, channels) — the same
    stream the daemon's libmad task produces (mad_output,
    wmixTask.c:1847-1950)."""
    from wmix_tpu_torch.codecs import adts
    if skip_id3:
        n = adts.id3_len(data)
        data = data[n:] if n else data
    return Mp3Decoder().decode(bytes(data))
