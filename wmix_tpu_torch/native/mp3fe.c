/*
 * Native MP3 Layer III front-end: sync, bit reservoir, sideinfo,
 * scalefactors, Huffman + requantization, joint stereo, reorder, alias
 * reduction and IMDCT -- everything BEFORE the polyphase synthesis,
 * which runs batched on the device (wmix_tpu_torch/codecs/mp3_batch.py).
 *
 * This is a line-for-line port of the repo's own Python decoder
 * (wmix_tpu_torch/codecs/mp3.py, itself a bit-exact re-derivation of the
 * reference's libmad build: FPM_DEFAULT + OPT_SPEED Q28 arithmetic,
 * pkg/libmad-0.15.1b via Makefile:258-266, driven from
 * src/wmixTask.c:1809-2102).  All arithmetic is 32-bit wraparound
 * (compile with -fwrapv); constants come from mp3fe_tables.h, generated
 * from the same _mp3_tables.py the Python decoder uses.
 *
 * Why native: the daemon decodes MP3 in real time on a Raspberry Pi;
 * the rebuild's per-frame bitstream work in Python capped end-to-end
 * decode at ~1 real-time stream (CODEC_r03).  This front-end feeds the
 * batched device synthesis at hundreds of real-time streams per core.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "mp3fe_tables.h"

#define BUFFER_GUARD 8
#define BUFFER_MDLEN (511 + 2048 + BUFFER_GUARD)

/* header flags (mad.h) */
#define F_LSF_EXT 0x1000
#define F_MPEG_2_5_EXT 0x2000
#define F_PROTECTION 0x0010
#define F_PADDING 0x0080
#define F_I_STEREO 0x0100
#define F_MS_STEREO 0x0200

#define MODE_SINGLE 0
#define MODE_JOINT 2

#define I_STEREO 0x1
#define MS_STEREO 0x2

#define COUNT1TABLE_SELECT 0x01
#define SCALEFAC_SCALE 0x02
#define PREFLAG 0x04
#define MIXED_BLOCK_FLAG 0x08

static const int BITRATE_TABLE[5][15] = {
    {0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448},
    {0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384},
    {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320},
    {0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256},
    {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160},
};
static const int SAMPLERATE_TABLE[3] = {44100, 48000, 32000};

/* mad_f_mul, FPM_DEFAULT + OPT_SPEED: (x>>12)*(y>>16) in int32 */
static inline int32_t f_mul(int32_t x, int32_t y)
{
    return (int32_t)((x >> 12) * (y >> 16));
}

/* ---------------------------------------------------------------- bits */

typedef struct
{
    const uint8_t *data;
    int64_t len; /* bytes */
    int64_t pos; /* absolute bit position */
} Bits;

static uint32_t bits_read(Bits *b, int n)
{
    uint32_t v = 0;
    int64_t pos = b->pos;
    while (n > 0)
    {
        int64_t byte_i = pos >> 3;
        int off = (int)(pos & 7);
        int avail = 8 - off;
        int take = n < avail ? n : avail;
        uint8_t byte = byte_i < b->len ? b->data[byte_i] : 0;
        v = (v << take) |
            ((uint32_t)(byte >> (avail - take)) & ((1u << take) - 1));
        pos += take;
        n -= take;
    }
    b->pos = pos;
    return v;
}

static inline void bits_skip(Bits *b, int64_t n) { b->pos += n; }
static inline int64_t bits_nextbyte(Bits *b) { return (b->pos + 7) >> 3; }

/* -------------------------------------------------------------- header */

typedef struct
{
    int layer, mode, mode_extension, bitrate, samplerate, flags;
} Header;

/* returns 0 ok, -1 error (MadError) */
static int decode_header(Bits *b, Header *h)
{
    memset(h, 0, sizeof(*h));
    h->layer = 3;
    bits_skip(b, 11);
    if (bits_read(b, 1) == 0)
        h->flags |= F_MPEG_2_5_EXT;
    if (bits_read(b, 1) == 0)
        h->flags |= F_LSF_EXT;
    else if (h->flags & F_MPEG_2_5_EXT)
        return -1; /* LOSTSYNC */
    h->layer = 4 - (int)bits_read(b, 2);
    if (h->layer == 4)
        return -1; /* BADLAYER */
    if (bits_read(b, 1) == 0)
        h->flags |= F_PROTECTION;
    {
        int index = (int)bits_read(b, 4);
        if (index == 15)
            return -1; /* BADBITRATE */
        if (h->flags & F_LSF_EXT)
            h->bitrate = BITRATE_TABLE[3 + (h->layer >> 1)][index] * 1000;
        else
            h->bitrate = BITRATE_TABLE[h->layer - 1][index] * 1000;
    }
    {
        int index = (int)bits_read(b, 2);
        if (index == 3)
            return -1; /* BADSAMPLERATE */
        h->samplerate = SAMPLERATE_TABLE[index];
        if (h->flags & F_LSF_EXT)
        {
            h->samplerate /= 2;
            if (h->flags & F_MPEG_2_5_EXT)
                h->samplerate /= 2;
        }
    }
    if (bits_read(b, 1))
        h->flags |= F_PADDING;
    bits_read(b, 1); /* private */
    h->mode = 3 - (int)bits_read(b, 2);
    h->mode_extension = (int)bits_read(b, 2);
    bits_read(b, 1); /* copyright */
    bits_read(b, 1); /* original */
    bits_read(b, 2); /* emphasis */
    if (h->flags & F_PROTECTION)
        bits_read(b, 16); /* crc_target (unchecked, like the daemon) */
    return 0;
}

static inline int h_nchannels(const Header *h)
{
    return h->mode == MODE_SINGLE ? 1 : 2;
}

static inline int h_nbsamples(const Header *h)
{
    if (h->layer == 1)
        return 12;
    if (h->layer == 3 && (h->flags & F_LSF_EXT))
        return 18;
    return 36;
}

/* ------------------------------------------------------------ sideinfo */

typedef struct
{
    int part2_3_length, big_values, global_gain, scalefac_compress;
    int flags, block_type;
    int table_select[3], subblock_gain[3];
    int region0_count, region1_count;
    int scalefac[39];
} ChannelSI;

typedef struct
{
    int main_data_begin, private_bits;
    int scfsi[2];
    ChannelSI gr[2][2];
} SideInfo;

static int read_sideinfo(Bits *b, int nch, int lsf, SideInfo *si,
                         int *data_bitlen)
{
    int gr, ch, i;
    memset(si, 0, sizeof(*si));
    *data_bitlen = 0;
    si->main_data_begin = (int)bits_read(b, lsf ? 8 : 9);
    si->private_bits =
        (int)bits_read(b, lsf ? (nch == 1 ? 1 : 2) : (nch == 1 ? 5 : 3));
    {
        int ngr = 1;
        if (!lsf)
        {
            ngr = 2;
            for (ch = 0; ch < nch; ch++)
                si->scfsi[ch] = (int)bits_read(b, 4);
        }
        for (gr = 0; gr < ngr; gr++)
            for (ch = 0; ch < nch; ch++)
            {
                ChannelSI *c = &si->gr[gr][ch];
                c->part2_3_length = (int)bits_read(b, 12);
                c->big_values = (int)bits_read(b, 9);
                c->global_gain = (int)bits_read(b, 8);
                c->scalefac_compress = (int)bits_read(b, lsf ? 9 : 4);
                *data_bitlen += c->part2_3_length;
                if (c->big_values > 288)
                    return -1; /* BADBIGVALUES */
                c->flags = 0;
                if (bits_read(b, 1))
                { /* window_switching_flag */
                    c->block_type = (int)bits_read(b, 2);
                    if (c->block_type == 0)
                        return -1; /* BADBLOCKTYPE */
                    if (!lsf && c->block_type == 2 && si->scfsi[ch])
                        return -1; /* BADSCFSI */
                    c->region0_count = 7;
                    c->region1_count = 36;
                    if (bits_read(b, 1))
                        c->flags |= MIXED_BLOCK_FLAG;
                    else if (c->block_type == 2)
                        c->region0_count = 8;
                    for (i = 0; i < 2; i++)
                        c->table_select[i] = (int)bits_read(b, 5);
                    for (i = 0; i < 3; i++)
                        c->subblock_gain[i] = (int)bits_read(b, 3);
                }
                else
                {
                    c->block_type = 0;
                    for (i = 0; i < 3; i++)
                        c->table_select[i] = (int)bits_read(b, 5);
                    c->region0_count = (int)bits_read(b, 4);
                    c->region1_count = (int)bits_read(b, 3);
                }
                c->flags |= (int)bits_read(b, lsf ? 2 : 3);
            }
    }
    return 0;
}

/* -------------------------------------------------------- scalefactors */

static int read_scalefactors(Bits *b, ChannelSI *ch, const ChannelSI *gr0ch,
                             int scfsi)
{
    int64_t start = b->pos;
    int slen1 = SFLEN1[ch->scalefac_compress];
    int slen2 = SFLEN2[ch->scalefac_compress];
    if (ch->block_type == 2)
    {
        int sfbi = 0, k;
        int nsfb = (ch->flags & MIXED_BLOCK_FLAG) ? 8 + 3 * 3 : 6 * 3;
        for (k = 0; k < nsfb; k++)
            ch->scalefac[sfbi++] = (int)bits_read(b, slen1);
        for (k = 0; k < 6 * 3; k++)
            ch->scalefac[sfbi++] = (int)bits_read(b, slen2);
        for (k = 0; k < 3; k++)
            ch->scalefac[sfbi++] = 0;
    }
    else
    {
        static const int LO[4] = {0, 6, 11, 16}, HI[4] = {6, 11, 16, 21};
        static const int BIT[4] = {0x8, 0x4, 0x2, 0x1};
        int part, i;
        for (part = 0; part < 4; part++)
        {
            int slen = part < 2 ? slen1 : slen2;
            if (scfsi & BIT[part])
                for (i = LO[part]; i < HI[part]; i++)
                    ch->scalefac[i] = gr0ch->scalefac[i];
            else
                for (i = LO[part]; i < HI[part]; i++)
                    ch->scalefac[i] = (int)bits_read(b, slen);
        }
        ch->scalefac[21] = 0;
    }
    return (int)(b->pos - start);
}

static int read_scalefactors_lsf(Bits *b, ChannelSI *ch, ChannelSI *gr1ch,
                                 int mode_extension)
{
    int64_t start = b->pos;
    int sfc = ch->scalefac_compress;
    int index = ch->block_type == 2
                    ? ((ch->flags & MIXED_BLOCK_FLAG) ? 2 : 1)
                    : 0;
    int slen[4];
    const int32_t *nsfb;
    int n = 0, part;
    if (!((mode_extension & I_STEREO) && gr1ch != NULL))
    {
        if (sfc < 400)
        {
            slen[0] = (sfc >> 4) / 5;
            slen[1] = (sfc >> 4) % 5;
            slen[2] = (sfc % 16) >> 2;
            slen[3] = sfc % 4;
            nsfb = &NSFB_TABLE[(0 * 3 + index) * 4];
        }
        else if (sfc < 500)
        {
            sfc -= 400;
            slen[0] = (sfc >> 2) / 5;
            slen[1] = (sfc >> 2) % 5;
            slen[2] = sfc % 4;
            slen[3] = 0;
            nsfb = &NSFB_TABLE[(1 * 3 + index) * 4];
        }
        else
        {
            sfc -= 500;
            slen[0] = sfc / 3;
            slen[1] = sfc % 3;
            slen[2] = 0;
            slen[3] = 0;
            nsfb = &NSFB_TABLE[(2 * 3 + index) * 4];
            ch->flags |= PREFLAG;
        }
        for (part = 0; part < 4; part++)
        {
            int k;
            for (k = 0; k < nsfb[part]; k++)
                ch->scalefac[n++] = (int)bits_read(b, slen[part]);
        }
        while (n < 39)
            ch->scalefac[n++] = 0;
    }
    else
    {
        sfc >>= 1;
        if (sfc < 180)
        {
            slen[0] = sfc / 36;
            slen[1] = (sfc % 36) / 6;
            slen[2] = (sfc % 36) % 6;
            slen[3] = 0;
            nsfb = &NSFB_TABLE[(3 * 3 + index) * 4];
        }
        else if (sfc < 244)
        {
            sfc -= 180;
            slen[0] = (sfc % 64) >> 4;
            slen[1] = (sfc % 16) >> 2;
            slen[2] = sfc % 4;
            slen[3] = 0;
            nsfb = &NSFB_TABLE[(4 * 3 + index) * 4];
        }
        else
        {
            sfc -= 244;
            slen[0] = sfc / 3;
            slen[1] = sfc % 3;
            slen[2] = 0;
            slen[3] = 0;
            nsfb = &NSFB_TABLE[(5 * 3 + index) * 4];
        }
        for (part = 0; part < 4; part++)
        {
            int maxv = (1 << slen[part]) - 1;
            int k;
            for (k = 0; k < nsfb[part]; k++)
            {
                int is_pos = (int)bits_read(b, slen[part]);
                ch->scalefac[n] = is_pos;
                gr1ch->scalefac[n] = (is_pos == maxv) ? 1 : 0;
                n++;
            }
        }
        while (n < 39)
        {
            ch->scalefac[n] = 0;
            gr1ch->scalefac[n] = 0;
            n++;
        }
    }
    return (int)(b->pos - start);
}

/* ------------------------------------------------------- requantization */

static void exponents(const ChannelSI *ch, const int32_t *sfbwidth,
                      int exps[39])
{
    int gain = ch->global_gain - 210;
    int mult = (ch->flags & SCALEFAC_SCALE) ? 2 : 1;
    memset(exps, 0, 39 * sizeof(int));
    if (ch->block_type == 2)
    {
        int sfbi = 0, el = 0, w;
        if (ch->flags & MIXED_BLOCK_FLAG)
        {
            int pre = (ch->flags & PREFLAG) != 0;
            while (el < 36)
            {
                exps[sfbi] = gain - ((ch->scalefac[sfbi] +
                                      (pre ? PRETAB[sfbi] : 0))
                                     << mult);
                el += sfbwidth[sfbi];
                sfbi++;
            }
        }
        {
            int g[3];
            for (w = 0; w < 3; w++)
                g[w] = gain - 8 * ch->subblock_gain[w];
            while (el < 576)
            {
                for (w = 0; w < 3; w++)
                    exps[sfbi + w] =
                        g[w] - (ch->scalefac[sfbi + w] << mult);
                el += 3 * sfbwidth[sfbi];
                sfbi += 3;
            }
        }
    }
    else
    {
        int pre = (ch->flags & PREFLAG) != 0;
        int sfbi;
        for (sfbi = 0; sfbi < 22; sfbi++)
        {
            int p = pre ? PRETAB[sfbi] : 0;
            exps[sfbi] = gain - ((ch->scalefac[sfbi] + p) << mult);
        }
    }
}

static int32_t requantize(int value, int exp)
{
    int frac, e;
    int64_t requantized;
    if (exp < 0)
    {
        frac = -((-exp) % 4);
        e = -((-exp) / 4);
    }
    else
    {
        frac = exp % 4;
        e = exp / 4;
    }
    requantized = RQ_MANT[value];
    e += RQ_EXP[value];
    if (e < 0)
    {
        if (-e >= 32)
            requantized = 0;
        else
            requantized = (requantized + ((int64_t)1 << (-e - 1))) >> (-e);
    }
    else
    {
        if (e >= 5)
            requantized = 0x7FFFFFFF;
        else
            requantized = (int32_t)(requantized << e);
    }
    if (frac)
        return f_mul((int32_t)requantized, ROOT_TABLE[3 + frac]);
    return (int32_t)requantized;
}

/* ------------------------------------------------------------- huffman */

/* returns 0 ok, -1 error */
static int huffdecode(Bits *b, ChannelSI *ch, const int32_t *sfbwidth,
                      int sfbw_len, int part2_length, int32_t xr[576])
{
    int bits_left = ch->part2_3_length - part2_length;
    int exps[39];
    Bits peek;
    uint64_t bitcache;
    int cachesz;
    int sfb_i, sfbound, exp, exp_idx, xi, region, rcount;
    const uint16_t *tab;
    int linbits, startbits;
    int32_t reqcache[16];
    int reqhits = 0;
    int big_values;

    if (bits_left < 0)
        return -1; /* BADPART3LEN */
    exponents(ch, sfbwidth, exps);
    memset(xr, 0, 576 * sizeof(int32_t));

    peek = *b;
    bits_skip(b, bits_left);

    cachesz = 8 - (int)(peek.pos & 7);
    cachesz += ((32 - 1 - 24) + (24 - cachesz)) & ~7;
    bitcache = bits_read(&peek, cachesz);
    bits_left -= cachesz;

    sfb_i = 0;
    sfbound = sfbwidth[sfb_i++];
    exp = exps[0];
    exp_idx = 1;

    xi = 0;
    region = 0;
    rcount = ch->region0_count + 1;
    if (HUFF_PAIR_LEN[ch->table_select[0]] == 0)
        return -1; /* BADHUFFTABLE */
    tab = &HUFF_PAIR_FLAT[HUFF_PAIR_OFF[ch->table_select[0]]];
    linbits = HUFF_LINBITS[ch->table_select[0]];
    startbits = HUFF_STARTBITS[ch->table_select[0]];

    big_values = ch->big_values;
    while (big_values > 0 && cachesz + bits_left > 0)
    {
        uint32_t v;
        int clumpsz, slot;
        big_values--;
        if (xi == sfbound)
        {
            if (sfb_i < sfbw_len)
                sfbound += sfbwidth[sfb_i];
            sfb_i++;
            rcount--;
            if (rcount == 0)
            {
                if (region == 0)
                    rcount = ch->region1_count + 1;
                else
                    rcount = 0;
                region++;
                if (HUFF_PAIR_LEN[ch->table_select[region]] == 0)
                    return -1; /* BADHUFFTABLE */
                tab = &HUFF_PAIR_FLAT[HUFF_PAIR_OFF[
                    ch->table_select[region]]];
                linbits = HUFF_LINBITS[ch->table_select[region]];
                startbits = HUFF_STARTBITS[ch->table_select[region]];
            }
            if (exp != exps[exp_idx])
            {
                exp = exps[exp_idx];
                reqhits = 0;
            }
            exp_idx++;
        }

        if (cachesz < 21)
        {
            int nbits = ((32 - 1 - 21) + (21 - cachesz)) & ~7;
            bitcache = (bitcache << nbits) | bits_read(&peek, nbits);
            cachesz += nbits;
            bits_left -= nbits;
        }

        clumpsz = startbits;
        v = tab[(bitcache >> (cachesz - clumpsz)) &
                (((uint64_t)1 << clumpsz) - 1)];
        while (!(v & 1))
        {
            cachesz -= clumpsz;
            clumpsz = (v >> 1) & 0x7;
            v = tab[((v >> 4) & 0xFFF) +
                    ((bitcache >> (cachesz - clumpsz)) &
                     (((uint64_t)1 << clumpsz) - 1))];
        }
        cachesz -= (v >> 1) & 0x7; /* hlen */

        for (slot = 0; slot < 2; slot++)
        {
            int val = slot == 0 ? ((v >> 4) & 0xF) : ((v >> 8) & 0xF);
            int32_t req;
            if (val == 0)
            {
                xr[xi + slot] = 0;
                continue;
            }
            if (linbits && val == 15)
            {
                if (cachesz < linbits + 2 - slot)
                {
                    bitcache = (bitcache << 16) | bits_read(&peek, 16);
                    cachesz += 16;
                    bits_left -= 16;
                }
                val += (int)((bitcache >> (cachesz - linbits)) &
                             (((uint64_t)1 << linbits) - 1));
                cachesz -= linbits;
                req = requantize(val, exp);
            }
            else if (reqhits & (1 << val))
            {
                req = reqcache[val];
            }
            else
            {
                reqhits |= 1 << val;
                req = reqcache[val] = requantize(val, exp);
            }
            if (bitcache & ((uint64_t)1 << (cachesz - 1)))
                req = -req;
            cachesz -= 1;
            xr[xi + slot] = req;
        }
        xi += 2;
    }

    if (cachesz + bits_left < 0)
        return -1; /* BADHUFFDATA */

    /* count1 */
    {
        const uint16_t *qtab =
            &HUFF_QUAD_FLAT[HUFF_QUAD_OFF[ch->flags & COUNT1TABLE_SELECT]];
        int32_t req1 = requantize(1, exp);
        while (cachesz + bits_left > 0 && xi <= 572)
        {
            uint32_t v;
            int bit;
            if (cachesz < 10)
            {
                bitcache = (bitcache << 16) | bits_read(&peek, 16);
                cachesz += 16;
                bits_left -= 16;
            }
            v = qtab[(bitcache >> (cachesz - 4)) & 0xF];
            if (!(v & 1))
            {
                int bits2 = (v >> 1) & 0x7;
                cachesz -= 4;
                v = qtab[((v >> 4) & 0xFFF) +
                         ((bitcache >> (cachesz - bits2)) &
                          (((uint64_t)1 << bits2) - 1))];
            }
            cachesz -= (v >> 1) & 0x7;

            if (xi == sfbound)
            {
                if (sfb_i < sfbw_len)
                    sfbound += sfbwidth[sfb_i];
                sfb_i++;
                if (exp != exps[exp_idx])
                {
                    exp = exps[exp_idx];
                    req1 = requantize(1, exp);
                }
                exp_idx++;
            }
            for (bit = 4; bit < 6; bit++)
            { /* v, w */
                if ((v >> bit) & 1)
                {
                    int32_t r = req1;
                    if (bitcache & ((uint64_t)1 << (cachesz - 1)))
                        r = -r;
                    cachesz -= 1;
                    xr[xi] = r;
                }
                else
                    xr[xi] = 0;
                xi++;
            }
            if (xi == sfbound)
            {
                if (sfb_i < sfbw_len)
                    sfbound += sfbwidth[sfb_i];
                sfb_i++;
                if (exp != exps[exp_idx])
                {
                    exp = exps[exp_idx];
                    req1 = requantize(1, exp);
                }
                exp_idx++;
            }
            for (bit = 6; bit < 8; bit++)
            { /* x, y */
                if ((v >> bit) & 1)
                {
                    int32_t r = req1;
                    if (bitcache & ((uint64_t)1 << (cachesz - 1)))
                        r = -r;
                    cachesz -= 1;
                    xr[xi] = r;
                }
                else
                    xr[xi] = 0;
                xi++;
            }
        }
        if (cachesz + bits_left < 0)
        {
            xi -= 4;
            if (xi < 0)
                xi = 0;
        }
    }
    memset(&xr[xi], 0, (576 - xi) * sizeof(int32_t));
    return 0;
}

/* -------------------------------------------------------------- stereo */

static int any_nonzero(const int32_t *p, int n)
{
    int i;
    for (i = 0; i < n; i++)
        if (p[i])
            return 1;
    return 0;
}

static int do_stereo(int32_t *xr0, int32_t *xr1, ChannelSI *ch0,
                     ChannelSI *ch1, Header *header,
                     const int32_t *sfbwidth, ChannelSI *gr1ch1)
{
    int modes[39];
    int sfbi, el, i;
    if (ch0->block_type != ch1->block_type ||
        (ch0->flags & MIXED_BLOCK_FLAG) != (ch1->flags & MIXED_BLOCK_FLAG))
        return -1; /* BADSTEREO */
    for (i = 0; i < 39; i++)
        modes[i] = header->mode_extension;

    if (header->mode_extension & I_STEREO)
    {
        ChannelSI *right_ch = ch1;
        header->flags |= F_I_STEREO;
        if (right_ch->block_type == 2)
        {
            int lower = 0, start = 0, maxv = 0;
            int bound[3] = {0, 0, 0};
            int ri = 0, w;
            sfbi = el = 0;
            if (right_ch->flags & MIXED_BLOCK_FLAG)
            {
                while (el < 36)
                {
                    int n = sfbwidth[sfbi];
                    sfbi++;
                    if (any_nonzero(&xr1[ri], n))
                        lower = sfbi;
                    ri += n;
                    el += n;
                }
                start = sfbi;
            }
            w = 0;
            while (el < 576)
            {
                int n = sfbwidth[sfbi];
                sfbi++;
                if (any_nonzero(&xr1[ri], n))
                {
                    maxv = sfbi;
                    bound[w] = sfbi;
                }
                ri += n;
                el += n;
                w = (w + 1) % 3;
            }
            if (maxv)
                lower = start;
            for (i = 0; i < lower; i++)
                modes[i] = header->mode_extension & ~I_STEREO;
            w = 0;
            for (i = start; i < maxv; i++)
            {
                if (i < bound[w])
                    modes[i] = header->mode_extension & ~I_STEREO;
                w = (w + 1) % 3;
            }
        }
        else
        {
            int bnd = 0, ri = 0;
            sfbi = el = 0;
            while (el < 576)
            {
                int n = sfbwidth[sfbi];
                sfbi++;
                if (any_nonzero(&xr1[ri], n))
                    bnd = sfbi;
                ri += n;
                el += n;
            }
            for (i = 0; i < bnd; i++)
                modes[i] = header->mode_extension & ~I_STEREO;
        }

        if (header->flags & F_LSF_EXT)
        {
            const int *illegal_pos = gr1ch1->scalefac;
            const int32_t *lsf_scale =
                &IS_LSF_TABLE[(right_ch->scalefac_compress & 0x1) * 15];
            el = 0;
            for (sfbi = 0; sfbi < 39; sfbi++)
            {
                int n;
                if (el >= 576)
                    break;
                n = sfbwidth[sfbi];
                if (!(modes[sfbi] & I_STEREO))
                {
                    el += n;
                    continue;
                }
                if (illegal_pos[sfbi])
                {
                    modes[sfbi] &= ~I_STEREO;
                    el += n;
                    continue;
                }
                {
                    int is_pos = right_ch->scalefac[sfbi];
                    int k;
                    if (is_pos == 0)
                    {
                        for (k = 0; k < n; k++)
                            xr1[el + k] = xr0[el + k];
                    }
                    else
                    {
                        int32_t sc = lsf_scale[(is_pos - 1) / 2];
                        if (is_pos & 1)
                            for (k = 0; k < n; k++)
                            {
                                int32_t left = xr0[el + k];
                                xr0[el + k] = f_mul(left, sc);
                                xr1[el + k] = left;
                            }
                        else
                            for (k = 0; k < n; k++)
                                xr1[el + k] = f_mul(xr0[el + k], sc);
                    }
                }
                el += n;
            }
        }
        else
        {
            el = 0;
            for (sfbi = 0; sfbi < 39; sfbi++)
            {
                int n, is_pos;
                if (el >= 576)
                    break;
                n = sfbwidth[sfbi];
                if (!(modes[sfbi] & I_STEREO))
                {
                    el += n;
                    continue;
                }
                is_pos = right_ch->scalefac[sfbi];
                if (is_pos >= 7)
                {
                    modes[sfbi] &= ~I_STEREO;
                    el += n;
                    continue;
                }
                {
                    int k;
                    for (k = 0; k < n; k++)
                    {
                        int32_t left = xr0[el + k];
                        xr0[el + k] = f_mul(left, IS_TABLE[is_pos]);
                        xr1[el + k] = f_mul(left, IS_TABLE[6 - is_pos]);
                    }
                }
                el += n;
            }
        }
    }

    if (header->mode_extension & MS_STEREO)
    {
        int32_t invsqrt2 = ROOT_TABLE[3 - 2];
        header->flags |= F_MS_STEREO;
        el = 0;
        for (sfbi = 0; sfbi < 39; sfbi++)
        {
            int n, k;
            if (el >= 576)
                break;
            n = sfbwidth[sfbi];
            if (modes[sfbi] != MS_STEREO)
            {
                el += n;
                continue;
            }
            for (k = 0; k < n; k++)
            {
                int32_t m = xr0[el + k], s = xr1[el + k];
                xr0[el + k] = f_mul(m + s, invsqrt2);
                xr1[el + k] = f_mul(m - s, invsqrt2);
            }
            el += n;
        }
    }
    return 0;
}

/* ----------------------------------------------------- reorder / alias */

static void reorder(int32_t *xr, const ChannelSI *ch,
                    const int32_t *sfbwidth)
{
    int32_t tmp[32][3][6];
    int sb = 0, si = 0, w, f, el;
    int sbw[3], sw[3];
    memset(tmp, 0, sizeof(tmp));
    if (ch->flags & MIXED_BLOCK_FLAG)
    {
        sb = 2;
        el = 0;
        while (el < 36)
        {
            el += sfbwidth[si];
            si++;
        }
    }
    sbw[0] = sbw[1] = sbw[2] = sb;
    sw[0] = sw[1] = sw[2] = 0;
    f = sfbwidth[si];
    si++;
    w = 0;
    for (el = 18 * sb; el < 576; el++)
    {
        if (f == 0)
        {
            f = sfbwidth[si] - 1;
            si++;
            w = (w + 1) % 3;
        }
        else
            f--;
        tmp[sbw[w]][w][sw[w]] = xr[el];
        sw[w]++;
        if (sw[w] == 6)
        {
            sw[w] = 0;
            sbw[w]++;
        }
    }
    memcpy(&xr[18 * sb], &((int32_t *)tmp)[18 * sb],
           (576 - 18 * sb) * sizeof(int32_t));
}

static void aliasreduce(int32_t *xr, int lines)
{
    int x0, i;
    for (x0 = 18; x0 < lines; x0 += 18)
    {
        for (i = 0; i < 8; i++)
        {
            int32_t a = xr[x0 - 1 - i];
            int32_t bq = xr[x0 + i];
            xr[x0 - 1 - i] = (a >> 12) * (CS_TAB[i] >> 16) +
                             ((-bq) >> 12) * (CA_TAB[i] >> 16);
            xr[x0 + i] = (bq >> 12) * (CS_TAB[i] >> 16) +
                         (a >> 12) * (CA_TAB[i] >> 16);
        }
    }
}

/* --------------------------------------------------------------- imdct */

static void fastsdct(const int32_t *x, int32_t *y /* stride-2 even slots */)
{
    int32_t a0 = x[3] + x[5], a1 = x[3] - x[5];
    int32_t a2 = x[6] + x[2], a3 = x[6] - x[2];
    int32_t a4 = x[1] + x[7], a5 = x[1] - x[7];
    int32_t a6 = x[8] + x[0], a7 = x[8] - x[0];
    int32_t a8 = a0 + a2, a9 = a0 - a2, a10 = a0 - a6, a11 = a2 - a6;
    int32_t a12 = a8 + a6, a13 = a1 - a3, a14 = a13 + a7, a15 = a3 + a7;
    int32_t a16 = a1 - a7, a17 = a1 + a3;
    int32_t m0 = f_mul(a17, -FASTSDCT_C[3]);
    int32_t m1 = f_mul(a16, -FASTSDCT_C[0]);
    int32_t m2 = f_mul(a15, -FASTSDCT_C[4]);
    int32_t m3 = f_mul(a14, -FASTSDCT_C[1]);
    int32_t m4 = f_mul(a5, -FASTSDCT_C[1]);
    int32_t m5 = f_mul(a11, -FASTSDCT_C[6]);
    int32_t m6 = f_mul(a10, -FASTSDCT_C[5]);
    int32_t m7 = f_mul(a9, -FASTSDCT_C[2]);
    int32_t a18 = x[4] + a4;
    int32_t a19 = 2 * x[4] - a4;
    int32_t a20 = a19 + m5, a21 = a19 - m5, a22 = a19 + m6;
    int32_t a23 = m4 + m2, a24 = m4 - m2, a25 = m4 + m1;
    y[0] = a18 + a12;
    y[2] = m0 - a25;
    y[4] = m7 - a20;
    y[6] = m3;
    y[8] = a21 - m6;
    y[10] = a24 - m1;
    y[12] = a12 - 2 * a18;
    y[14] = a23 + m0;
    y[16] = a22 + m7;
}

static void sdct2(const int32_t *x, int32_t *X /* [18] */)
{
    int32_t even[9], odd[9], Xo[18];
    int i;
    for (i = 0; i < 9; i++)
    {
        even[i] = x[i] + x[17 - i];
        odd[i] = f_mul(x[i] - x[17 - i], SDCT_SCALE[i]);
    }
    memset(X, 0, 18 * sizeof(int32_t));
    memset(Xo, 0, sizeof(Xo));
    fastsdct(even, X);
    fastsdct(odd, Xo);
    for (i = 1; i < 18; i += 2)
        X[i] = Xo[i - 1];
    for (i = 3; i < 18; i += 2)
        X[i] = X[i] - X[i - 2];
}

static void dct4(const int32_t *y, int32_t *X /* [18] */)
{
    int32_t tmp[18];
    int i;
    for (i = 0; i < 18; i++)
        tmp[i] = f_mul(y[i], DCTIV_SCALE[i]);
    sdct2(tmp, X);
    X[0] = X[0] / 2; /* C / truncates toward zero */
    for (i = 1; i < 18; i++)
        X[i] = X[i] / 2 - X[i - 1];
}

static void imdct36(const int32_t *x, int32_t *y /* [36] */)
{
    int32_t tmp[18];
    int i;
    dct4(x, tmp);
    for (i = 0; i < 9; i++)
        y[i] = tmp[9 + i];
    for (i = 9; i < 27; i++) /* 26-i runs 17..0 */
        y[i] = -tmp[26 - i];
    for (i = 0; i < 9; i++)
        y[27 + i] = -tmp[i];
}

static void imdct_l(const int32_t *X, int block_type, int32_t *z /* [36] */)
{
    int32_t zz[36];
    int i;
    imdct36(X, zz);
    if (block_type == 0)
    {
        for (i = 0; i < 36; i++)
            z[i] = f_mul(zz[i], WINDOW_L[i]);
    }
    else if (block_type == 1)
    {
        for (i = 0; i < 18; i++)
            z[i] = f_mul(zz[i], WINDOW_L[i]);
        for (i = 18; i < 24; i++)
            z[i] = zz[i];
        for (i = 24; i < 30; i++)
            z[i] = f_mul(zz[i], WINDOW_S[i - 18]);
        for (i = 30; i < 36; i++)
            z[i] = 0;
    }
    else if (block_type == 3)
    {
        for (i = 0; i < 6; i++)
            z[i] = 0;
        for (i = 6; i < 12; i++)
            z[i] = f_mul(zz[i], WINDOW_S[i - 6]);
        for (i = 12; i < 18; i++)
            z[i] = zz[i];
        for (i = 18; i < 36; i++)
            z[i] = f_mul(zz[i], WINDOW_L[i]);
    }
    else
    {
        for (i = 0; i < 36; i++)
            z[i] = zz[i];
    }
}

static void imdct_s(const int32_t *X, int32_t *z /* [36] */)
{
    int32_t y[36];
    int w, i, k;
    memset(y, 0, sizeof(y));
    for (w = 0; w < 3; w++)
    {
        const int32_t *Xw = &X[6 * w];
        int base = 12 * w;
        for (i = 0; i < 3; i++)
        {
            int32_t v = 0, v2 = 0;
            for (k = 0; k < 6; k++)
            {
                v += (Xw[k] >> 12) * (IMDCT_S_TAB[(2 * i) * 6 + k] >> 16);
                v2 += (Xw[k] >> 12) *
                      (IMDCT_S_TAB[(2 * i + 1) * 6 + k] >> 16);
            }
            y[base + i] = v;
            y[base + 5 - i] = -v;
            y[base + i + 6] = v2;
            y[base + 11 - i] = v2;
        }
    }
    memset(z, 0, 36 * sizeof(int32_t));
    for (i = 0; i < 6; i++)
    {
        z[i + 6] = f_mul(y[i], WINDOW_S[i]);
        z[i + 12] = f_mul(y[i + 6], WINDOW_S[i + 6]) +
                    f_mul(y[12 + i], WINDOW_S[i]);
        z[i + 18] = f_mul(y[12 + i + 6], WINDOW_S[i + 6]) +
                    f_mul(y[24 + i], WINDOW_S[i]);
        z[i + 24] = f_mul(y[24 + i + 6], WINDOW_S[i + 6]);
    }
}

/* ---------------------------------------------------------- III_decode */

typedef struct Mp3FE
{
    const uint8_t *data;
    int64_t end;
    int64_t pos;
    int sync;
    uint8_t md[BUFFER_MDLEN];
    int md_len;
    int32_t overlap[2][32][18];
    uint8_t scratch[BUFFER_MDLEN + 2048 + BUFFER_GUARD];
} Mp3FE;

static void freqinver(int32_t *sample /* [36][32] rows */, int sb, int ns)
{
    int i;
    for (i = 1; i < ns; i += 2)
        sample[i * 32 + sb] = -sample[i * 32 + sb];
}

/* returns 0 ok, -1 error */
static int decode_granules(Bits *b, Header *header, SideInfo *si, int nch,
                           Mp3FE *fe, int32_t *sbsample /* [2][36][32] */)
{
    int sfreq = header->samplerate;
    int sfreqi, ngr, gr, ch;
    int32_t xr[2][576];
    if (header->flags & F_MPEG_2_5_EXT)
        sfreq *= 2;
    sfreqi = ((sfreq >> 7) & 0xF) + ((sfreq >> 15) & 0x1) - 8;
    if (header->flags & F_MPEG_2_5_EXT)
        sfreqi += 3;

    ngr = (header->flags & F_LSF_EXT) ? 1 : 2;
    for (gr = 0; gr < ngr; gr++)
    {
        const int32_t *sfbw[2];
        int sfbw_len[2];
        for (ch = 0; ch < nch; ch++)
        {
            ChannelSI *c = &si->gr[gr][ch];
            int kind = 0, part2;
            if (c->block_type == 2)
                kind = (c->flags & MIXED_BLOCK_FLAG) ? 2 : 1;
            sfbw[ch] = &SFBWIDTH_TAB[(sfreqi * 3 + kind) * 40];
            sfbw_len[ch] = SFBWIDTH_LEN[sfreqi * 3 + kind];
            if (header->flags & F_LSF_EXT)
                part2 = read_scalefactors_lsf(
                    b, c, ch == 1 ? &si->gr[1][1] : NULL,
                    header->mode_extension);
            else
                part2 = read_scalefactors(
                    b, c, &si->gr[0][ch], gr == 0 ? 0 : si->scfsi[ch]);
            if (huffdecode(b, c, sfbw[ch], sfbw_len[ch], part2,
                           xr[ch]) != 0)
                return -1;
        }

        if (header->mode == MODE_JOINT && header->mode_extension)
        {
            if (do_stereo(xr[0], xr[1], &si->gr[gr][0], &si->gr[gr][1],
                          header, sfbw[0],
                          (header->flags & F_LSF_EXT) ? &si->gr[1][1]
                                                      : NULL) != 0)
                return -1;
        }

        for (ch = 0; ch < nch; ch++)
        {
            ChannelSI *c = &si->gr[gr][ch];
            /* sample rows: sbsample[ch][18*gr + t][sb] */
            int32_t *sample = &sbsample[(ch * 36 + 18 * gr) * 32];
            int el = 0, sb, i, sblimit;
            if (c->block_type == 2)
            {
                reorder(xr[ch], c, sfbw[ch]);
                if (c->flags & MIXED_BLOCK_FLAG)
                    aliasreduce(xr[ch], 36);
            }
            else
                aliasreduce(xr[ch], 576);

            if (c->block_type != 2 || (c->flags & MIXED_BLOCK_FLAG))
            {
                int bt = (c->flags & MIXED_BLOCK_FLAG) ? 0 : c->block_type;
                for (sb = 0; sb < 2; sb++)
                {
                    int32_t out[36];
                    imdct_l(&xr[ch][el], bt, out);
                    for (i = 0; i < 18; i++)
                        sample[i * 32 + sb] =
                            out[i] + fe->overlap[ch][sb][i];
                    for (i = 0; i < 18; i++)
                        fe->overlap[ch][sb][i] = out[18 + i];
                    el += 18;
                }
            }
            else
            {
                for (sb = 0; sb < 2; sb++)
                {
                    int32_t out[36];
                    imdct_s(&xr[ch][el], out);
                    for (i = 0; i < 18; i++)
                        sample[i * 32 + sb] =
                            out[i] + fe->overlap[ch][sb][i];
                    for (i = 0; i < 18; i++)
                        fe->overlap[ch][sb][i] = out[18 + i];
                    el += 18;
                }
            }
            freqinver(sample, 1, 18);

            i = 576;
            while (i > 36 && xr[ch][i - 1] == 0)
                i--;
            sblimit = 32 - (576 - i) / 18;

            for (sb = 2; sb < sblimit; sb++)
            {
                int32_t out[36];
                if (c->block_type != 2)
                    imdct_l(&xr[ch][el], c->block_type, out);
                else
                    imdct_s(&xr[ch][el], out);
                for (i = 0; i < 18; i++)
                    sample[i * 32 + sb] = out[i] + fe->overlap[ch][sb][i];
                for (i = 0; i < 18; i++)
                    fe->overlap[ch][sb][i] = out[18 + i];
                el += 18;
                if (sb & 1)
                    freqinver(sample, sb, 18);
            }
            for (sb = sblimit; sb < 32; sb++)
            {
                for (i = 0; i < 18; i++)
                    sample[i * 32 + sb] = fe->overlap[ch][sb][i];
                memset(fe->overlap[ch][sb], 0, 18 * sizeof(int32_t));
                if (sb & 1)
                    freqinver(sample, sb, 18);
            }
        }
    }
    return 0;
}

/* -------------------------------------------------------- stream layer */

Mp3FE *mp3fe_new(const uint8_t *data, int64_t len)
{
    Mp3FE *fe = (Mp3FE *)calloc(1, sizeof(Mp3FE));
    if (!fe)
        return NULL;
    fe->data = data;
    fe->end = len;
    fe->pos = 0;
    fe->sync = 1;
    fe->md_len = 0;
    return fe;
}

void mp3fe_free(Mp3FE *fe) { free(fe); }

static int syncword(const Mp3FE *fe, int64_t p)
{
    return p + 1 < fe->end && fe->data[p] == 0xFF &&
           (fe->data[p + 1] & 0xE0) == 0xE0;
}

/* decode one Layer III frame's main data -> sbsample.
 * Mirrors Mp3Decoder._decode_frame (mp3.py) / mad_layer_III. */
static int decode_frame_l3(Mp3FE *fe, Bits *b, Header *h,
                           int64_t this_frame, int64_t next_frame,
                           int32_t *sbsample)
{
    int nch = h_nchannels(h);
    int lsf = (h->flags & F_LSF_EXT) != 0;
    SideInfo si;
    int data_bitlen;
    int next_md_begin = 0;
    int64_t frame_space;
    int md_len, frame_used = 0, frame_free;
    int ok = 1;
    Bits ptr;
    (void)this_frame;

    if (read_sideinfo(b, nch, lsf, &si, &data_bitlen) != 0)
    {
        fe->md_len = 0;
        return 0; /* skip frame */
    }

    /* next frame's main_data_begin (mad_layer_III:2596-2611) */
    {
        Bits pk = {fe->data, fe->end, next_frame * 8};
        uint32_t hdr32 = bits_read(&pk, 32);
        if ((hdr32 & 0xFFE60000u) == 0xFFE20000u)
        {
            if (!(hdr32 & 0x00010000u))
                bits_skip(&pk, 16);
            next_md_begin =
                (int)bits_read(&pk, (hdr32 & 0x00080000u) ? 9 : 8);
        }
    }

    frame_space = next_frame - bits_nextbyte(b);
    if (next_md_begin > si.main_data_begin + frame_space)
        next_md_begin = 0;
    md_len = si.main_data_begin + (int)frame_space - next_md_begin;

    if (si.main_data_begin == 0)
    {
        ptr = *b;
        fe->md_len = 0;
        frame_used = md_len;
    }
    else if (si.main_data_begin > fe->md_len)
    {
        ok = 0; /* BADDATAPTR: recoverable, skip frame */
    }
    else
    {
        /* assemble reservoir + this frame's main data into scratch */
        int res_n = si.main_data_begin;
        int64_t sp = bits_nextbyte(b);
        int64_t n = 0, rest;
        memcpy(fe->scratch, &fe->md[fe->md_len - res_n], res_n);
        n = res_n;
        if (md_len > si.main_data_begin)
        {
            frame_used = md_len - si.main_data_begin;
            memcpy(&fe->md[fe->md_len], &fe->data[sp], frame_used);
            fe->md_len += frame_used;
            memcpy(&fe->scratch[n], &fe->data[sp], frame_used);
            n += frame_used;
        }
        rest = next_frame - (sp + frame_used);
        if (rest > 0)
        {
            memcpy(&fe->scratch[n], &fe->data[sp + frame_used], rest);
            n += rest;
        }
        memset(&fe->scratch[n], 0, BUFFER_GUARD);
        ptr.data = fe->scratch;
        ptr.len = n + BUFFER_GUARD;
        ptr.pos = 0;
    }
    frame_free = (int)frame_space - frame_used;

    if (ok)
        ok = decode_granules(&ptr, h, &si, nch, fe, sbsample) == 0;

    /* preload reservoir for next frame (mad_layer_III:2656-2690) */
    if (frame_free >= next_md_begin)
    {
        memcpy(fe->md, &fe->data[next_frame - next_md_begin],
               next_md_begin);
        fe->md_len = next_md_begin;
    }
    else
    {
        if (md_len < si.main_data_begin)
        {
            int extra = si.main_data_begin - md_len;
            if (extra + frame_free > next_md_begin)
                extra = next_md_begin - frame_free;
            if (extra < fe->md_len)
            {
                memmove(fe->md, &fe->md[fe->md_len - extra], extra);
                fe->md_len = extra;
            }
        }
        else
            fe->md_len = 0;
        memcpy(&fe->md[fe->md_len], &fe->data[next_frame - frame_free],
               frame_free);
        fe->md_len += frame_free;
    }
    return ok;
}

/*
 * Decode the next frame.  Fills sbsample[2*36*32] (int32) and
 * info[6] = {layer, nch, ns, samplerate, bitrate, frame_byte_pos}.
 * Returns 1 = frame decoded, 0 = end of stream, 2 = unsupported layer
 * (I/II -- caller falls back to the Python front-end for the stream).
 */
int mp3fe_next(Mp3FE *fe, int32_t *sbsample, int32_t *info)
{
    for (;;)
    {
        Bits b;
        Header h;
        int64_t N, next_frame;
        int pad;
        if (fe->sync)
        {
            if (fe->end - fe->pos < BUFFER_GUARD)
                return 0; /* BUFLEN */
            if (!syncword(fe, fe->pos))
            {
                fe->sync = 0;
                fe->pos += 1;
                continue;
            }
        }
        else
        {
            while (fe->pos + 1 < fe->end && !syncword(fe, fe->pos))
                fe->pos += 1;
            if (fe->end - fe->pos < BUFFER_GUARD)
                return 0;
        }
        b.data = fe->data;
        b.len = fe->end;
        b.pos = fe->pos * 8;
        if (decode_header(&b, &h) != 0)
        {
            fe->sync = 0;
            fe->pos += 1;
            continue;
        }
        if (h.bitrate == 0)
        { /* free-format unsupported */
            fe->sync = 0;
            fe->pos += 1;
            continue;
        }
        pad = (h.flags & F_PADDING) ? 1 : 0;
        if (h.layer == 1)
            N = ((int64_t)12 * h.bitrate / h.samplerate + pad) * 4;
        else
        {
            int slots =
                (h.layer == 3 && (h.flags & F_LSF_EXT)) ? 72 : 144;
            N = (int64_t)slots * h.bitrate / h.samplerate + pad;
        }
        if (fe->pos + N + BUFFER_GUARD > fe->end)
            return 0; /* incomplete tail frame */
        next_frame = fe->pos + N;
        if (!fe->sync)
        {
            if (!syncword(fe, next_frame))
            {
                fe->pos += 1;
                continue;
            }
            fe->sync = 1;
        }

        info[0] = h.layer;
        info[1] = h_nchannels(&h);
        info[2] = h_nbsamples(&h);
        info[3] = h.samplerate;
        info[4] = h.bitrate;
        info[5] = (int32_t)fe->pos;

        if (h.layer != 3)
            return 2; /* caller falls back (position NOT advanced) */

        {
            int ok = decode_frame_l3(fe, &b, &h, fe->pos, next_frame,
                                     sbsample);
            fe->pos = next_frame;
            if (ok)
                return 1;
            /* recoverable error: continue to next frame */
        }
    }
}
