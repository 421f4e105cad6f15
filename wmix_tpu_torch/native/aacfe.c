/*
 * Native AAC-LC front-end: ADTS parse, section/scalefactor decode,
 * spectral Huffman, pulse, dequant+scale, PNS/MS/IS, TNS -- everything
 * BEFORE the inverse filterbank, which runs batched on the device
 * (wmix_tpu_torch/codecs/aac_batch.py).
 *
 * A line-for-line port of the repo's own Python decoder
 * (wmix_tpu_torch/codecs/aac.py, itself a bit-exact re-derivation of the
 * reference's faad2 build, pkg/faad2-2.8.8 via aacType.c:125-255).
 * Float work is strict binary32: compile with -ffp-contract=off (no
 * FMA contraction) and no fast-math; constants come from
 * aacfe_tables.h, bit-pattern-identical to the Python tables.
 *
 * HE-AAC (SBR/PS fill-element payloads) returns AACFE_UNSUPPORTED so
 * the caller falls back to the Python front-end for the whole stream.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "aacfe_tables.h"

#define FRAME_LEN 1024
#define TNS_MAX_ORDER 20

#define ONLY_LONG_SEQUENCE 0
#define LONG_START_SEQUENCE 1
#define EIGHT_SHORT_SEQUENCE 2
#define LONG_STOP_SEQUENCE 3

#define ZERO_HCB 0
#define FIRST_PAIR_HCB 5
#define NOISE_HCB 13
#define INTENSITY_HCB2 14
#define INTENSITY_HCB 15

#define ID_SCE 0
#define ID_CPE 1
#define ID_CCE 2
#define ID_LFE 3
#define ID_DSE 4
#define ID_PCE 5
#define ID_FIL 6
#define ID_END 7

#define AACFE_OK 1
#define AACFE_EOS 0
#define AACFE_UNSUPPORTED 2

/* bit reader (bits.c semantics: MSB first; reads past the end of the
 * remaining stream buffer return zeros, as the Python Bits pads) */
typedef struct
{
    const uint8_t *data;
    int64_t nbytes; /* bytes available from data */
    int64_t pos;    /* bit position */
} Bits;

static uint32_t bits_show(Bits *b, int n)
{
    int64_t first = b->pos >> 3;
    int off = (int)(b->pos & 7);
    uint64_t chunk;
    if (n == 0)
        return 0;
    if (first + 8 <= b->nbytes)
    {
        memcpy(&chunk, b->data + first, 8);
        chunk = __builtin_bswap64(chunk);
    }
    else
    {
        int i;
        chunk = 0;
        for (i = 0; i < 8; i++)
        {
            uint8_t byte =
                first + i < b->nbytes ? b->data[first + i] : 0;
            chunk = (chunk << 8) | byte;
        }
    }
    return (uint32_t)((chunk << off) >> (64 - n));
}

static void bits_flush(Bits *b, int n) { b->pos += n; }

static uint32_t bits_get(Bits *b, int n)
{
    uint32_t v = bits_show(b, n);
    b->pos += n;
    return v;
}

static uint32_t bits_get1(Bits *b) { return bits_get(b, 1); }

static void bits_align(Bits *b)
{
    int r = (int)(b->pos & 7);
    if (r)
        b->pos += 8 - r;
}

/* ------------------------------------------------------------ ics data */

typedef struct
{
    int global_gain;
    int window_sequence, window_shape, max_sfb, scale_factor_grouping;
    int num_windows, num_window_groups;
    int window_group_length[8];
    int num_swb;
    int swb_offset[65]; /* [num_swb+1] */
    int swb_offset_max;
    int sect_sfb_offset[8][128];
    int sect_cb[8][120], sect_start[8][120], sect_end[8][120];
    int sfb_cb[8][64];
    int num_sec[8];
    int scale_factors[8][64];
    int ms_mask_present;
    int ms_used[8][64];
    int noise_used, is_used;
    int pulse_data_present, tns_data_present;
    /* pulse */
    int pulse_start_sfb, pulse_n;
    int pulse_offset[4], pulse_amp[4];
    /* tns */
    int tns_n_filt[8], tns_coef_res[8];
    int tns_length[8][4], tns_order[8][4];
    int tns_direction[8][4], tns_coef_compress[8][4];
    int tns_coef[8][4][32];
} ICS;

static int is_intensity(const ICS *ics, int g, int sfb)
{
    int cb = ics->sfb_cb[g][sfb];
    if (cb == INTENSITY_HCB)
        return 1;
    if (cb == INTENSITY_HCB2)
        return -1;
    return 0;
}

static int is_noise(const ICS *ics, int g, int sfb)
{
    return ics->sfb_cb[g][sfb] == NOISE_HCB;
}

/* returns 0 ok, -1 error */
static int window_grouping_info(ICS *ics, int sf_index)
{
    int i, g;
    if (ics->window_sequence == ONLY_LONG_SEQUENCE ||
        ics->window_sequence == LONG_START_SEQUENCE ||
        ics->window_sequence == LONG_STOP_SEQUENCE)
    {
        const int32_t *swb = &SWB_1024_TAB[sf_index * 64];
        ics->num_windows = 1;
        ics->num_window_groups = 1;
        memset(ics->window_group_length, 0,
               sizeof(ics->window_group_length));
        ics->window_group_length[0] = 1;
        ics->num_swb = NUM_SWB_1024_WINDOW[sf_index];
        if (ics->max_sfb > ics->num_swb)
            return -1;
        for (i = 0; i < ics->num_swb; i++)
            ics->swb_offset[i] = swb[i];
        ics->swb_offset[ics->num_swb] = FRAME_LEN;
        ics->swb_offset_max = FRAME_LEN;
        for (i = 0; i <= ics->num_swb; i++)
            ics->sect_sfb_offset[0][i] = ics->swb_offset[i];
    }
    else if (ics->window_sequence == EIGHT_SHORT_SEQUENCE)
    {
        const int32_t *swb = &SWB_128_TAB[sf_index * 64];
        ics->num_windows = 8;
        ics->num_window_groups = 1;
        memset(ics->window_group_length, 0,
               sizeof(ics->window_group_length));
        ics->window_group_length[0] = 1;
        ics->num_swb = NUM_SWB_128_WINDOW[sf_index];
        if (ics->max_sfb > ics->num_swb)
            return -1;
        for (i = 0; i < ics->num_swb; i++)
            ics->swb_offset[i] = swb[i];
        ics->swb_offset[ics->num_swb] = FRAME_LEN / 8;
        ics->swb_offset_max = FRAME_LEN / 8;
        for (i = 0; i < ics->num_windows - 1; i++)
        {
            if (!(ics->scale_factor_grouping & (1 << (6 - i))))
            {
                ics->num_window_groups += 1;
                ics->window_group_length[ics->num_window_groups - 1] = 1;
            }
            else
                ics->window_group_length[ics->num_window_groups - 1] += 1;
        }
        for (g = 0; g < ics->num_window_groups; g++)
        {
            int offset = 0;
            for (i = 0; i < ics->num_swb; i++)
            {
                int width;
                if (i + 1 == ics->num_swb)
                    width = FRAME_LEN / 8 - swb[i];
                else
                    width = swb[i + 1] - swb[i];
                width *= ics->window_group_length[g];
                ics->sect_sfb_offset[g][i] = offset;
                offset += width;
            }
            ics->sect_sfb_offset[g][ics->num_swb] = offset;
        }
    }
    else
        return -1;
    return 0;
}

static int ics_info(ICS *ics, Bits *ld, int sf_index)
{
    if (bits_get1(ld))
        return -1; /* ics_reserved_bit */
    ics->window_sequence = (int)bits_get(ld, 2);
    ics->window_shape = (int)bits_get1(ld);
    if (ics->window_sequence == EIGHT_SHORT_SEQUENCE)
    {
        ics->max_sfb = (int)bits_get(ld, 4);
        ics->scale_factor_grouping = (int)bits_get(ld, 7);
    }
    else
        ics->max_sfb = (int)bits_get(ld, 6);
    if (window_grouping_info(ics, sf_index) != 0)
        return -1;
    if (ics->max_sfb > ics->num_swb)
        return -1;
    if (ics->window_sequence != EIGHT_SHORT_SEQUENCE)
    {
        if (bits_get1(ld))
            return -1; /* prediction: not LC */
    }
    return 0;
}

static int section_data(ICS *ics, Bits *ld)
{
    int sect_bits =
        ics->window_sequence == EIGHT_SHORT_SEQUENCE ? 3 : 5;
    int sect_esc_val = (1 << sect_bits) - 1;
    int g, sfb;
    for (g = 0; g < ics->num_window_groups; g++)
    {
        int k = 0, i = 0;
        while (k < ics->max_sfb)
        {
            int sect_len = 0, sect_len_incr;
            if (i >= 120)
                return -1;
            ics->sect_cb[g][i] = (int)bits_get(ld, 4);
            if (ics->sect_cb[g][i] == 12)
                return -1;
            if (ics->sect_cb[g][i] == NOISE_HCB)
                ics->noise_used = 1;
            if (ics->sect_cb[g][i] == INTENSITY_HCB ||
                ics->sect_cb[g][i] == INTENSITY_HCB2)
                ics->is_used = 1;
            sect_len_incr = (int)bits_get(ld, sect_bits);
            while (sect_len_incr == sect_esc_val)
            {
                sect_len += sect_len_incr;
                sect_len_incr = (int)bits_get(ld, sect_bits);
            }
            sect_len += sect_len_incr;
            ics->sect_start[g][i] = k;
            ics->sect_end[g][i] = k + sect_len;
            if (k + sect_len > 8 * 15 &&
                ics->window_sequence == EIGHT_SHORT_SEQUENCE)
                return -1;
            if (k + sect_len > 64)
                return -1;
            for (sfb = k; sfb < k + sect_len; sfb++)
                ics->sfb_cb[g][sfb] = ics->sect_cb[g][i];
            k += sect_len;
            i++;
        }
        ics->num_sec[g] = i;
        if (k != ics->max_sfb)
            return -1;
    }
    return 0;
}

static int huffman_scale_factor(Bits *ld)
{
    int offset = 0;
    while (HCB_SF[offset * 2 + 1])
    {
        int b = (int)bits_get1(ld);
        offset += HCB_SF[offset * 2 + b];
        if (offset > 240)
            return -1000;
    }
    return HCB_SF[offset * 2 + 0];
}

static int decode_scale_factors(ICS *ics, Bits *ld)
{
    int scale_factor = ics->global_gain;
    int is_position = 0;
    int noise_energy = ics->global_gain - 90;
    int noise_pcm_flag = 1;
    int g, sfb;
    for (g = 0; g < ics->num_window_groups; g++)
        for (sfb = 0; sfb < ics->max_sfb; sfb++)
        {
            int cb = ics->sfb_cb[g][sfb];
            if (cb == ZERO_HCB)
                ics->scale_factors[g][sfb] = 0;
            else if (cb == INTENSITY_HCB || cb == INTENSITY_HCB2)
            {
                int t = huffman_scale_factor(ld);
                if (t == -1000)
                    return -1;
                is_position += t - 60;
                ics->scale_factors[g][sfb] = is_position;
            }
            else if (cb == NOISE_HCB)
            {
                int t;
                if (noise_pcm_flag)
                {
                    noise_pcm_flag = 0;
                    t = (int)bits_get(ld, 9) - 256;
                }
                else
                {
                    t = huffman_scale_factor(ld);
                    if (t == -1000)
                        return -1;
                    t -= 60;
                }
                noise_energy += t;
                ics->scale_factors[g][sfb] = noise_energy;
            }
            else
            {
                int t = huffman_scale_factor(ld);
                if (t == -1000)
                    return -1;
                scale_factor += t - 60;
                if (scale_factor < 0 || scale_factor > 255)
                    return -1;
                ics->scale_factors[g][sfb] = scale_factor;
            }
        }
    return 0;
}

static void tns_data(ICS *ics, Bits *ld)
{
    int n_filt_bits, length_bits, order_bits, w, f, i;
    if (ics->window_sequence == EIGHT_SHORT_SEQUENCE)
    {
        n_filt_bits = 1;
        length_bits = 4;
        order_bits = 3;
    }
    else
    {
        n_filt_bits = 2;
        length_bits = 6;
        order_bits = 5;
    }
    for (w = 0; w < ics->num_windows; w++)
    {
        int start_coef_bits = 3;
        ics->tns_n_filt[w] = (int)bits_get(ld, n_filt_bits);
        if (ics->tns_n_filt[w])
        {
            ics->tns_coef_res[w] = (int)bits_get1(ld);
            start_coef_bits = ics->tns_coef_res[w] ? 4 : 3;
        }
        for (f = 0; f < ics->tns_n_filt[w] && f < 4; f++)
        {
            ics->tns_length[w][f] = (int)bits_get(ld, length_bits);
            ics->tns_order[w][f] = (int)bits_get(ld, order_bits);
            if (ics->tns_order[w][f])
            {
                int coef_bits;
                ics->tns_direction[w][f] = (int)bits_get1(ld);
                ics->tns_coef_compress[w][f] = (int)bits_get1(ld);
                coef_bits = start_coef_bits -
                            ics->tns_coef_compress[w][f];
                for (i = 0; i < ics->tns_order[w][f] && i < 32; i++)
                    ics->tns_coef[w][f][i] =
                        (int)bits_get(ld, coef_bits);
            }
        }
    }
}

static int pulse_data_read(ICS *ics, Bits *ld)
{
    int i;
    ics->pulse_n = (int)bits_get(ld, 2);
    ics->pulse_start_sfb = (int)bits_get(ld, 6);
    if (ics->pulse_start_sfb > ics->num_swb)
        return -1;
    for (i = 0; i < ics->pulse_n + 1; i++)
    {
        ics->pulse_offset[i] = (int)bits_get(ld, 5);
        ics->pulse_amp[i] = (int)bits_get(ld, 4);
    }
    return 0;
}

/* ------------------------------------------------------------- huffman */

static int getescape(Bits *ld, int sp)
{
    int neg, i, off, j;
    if (sp < 0)
    {
        if (sp != -16)
            return sp;
        neg = 1;
    }
    else
    {
        if (sp != 16)
            return sp;
        neg = 0;
    }
    i = 4;
    while (bits_get1(ld))
        i++;
    off = (int)bits_get(ld, i);
    j = off | (1 << i);
    return neg ? -j : j;
}

/* returns number of values (2 or 4) into sp, or -1 on error */
static int huffman_spectral(int cb, Bits *ld, int *sp)
{
    int kind = HCB_KIND[cb];
    int w = HCB_WIDTH[cb];
    int i;
    if (kind == 1 || kind == 2)
    { /* 2-step */
        int nbits = HCB_NBITS[cb];
        uint32_t cw = bits_show(ld, nbits);
        const int16_t *first =
            &HCB_FIRST_FLAT[HCB_FIRST_OFF[cb] * 2];
        const int16_t *sec = &HCB_SEC_FLAT[HCB_SEC_OFF[cb]];
        int offset = first[cw * 2 + 0];
        int extra = first[cw * 2 + 1];
        if (extra)
        {
            bits_flush(ld, nbits);
            offset += (int)bits_show(ld, extra);
            bits_flush(ld, sec[offset * 5 + 0] - nbits);
        }
        else
            bits_flush(ld, sec[offset * 5 + 0]);
        for (i = 0; i < w; i++)
            sp[i] = sec[offset * 5 + 1 + i];
        /* sign bits for books 2? no: 1,2 unsigned; 4 signed; 6 unsigned
         * -- handled by caller table below */
    }
    else if (kind == 3 || kind == 4)
    { /* binary tree */
        const int16_t *tab = &HCB_SEC_FLAT[HCB_SEC_OFF[cb]];
        int offset = 0;
        while (!tab[offset * 5 + 0])
        {
            int b = (int)bits_get1(ld);
            offset += tab[offset * 5 + 1 + b];
        }
        if (kind == 3)
            for (i = 0; i < 4; i++)
                sp[i] = tab[offset * 5 + 1 + i];
        else
            for (i = 0; i < 2; i++)
                sp[i] = tab[offset * 5 + 1 + i];
    }
    else
        return -1;

    /* sign + escape handling per book (aac.py huffman_spectral_data) */
    switch (cb)
    {
    case 1:
    case 2:
    case 6:
        break; /* signed tables, no sign bits */
    case 3:
    case 4:
        for (i = 0; i < 4; i++)
            if (sp[i] && bits_get1(ld))
                sp[i] = -sp[i];
        break;
    case 5:
        break; /* signed binary pair */
    case 7:
    case 9:
    case 8:
    case 10:
        for (i = 0; i < 2; i++)
            if (sp[i] && bits_get1(ld))
                sp[i] = -sp[i];
        break;
    case 11:
        for (i = 0; i < 2; i++)
            if (sp[i] && bits_get1(ld))
                sp[i] = -sp[i];
        sp[0] = getescape(ld, sp[0]);
        sp[1] = getescape(ld, sp[1]);
        break;
    default:
        return -1;
    }
    return w;
}

static int spectral_data(ICS *ics, Bits *ld, int32_t *spec)
{
    int nshort = FRAME_LEN / 8;
    int groups = 0;
    int g, i;
    memset(spec, 0, FRAME_LEN * sizeof(int32_t));
    for (g = 0; g < ics->num_window_groups; g++)
    {
        int p = groups * nshort;
        for (i = 0; i < ics->num_sec[g]; i++)
        {
            int sect_cb = ics->sect_cb[g][i];
            int inc = sect_cb >= FIRST_PAIR_HCB ? 2 : 4;
            if (sect_cb == ZERO_HCB || sect_cb == NOISE_HCB ||
                sect_cb == INTENSITY_HCB || sect_cb == INTENSITY_HCB2)
            {
                p += ics->sect_sfb_offset[g][ics->sect_end[g][i]] -
                     ics->sect_sfb_offset[g][ics->sect_start[g][i]];
            }
            else
            {
                int k = ics->sect_sfb_offset[g][ics->sect_start[g][i]];
                int end = ics->sect_sfb_offset[g][ics->sect_end[g][i]];
                while (k < end)
                {
                    int vals[4];
                    int n = huffman_spectral(sect_cb, ld, vals);
                    int j;
                    if (n < 0 || p + n > FRAME_LEN)
                        return -1;
                    for (j = 0; j < n; j++)
                        spec[p + j] = vals[j];
                    p += n;
                    k += n;
                }
            }
        }
        groups += ics->window_group_length[g];
    }
    return 0;
}

static int pulse_decode(ICS *ics, int32_t *spec)
{
    int k = ics->swb_offset[ics->pulse_start_sfb];
    int i;
    for (i = 0; i < ics->pulse_n + 1; i++)
    {
        k += ics->pulse_offset[i];
        if (k >= FRAME_LEN)
            return -1;
        if (spec[k] > 0)
            spec[k] += ics->pulse_amp[i];
        else
            spec[k] -= ics->pulse_amp[i];
    }
    return 0;
}

/* ------------------------------------------------- dequant + scaling */

static int quant_to_spec(ICS *ics, const int32_t *quant, float *spec)
{
    int k = 0, gindex = 0, g, sfb, win;
    memset(spec, 0, FRAME_LEN * sizeof(float));
    for (g = 0; g < ics->num_window_groups; g++)
    {
        int j = 0, gincrease = 0;
        int win_inc = ics->swb_offset[ics->num_swb];
        for (sfb = 0; sfb < ics->num_swb; sfb++)
        {
            int width = ics->swb_offset[sfb + 1] - ics->swb_offset[sfb];
            int sf = sfb < ics->max_sfb ? ics->scale_factors[g][sfb] : 0;
            int exp, frac;
            float scf;
            int wa = gindex + j;
            if (sf < 0 || sf > 255)
            {
                exp = 0;
                frac = 0;
            }
            else
            {
                exp = sf >> 2;
                frac = sf & 3;
            }
            scf = POW2SF_TAB.f[exp] * POW2_TABLE.f[frac];
            for (win = 0; win < ics->window_group_length[g]; win++)
            {
                int wb = wa, i;
                for (i = 0; i < width; i++)
                {
                    int32_t q = quant[k + i];
                    int32_t aq = q < 0 ? -q : q;
                    float iq;
                    if (aq >= 8192)
                        return -1;
                    iq = q < 0 ? -IQ_TABLE.f[aq] : IQ_TABLE.f[aq];
                    spec[wb + i] = iq * scf;
                }
                gincrease += width;
                k += width;
                wa += win_inc;
            }
            j += width;
        }
        gindex += gincrease;
    }
    return 0;
}

/* ------------------------------------------------------ PNS / MS / IS */

static int parity32(uint32_t x)
{
    x ^= x >> 16;
    x ^= x >> 8;
    x ^= x >> 4;
    x ^= x >> 2;
    x ^= x >> 1;
    return (int)(x & 1);
}

static uint32_t ne_rng(uint32_t *state)
{
    uint32_t r1 = state[0], r2 = state[1];
    uint32_t t1 = r1 & 0xF5;
    uint32_t t2 = (r2 >> 25) & 0x63;
    t1 = (uint32_t)parity32(t1) << 31;
    t2 = (uint32_t)parity32(t2);
    state[0] = (r1 >> 1) | t1;
    state[1] = (r2 + r2) | t2;
    return state[0] ^ state[1];
}

static void gen_rand_vector(int sf, int size, uint32_t *rng, float *out)
{
    float scale = 1.0f / (float)size;
    float energy = 0.0f;
    int i;
    for (i = 0; i < size; i++)
    {
        uint32_t r = ne_rng(rng);
        int32_t ri = (int32_t)r;
        float tmp = scale * (float)ri;
        out[i] = tmp;
        energy = energy + tmp * tmp;
    }
    scale = 1.0f / (float)sqrt((double)energy);
    scale = scale * (float)pow(2.0, 0.25 * (double)sf);
    for (i = 0; i < size; i++)
        out[i] = out[i] * scale;
}

static void pns_decode(ICS *ics_l, ICS *ics_r, float *spec_l,
                       float *spec_r, int channel_pair, uint32_t *rng)
{
    int nshort = FRAME_LEN >> 3;
    int group = 0, g, b, sfb;
    uint32_t rng_dep[2] = {0, 0};
    for (g = 0; g < ics_l->num_window_groups; g++)
        for (b = 0; b < ics_l->window_group_length[g]; b++)
        {
            for (sfb = 0; sfb < ics_l->max_sfb; sfb++)
            {
                if (is_noise(ics_l, g, sfb))
                {
                    int offs = ics_l->swb_offset[sfb];
                    int hi = ics_l->swb_offset[sfb + 1];
                    int size, base;
                    if (hi > ics_l->swb_offset_max)
                        hi = ics_l->swb_offset_max;
                    size = hi - offs;
                    if (channel_pair && ics_r != NULL &&
                        is_noise(ics_r, g, sfb) &&
                        (((ics_l->ms_mask_present == 1) &&
                          ics_l->ms_used[g][sfb]) ||
                         (ics_l->ms_mask_present == 2)))
                    {
                        rng_dep[0] = rng[0];
                        rng_dep[1] = rng[1];
                    }
                    base = group * nshort + offs;
                    if (size > 0)
                        gen_rand_vector(ics_l->scale_factors[g][sfb],
                                        size, rng, &spec_l[base]);
                }
                if (ics_r != NULL && is_noise(ics_r, g, sfb))
                {
                    int offs = ics_r->swb_offset[sfb];
                    int hi = ics_r->swb_offset[sfb + 1];
                    int size, base;
                    if (hi > ics_r->swb_offset_max)
                        hi = ics_r->swb_offset_max;
                    size = hi - offs;
                    base = group * nshort + offs;
                    if (size <= 0)
                        continue;
                    if (channel_pair &&
                        (((ics_l->ms_mask_present == 1) &&
                          ics_l->ms_used[g][sfb]) ||
                         (ics_l->ms_mask_present == 2)))
                        gen_rand_vector(ics_r->scale_factors[g][sfb],
                                        size, rng_dep, &spec_r[base]);
                    else
                        gen_rand_vector(ics_r->scale_factors[g][sfb],
                                        size, rng, &spec_r[base]);
                }
            }
            group++;
        }
}

static void ms_decode(ICS *ics, ICS *icsr, float *l_spec, float *r_spec)
{
    int nshort = FRAME_LEN / 8;
    int group = 0, g, b, sfb, i;
    if (ics->ms_mask_present < 1)
        return;
    for (g = 0; g < ics->num_window_groups; g++)
        for (b = 0; b < ics->window_group_length[g]; b++)
        {
            for (sfb = 0; sfb < ics->max_sfb; sfb++)
            {
                if ((ics->ms_used[g][sfb] || ics->ms_mask_present == 2) &&
                    !is_intensity(icsr, g, sfb) && !is_noise(ics, g, sfb))
                {
                    int lo = ics->swb_offset[sfb];
                    int hi = ics->swb_offset[sfb + 1];
                    int k = group * nshort;
                    if (hi > ics->swb_offset_max)
                        hi = ics->swb_offset_max;
                    for (i = lo; i < hi; i++)
                    {
                        float tmp = l_spec[k + i] - r_spec[k + i];
                        l_spec[k + i] = l_spec[k + i] + r_spec[k + i];
                        r_spec[k + i] = tmp;
                    }
                }
            }
            group++;
        }
}

static void is_decode(ICS *ics, ICS *icsr, float *l_spec, float *r_spec)
{
    int nshort = FRAME_LEN / 8;
    int group = 0, g, b, sfb, i;
    for (g = 0; g < icsr->num_window_groups; g++)
        for (b = 0; b < icsr->window_group_length[g]; b++)
        {
            for (sfb = 0; sfb < icsr->max_sfb; sfb++)
            {
                if (is_intensity(icsr, g, sfb))
                {
                    float scale = (float)pow(
                        0.5, 0.25 * (double)icsr->scale_factors[g][sfb]);
                    int lo = icsr->swb_offset[sfb];
                    int hi = icsr->swb_offset[sfb + 1];
                    int k = group * nshort;
                    int inv;
                    if (hi > ics->swb_offset_max)
                        hi = ics->swb_offset_max;
                    if (ics->ms_mask_present == 1 && ics->ms_used[g][sfb])
                        inv = -1;
                    else
                        inv = 1;
                    for (i = lo; i < hi; i++)
                    {
                        float seg = l_spec[k + i] * scale;
                        if (is_intensity(icsr, g, sfb) != inv)
                            seg = -seg;
                        r_spec[k + i] = seg;
                    }
                }
            }
            group++;
        }
}

/* ----------------------------------------------------------------- TNS */

static void tns_decode_coef(int order, int coef_res_bits,
                            int coef_compress, const int *coef, float *a)
{
    const float *tab;
    float tmp2[TNS_MAX_ORDER];
    float b[TNS_MAX_ORDER + 1];
    int i, m;
    if (coef_compress == 0)
        tab = coef_res_bits == 3 ? TNS_COEF_0_3.f : TNS_COEF_0_4.f;
    else
        tab = coef_res_bits == 3 ? TNS_COEF_1_3.f : TNS_COEF_1_4.f;
    for (i = 0; i < order; i++)
        tmp2[i] = tab[coef[i]];
    memset(a, 0, (TNS_MAX_ORDER + 1) * sizeof(float));
    a[0] = 1.0f;
    for (m = 1; m <= order; m++)
    {
        memset(b, 0, sizeof(b));
        for (i = 1; i < m; i++)
            b[i] = a[i] + tmp2[m - 1] * a[m - i];
        for (i = 1; i < m; i++)
            a[i] = b[i];
        a[m] = tmp2[m - 1];
    }
}

static void tns_ar_filter(float *spec, int start, int size, int inc,
                          const float *lpc, int order)
{
    float state[2 * TNS_MAX_ORDER];
    int state_index = 0;
    int pos = start;
    int n, j;
    memset(state, 0, sizeof(state));
    for (n = 0; n < size; n++)
    {
        float y = spec[pos];
        for (j = 0; j < order; j++)
            y = y - state[state_index + j] * lpc[j + 1];
        state_index -= 1;
        if (state_index < 0)
            state_index = order - 1;
        state[state_index] = y;
        state[state_index + order] = y;
        spec[pos] = y;
        pos += inc;
    }
}

static void tns_decode_frame(ICS *ics, int sf_index, float *spec)
{
    int nshort = FRAME_LEN / 8;
    int is_short = ics->window_sequence == EIGHT_SHORT_SEQUENCE;
    int sbf_max = TNS_SBF_MAX_TAB[sf_index * 2 + (is_short ? 1 : 0)];
    int w, f;
    if (!ics->tns_data_present)
        return;
    for (w = 0; w < ics->num_windows; w++)
    {
        int bottom = ics->num_swb;
        for (f = 0; f < ics->tns_n_filt[w]; f++)
        {
            float lpc[TNS_MAX_ORDER + 1];
            int top = bottom;
            int tns_order, start, end, size, inc;
            bottom = top - ics->tns_length[w][f];
            if (bottom < 0)
                bottom = 0;
            tns_order = ics->tns_order[w][f];
            if (tns_order > TNS_MAX_ORDER)
                tns_order = TNS_MAX_ORDER;
            if (!tns_order)
                continue;
            tns_decode_coef(tns_order, ics->tns_coef_res[w] + 3,
                            ics->tns_coef_compress[w][f],
                            ics->tns_coef[w][f], lpc);
            start = bottom < sbf_max ? bottom : sbf_max;
            if (start > ics->max_sfb)
                start = ics->max_sfb;
            start = ics->swb_offset[start];
            if (start > ics->swb_offset_max)
                start = ics->swb_offset_max;
            end = top < sbf_max ? top : sbf_max;
            if (end > ics->max_sfb)
                end = ics->max_sfb;
            end = ics->swb_offset[end];
            if (end > ics->swb_offset_max)
                end = ics->swb_offset_max;
            size = end - start;
            if (size <= 0)
                continue;
            if (ics->tns_direction[w][f])
            {
                inc = -1;
                start = end - 1;
            }
            else
                inc = 1;
            tns_ar_filter(spec, w * nshort + start, size, inc, lpc,
                          tns_order);
        }
    }
}

/* ------------------------------------------------------- frame decode */

typedef struct AacFE
{
    const uint8_t *data;
    int64_t end;
    int64_t pos;
    int sf_index;  /* -1 until first header */
    int channels;
    uint32_t rng[2];
    int64_t frame;
} AacFE;

AacFE *aacfe_new(const uint8_t *data, int64_t len)
{
    AacFE *fe = (AacFE *)calloc(1, sizeof(AacFE));
    if (!fe)
        return NULL;
    fe->data = data;
    fe->end = len;
    fe->sf_index = -1;
    fe->rng[0] = 1;
    fe->rng[1] = 1;
    return fe;
}

void aacfe_free(AacFE *fe) { free(fe); }

static int individual_channel_stream(AacFE *fe, Bits *ld, ICS *ics,
                                     int common_window, int32_t *quant)
{
    ics->global_gain = (int)bits_get(ld, 8);
    if (!common_window)
    {
        if (ics_info(ics, ld, fe->sf_index) != 0)
            return -1;
    }
    if (section_data(ics, ld) != 0)
        return -1;
    if (decode_scale_factors(ics, ld) != 0)
        return -1;
    ics->pulse_data_present = (int)bits_get1(ld);
    if (ics->pulse_data_present)
    {
        if (ics->window_sequence == EIGHT_SHORT_SEQUENCE)
            return -1;
        if (pulse_data_read(ics, ld) != 0)
            return -1;
    }
    ics->tns_data_present = (int)bits_get1(ld);
    if (ics->tns_data_present)
        tns_data(ics, ld);
    if (bits_get1(ld))
        return -1; /* gain control (SSR) */
    if (spectral_data(ics, ld, quant) != 0)
        return -1;
    if (ics->pulse_data_present)
    {
        if (pulse_decode(ics, quant) != 0)
            return -1;
    }
    return 0;
}

/* fill element: returns 0 skipped, -2 SBR present (unsupported) */
static int fill_element(Bits *ld)
{
    int count = (int)bits_get(ld, 4);
    int i;
    if (count == 15)
        count += (int)bits_get(ld, 8) - 1;
    if (count > 0)
    {
        uint32_t ext = bits_show(ld, 4);
        if (ext == 13 || ext == 14)
            return -2; /* EXT_SBR_DATA(_CRC): HE-AAC */
    }
    for (i = 0; i < count; i++)
        bits_get(ld, 8);
    return 0;
}

static void data_stream_element(Bits *ld)
{
    int byte_aligned, count, i;
    bits_get(ld, 4);
    byte_aligned = (int)bits_get1(ld);
    count = (int)bits_get(ld, 8);
    if (count == 255)
        count += (int)bits_get(ld, 8);
    if (byte_aligned)
        bits_align(ld);
    for (i = 0; i < count; i++)
        bits_get(ld, 8);
}

static void program_config_element(Bits *ld)
{
    int num_front, num_side, num_back, num_lfe, num_assoc, num_cc, i, n;
    bits_get(ld, 4);
    bits_get(ld, 2);
    bits_get(ld, 4);
    num_front = (int)bits_get(ld, 4);
    num_side = (int)bits_get(ld, 4);
    num_back = (int)bits_get(ld, 4);
    num_lfe = (int)bits_get(ld, 2);
    num_assoc = (int)bits_get(ld, 3);
    num_cc = (int)bits_get(ld, 4);
    if (bits_get1(ld))
        bits_get(ld, 4);
    if (bits_get1(ld))
        bits_get(ld, 4);
    if (bits_get1(ld))
        bits_get(ld, 3);
    for (i = 0; i < num_front + num_side + num_back; i++)
        bits_get(ld, 1 + 4);
    for (i = 0; i < num_lfe + num_assoc; i++)
        bits_get(ld, 4);
    for (i = 0; i < num_cc; i++)
        bits_get(ld, 1 + 4);
    bits_align(ld);
    n = (int)bits_get(ld, 8);
    for (i = 0; i < n; i++)
        bits_get(ld, 8);
}

/*
 * Decode the next ADTS frame (scanning to sync like aacType.c's
 * aac_decode loop).  Outputs:
 *   spec    float[2 * 1024]   one row per channel job
 *   jobmeta int32[2 * 3]      (ch, window_sequence, window_shape)/job
 *   info    int32[6]          {n_jobs, nch_out, freq, consumed, emit,
 *                              frame_index}
 * Returns AACFE_OK, AACFE_EOS, or AACFE_UNSUPPORTED (HE-AAC/profile;
 * stream position NOT advanced so the Python fallback can retake it).
 */
int aacfe_frame(AacFE *fe, float *spec, int32_t *jobmeta, int32_t *info)
{
    /* scan for ADTS sync (aacType.c:138-158) */
    int64_t p = fe->pos;
    int frame_len = 0;
    Bits ld;
    int sf_index, channel_config, profile, protection_absent;
    int ch_base = 0, n_jobs = 0;
    ICS ics1, ics2;
    int32_t quant1[FRAME_LEN], quant2[FRAME_LEN];
    static const int SBR_UNSUP = AACFE_UNSUPPORTED;

    while (p < fe->end - 7)
    {
        if (fe->data[p] == 0xFF && (fe->data[p + 1] & 0xF0) == 0xF0)
        {
            frame_len = ((fe->data[p + 3] & 0x3) << 11) |
                        (fe->data[p + 4] << 3) | (fe->data[p + 5] >> 5);
            break;
        }
        p++;
    }
    if (p >= fe->end - 7 || frame_len == 0)
        return AACFE_EOS;
    if (fe->end - p < frame_len)
        return AACFE_EOS;

    /* the Python driver hands decode() the whole remaining buffer, so
     * bit reads may legally cross the ADTS frame boundary; zeros begin
     * only at the true end of the stream buffer */
    ld.data = fe->data + p;
    ld.nbytes = fe->end - p;
    ld.pos = 0;

    /* adts header */
    if (bits_get(&ld, 12) != 0xFFF)
        return AACFE_EOS;
    bits_get1(&ld);                       /* id */
    bits_get(&ld, 2);                     /* layer */
    protection_absent = (int)bits_get1(&ld);
    profile = (int)bits_get(&ld, 2);
    sf_index = (int)bits_get(&ld, 4);
    bits_get1(&ld);                       /* private */
    channel_config = (int)bits_get(&ld, 3);
    bits_get(&ld, 1 + 1 + 1 + 1);
    bits_get(&ld, 13);                    /* frame_length */
    bits_get(&ld, 11);                    /* buffer fullness */
    bits_get(&ld, 2);                     /* raw data blocks */
    if (!protection_absent)
        bits_get(&ld, 16);
    if (profile != 0 && profile != 1)
        return SBR_UNSUP;
    if (fe->sf_index < 0)
    {
        fe->sf_index = sf_index;
        fe->channels = channel_config;
    }
    /* implicit SBR upsampling (<= 24 kHz) needs the SBR QMF machinery:
     * Python front-end handles those streams */
    if (SAMPLE_RATES_TAB[fe->sf_index] <= 24000)
        return SBR_UNSUP;

    memset(&ics1, 0, sizeof(ics1));
    memset(&ics2, 0, sizeof(ics2));

    for (;;)
    {
        int el = (int)bits_get(&ld, 3);
        if (el == ID_END)
            break;
        if (el == ID_SCE)
        {
            float *sp = &spec[n_jobs * FRAME_LEN];
            memset(&ics1, 0, sizeof(ics1));
            bits_get(&ld, 4); /* tag */
            if (individual_channel_stream(fe, &ld, &ics1, 0, quant1) != 0)
                return SBR_UNSUP;
            if (bits_show(&ld, 3) == ID_FIL)
            {
                bits_flush(&ld, 3);
                if (fill_element(&ld) == -2)
                    return SBR_UNSUP;
            }
            if (n_jobs >= 2)
                return SBR_UNSUP; /* >2 output channels */
            if (quant_to_spec(&ics1, quant1, sp) != 0)
                return SBR_UNSUP;
            if (ics1.noise_used)
                pns_decode(&ics1, NULL, sp, NULL, 0, fe->rng);
            tns_decode_frame(&ics1, fe->sf_index, sp);
            jobmeta[n_jobs * 3 + 0] = ch_base;
            jobmeta[n_jobs * 3 + 1] = ics1.window_sequence;
            jobmeta[n_jobs * 3 + 2] = ics1.window_shape;
            n_jobs++;
            ch_base += 1;
        }
        else if (el == ID_CPE)
        {
            float *sp1, *sp2;
            int common_window;
            if (n_jobs + 2 > 2)
                return SBR_UNSUP;
            sp1 = &spec[n_jobs * FRAME_LEN];
            sp2 = &spec[(n_jobs + 1) * FRAME_LEN];
            memset(&ics1, 0, sizeof(ics1));
            memset(&ics2, 0, sizeof(ics2));
            bits_get(&ld, 4); /* tag */
            common_window = (int)bits_get1(&ld);
            if (common_window)
            {
                int g, sfb;
                if (ics_info(&ics1, &ld, fe->sf_index) != 0)
                    return SBR_UNSUP;
                ics1.ms_mask_present = (int)bits_get(&ld, 2);
                if (ics1.ms_mask_present == 3)
                    return SBR_UNSUP;
                if (ics1.ms_mask_present == 1)
                    for (g = 0; g < ics1.num_window_groups; g++)
                        for (sfb = 0; sfb < ics1.max_sfb; sfb++)
                            ics1.ms_used[g][sfb] = (int)bits_get1(&ld);
                ics2 = ics1; /* struct copy = the C memcpy */
            }
            else
                ics1.ms_mask_present = 0;
            if (individual_channel_stream(fe, &ld, &ics1, common_window,
                                          quant1) != 0)
                return SBR_UNSUP;
            if (individual_channel_stream(fe, &ld, &ics2, common_window,
                                          quant2) != 0)
                return SBR_UNSUP;
            if (quant_to_spec(&ics1, quant1, sp1) != 0)
                return SBR_UNSUP;
            if (quant_to_spec(&ics2, quant2, sp2) != 0)
                return SBR_UNSUP;
            pns_decode(&ics1, &ics2, sp1, sp2,
                       ics1.ms_mask_present != 0, fe->rng);
            ms_decode(&ics1, &ics2, sp1, sp2);
            is_decode(&ics1, &ics2, sp1, sp2);
            if (bits_show(&ld, 3) == ID_FIL)
            {
                bits_flush(&ld, 3);
                if (fill_element(&ld) == -2)
                    return SBR_UNSUP;
            }
            tns_decode_frame(&ics1, fe->sf_index, sp1);
            tns_decode_frame(&ics2, fe->sf_index, sp2);
            jobmeta[n_jobs * 3 + 0] = ch_base;
            jobmeta[n_jobs * 3 + 1] = ics1.window_sequence;
            jobmeta[n_jobs * 3 + 2] = ics1.window_shape;
            jobmeta[(n_jobs + 1) * 3 + 0] = ch_base + 1;
            jobmeta[(n_jobs + 1) * 3 + 1] = ics2.window_sequence;
            jobmeta[(n_jobs + 1) * 3 + 2] = ics2.window_shape;
            n_jobs += 2;
            ch_base += 2;
        }
        else if (el == ID_FIL)
        {
            if (fill_element(&ld) == -2)
                return SBR_UNSUP;
        }
        else if (el == ID_DSE)
            data_stream_element(&ld);
        else if (el == ID_PCE)
            program_config_element(&ld);
        else
            return SBR_UNSUP;
        if (ld.pos > (int64_t)frame_len * 8 + 64)
            return SBR_UNSUP; /* ran off the frame: corrupt */
    }
    bits_align(&ld);

    fe->frame++;
    /* advance by consumed bytes, exactly like the Python driver's
     * buf[consumed:] (the next-frame scan re-syncs over any padding) */
    fe->pos = p + (ld.pos + 7) / 8;

    info[0] = n_jobs;
    info[1] = ch_base == 1 ? 2 : ch_base; /* mono upmatrix duplicates */
    info[2] = SAMPLE_RATES_TAB[fe->sf_index];
    info[3] = (int32_t)((ld.pos + 7) / 8);
    info[4] = fe->frame > 1 ? 1 : 0; /* faad first-frame suppression */
    info[5] = (int32_t)fe->frame;
    return AACFE_OK;
}
