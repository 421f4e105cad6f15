/*
 * Native pattern generators for the reference's float32 "div-step" pacing.
 *
 * The C reference paces resampling with a float32 accumulator
 * (src/wmix.c:49-222 and :1703-1940); the skip/insert
 * pattern depends on float32 rounding of the running sum, so it must be
 * simulated sequentially.  Doing that at native speed keeps pattern
 * generation out of the Python hot path; the resulting index arrays are
 * consumed by vectorized numpy/JAX gathers.
 *
 * All accumulator arithmetic is plain C `float` — IEEE binary32, identical
 * to the reference build (no -ffast-math).
 */
#include <stdint.h>

/* wmix_pcm_zoom upsample (src/wmix.c:160-189): one output slot per loop
 * iteration while the input cursor < in_frames; the cursor advances when
 * the accumulator trips.  Writes the source frame index per output slot.
 * Returns the number of output slots (<= cap). */
int64_t zoom_up_indices(int32_t in_freq, int32_t out_freq,
                        int64_t in_frames, int64_t *idx, int64_t cap)
{
    float div = (float)in_freq / out_freq;
    float d = 0.0f;
    int64_t i = 0, t = 0;
    while (i < in_frames && t < cap)
    {
        idx[t++] = i;
        d += div;
        if ((int)d > 0)
        {
            i++;
            d -= 1.0f;
        }
    }
    return t;
}

/* wmix_pcm_zoom upsample advance flags for a fixed number of slots
 * (used by the wmix_len_of_* arithmetic, src/wmix.c:61-73,106-118). */
void zoom_up_flags(int32_t in_freq, int32_t out_freq,
                   int64_t n_slots, uint8_t *adv)
{
    float div = (float)in_freq / out_freq;
    float d = 0.0f;
    int64_t t;
    for (t = 0; t < n_slots; t++)
    {
        d += div;
        if ((int)d > 0)
        {
            adv[t] = 1;
            d -= 1.0f;
        }
        else
            adv[t] = 0;
    }
}

/* wmix_pcm_zoom downsample (src/wmix.c:191-220): per input frame, emit
 * when the accumulator trips. */
void zoom_down_flags(int32_t in_freq, int32_t out_freq,
                     int64_t n_frames, uint8_t *emit)
{
    float div = (float)out_freq / in_freq;
    float d = 0.0f;
    int64_t t;
    for (t = 0; t < n_frames; t++)
    {
        d += div;
        if ((int)d > 0)
        {
            emit[t] = 1;
            d -= 1.0f;
        }
        else
            emit[t] = 0;
    }
}

/* wmix_load_data insert direction (stream slower than engine,
 * src/wmix.c:1799-1939).  One event per engine output frame:
 *   kind 0 = copy of source frame si[t] (cursor advances after)
 *   kind 1 = repair interpolation between si[t]-1 and si[t], with step
 *            index k[t] out of divisor dc2[t]
 * The loop ends right after the src_frames-th copy (count only advances
 * on copies).  Returns the event count (<= cap). */
int64_t load_insert_events(int32_t stream_freq, int32_t engine_freq,
                           int64_t src_frames, int8_t *kind, int64_t *si,
                           int32_t *k, int32_t *dc2, int64_t cap)
{
    float div_pow = (float)(engine_freq - stream_freq) / stream_freq;
    float d = 0.0f;
    int64_t i = 0, t = 0;
    int32_t kk = 0, d2 = 1;
    while (i < src_frames && t < cap)
    {
        if (d >= 1.0f)
        {
            kind[t] = 1;
            si[t] = i;
            k[t] = kk;
            dc2[t] = d2;
            t++;
            d -= 1.0f;
            kk++;
        }
        else
        {
            kind[t] = 0;
            si[t] = i;
            k[t] = 0;
            dc2[t] = 0;
            t++;
            i++;
            d += div_pow;
            if (d >= 1.0f)
            {
                d2 = (int)d + 1;
                kk = 0;
            }
        }
    }
    return t;
}

/* wmix_load_data skip direction (stream faster than engine,
 * src/wmix.c:1707-1797): per source frame, 1 = copied, 0 = skipped. */
void load_skip_flags(int32_t stream_freq, int32_t engine_freq,
                     int64_t n_frames, uint8_t *emit)
{
    float div_pow = (float)(stream_freq - engine_freq) / engine_freq;
    float d = 0.0f;
    int64_t t;
    for (t = 0; t < n_frames; t++)
    {
        if (d >= 1.0f)
        {
            emit[t] = 0;
            d -= 1.0f;
        }
        else
        {
            emit[t] = 1;
            d += div_pow;
        }
    }
}
