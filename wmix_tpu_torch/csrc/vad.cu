// One daemon package of the VAD (webrtc's GMM VAD in aggressiveness mode
// 3, and the daemon wrapper's progressive mute) per stream, for every
// stream of the batch, in one launch.
//
// Replaces no TPU kernel: wmix_tpu's VAD (wmix_tpu/dsp/vad.py) is plain
// jnp.  This kernel was added because the port's eager form, dsp/vad.py
// `process_body`, is a scalar program per stream written as Python loops
// over [B] tensors: about 5,700 launches of tiny elementwise kernels a
// 20 ms, 16 kHz package.  The host's launches, not the device, bounded
// it.  It computes the same function bit for bit: the truncating downmix
// (`intops.downmix`), then per wrapper subpackage `calc_vad` (the
// 32 -> 16 -> 8 kHz downsampling, the five split filters, the high-pass,
// the log energies with `sabs`'s quirk for -32768, the Gaussian pair per
// band, the hypothesis test, the minimum tracking, the model updates, the
// separation of models too close, the drift control, the power gate and
// the hangover) and the progressive `reduce`; every subpackage re-reads
// the package's first subpackage, which only the first pass mutes (the
// C's quirk, src/webrtc.c:120-140); the result duplicated to every
// channel.
//
// What bounds it.  A launch moves the package in and out (5.2 MB each way
// at 4096 streams of 320 int32 samples) and the 268-word state in and
// out (4.4 MB each way): about 19 MB, 6 us at the H100's 3.35 TB/s.  The
// arithmetic is a serial chain per stream: the filters' recursions carry
// from sample to sample, the models and the minimum tables from
// subpackage to subpackage, a few thousand dependent integer operations a
// package, so a stream's latency bounds the launch, not the card's
// throughput.
//
// Design.  One thread per stream walks its whole package in the C's
// order with the scalar state in registers.  Blocks hold few streams (32
// at most), so 4096 streams make 128 blocks and spread over the SMs.  A
// thread's row of shared memory holds its first subpackage (staged with
// coalesced loads, downmixed on the way in), a scratch for the 8 kHz
// signal and the filterbank, and `_find_minimum`'s two [6, 16] tables,
// which the walk indexes dynamically; each row is padded to an odd length
// so that the threads' walks, at one offset, fall on distinct banks.  The
// filterbank runs in place: each split filter writes its high band over
// its input's even samples and its low band over the odd ones, so a band
// at depth d lies at a stride of 2^d.  The constant tables sit in
// constant memory.  The output leaves duplicated to every channel; the
// samples after the first subpackage pass through, downmixed.
//
// Everything is integer with C's semantics, as the eager form keeps them
// on int32 tensors: wraparound (add and multiply in uint32, then cast),
// arithmetic right shifts, int16 stores as casts, the energy sum modulo
// 2^32, DivW32W16's 0xFFFFFFFF and 0x7FFFFFFF cases, and torch's shift of
// a negative or too large count.  The minimum tracking is vad_sp.c's
// sequential aging with removal, then the insertion at the first value
// above the feature.  Frames under the power gate change no model, so
// their model update is skipped rather than computed and dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STREAMS = 32;   // streams (threads) a block
constexpr int N_CH = 6;           // bands
constexpr int TBL = 12;           // Gaussians: 2 a band, [k * 6 + band]
constexpr int MIN_W = 16 * N_CH;  // a [6, 16] minimum table's words
constexpr int N_LEAVES = 15;      // VadState's leaves

// A stream's words before each VadState leaf in the new state buffer
// (the leaves in field order, leaf i as [B, width_i], one after another).
enum {
  O_NM = 0, O_SM = 12, O_NS = 24, O_SS = 36, O_FC = 48, O_OH = 49,
  O_NSP = 50, O_IDX = 51, O_LOW = 147, O_MEAN = 243, O_UP = 249,
  O_LO = 254, O_HP = 259, O_DS = 263, O_RED = 267, WORDS = 268
};
// VadState's leaves, in field order
enum { L_NM, L_SM, L_NS, L_SS, L_FC, L_OH, L_NSP, L_IDX, L_LOW, L_MEAN,
       L_UP, L_LO, L_HP, L_DS, L_RED };

// Pointer order: dsp/vad.py `_kernel_process`.
struct Args {
  const int32_t* in;               // [B, frames * chn], interleaved
  const int32_t* leaf[N_LEAVES];   // VadState's leaves, [B, ...] each
  int32_t* out;                    // [B, frames * chn]
  int32_t* state;                  // WORDS x B, see O_*
};
constexpr int kNumPtrs = sizeof(Args) / sizeof(void*);

struct State {
  int32_t nm[TBL], sm[TBL], ns[TBL], ss[TBL];
  int32_t fc, oh, nsp;
  int32_t mean[N_CH];
  int32_t up[5], lo[5], hp[4], ds[4];
  int32_t red;
};

// vad_core.c, vad_gmm.c: the model's constants
__constant__ int32_t kNoiseW[TBL] = {34, 62, 72, 66, 53, 25,
                                     94, 66, 56, 62, 75, 103};
__constant__ int32_t kSpeechW[TBL] = {48, 82, 45, 87, 50, 47,
                                      80, 46, 83, 41, 78, 81};
__constant__ int32_t kSpectrumW[N_CH] = {6, 8, 10, 12, 14, 16};
__constant__ int32_t kMinDiff[N_CH] = {544, 544, 576, 576, 576, 576};
__constant__ int32_t kMaxSpeech[N_CH] = {11392, 11392, 11520,
                                         11520, 11520, 11520};
__constant__ int32_t kMaxNoise[N_CH] = {9216, 9088, 8960, 8832, 8704, 8576};
// the speech means' upper clamp less 640, band by band, as the eager
// form's `maxspe_seq` has it
__constant__ int32_t kMaxSpeSeq[N_CH] = {12800, 11392, 11392,
                                         11520, 11520, 11520};
constexpr int32_t NOISE_UPDATE = 655, SPEECH_UPDATE = 6554, BACK_ETA = 154;
constexpr int32_t MAX_SPEECH_FRAMES = 6, MIN_STD = 384, MIN_ENERGY = 10;
constexpr int32_t COMP_VAR = 22005, LOG2_EXP = 5909, LOG_CONST = 24660;
constexpr int32_t LOG_ENERGY_INT = 14336;

// ------------------------------------------------ int32 with C's wrap

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
// left shift by 0 <= n < 32 of the bit pattern
__device__ __forceinline__ int32_t shl(int32_t a, int n) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << n);
}
// torch's `>>` on int32 by a tensor: a count below 0 or above 30 gives
// the sign
__device__ __forceinline__ int32_t sra(int32_t a, int32_t n) {
  return a >> (n < 0 || n > 31 ? 31 : n);
}
__device__ __forceinline__ int32_t w16(int32_t a) {    // intops.wrap16
  return static_cast<int16_t>(a);
}
// torch's abs on int32: INT32_MIN stays INT32_MIN
__device__ __forceinline__ int32_t iabs(int32_t a) {
  return a < 0 ? wsub(0, a) : a;
}
// WebRtcSpl_NormW32: redundant sign bits; 0 for 0
__device__ __forceinline__ int norm_w32(int32_t a) {
  return a == 0 ? 0 : __clz(a < 0 ? ~a : a) - 1;
}
// intops.div_w32_w16 (WebRtcSpl_DivW32W16)
__device__ __forceinline__ int32_t div_w32_w16(int32_t num, int32_t den) {
  if (den == 0) return 0x7FFFFFFF;
  const uint32_t na = static_cast<uint32_t>(iabs(num));
  const uint32_t da = static_cast<uint32_t>(iabs(den)) & 0xFFFFu;
  const uint32_t q = da == 0 ? 0xFFFFFFFFu : na / da;
  return (num < 0) != (den < 0) ? wsub(0, static_cast<int32_t>(q))
                                : static_cast<int32_t>(q);
}
// the bit length of N (Python's int.bit_length), at compile time
template <int N> struct BitLength {
  static constexpr int value = 1 + BitLength<(N >> 1)>::value;
};
template <> struct BitLength<0> { static constexpr int value = 0; };

// ------------------------------------------------ filterbank

// `_downsample_by2`: HALF outputs from in[2 HALF]; out may be in
__device__ __forceinline__ void downsample(const int32_t* in, int32_t* out,
                                           int half, int32_t& s0,
                                           int32_t& s1) {
#pragma unroll 4
  for (int i = 0; i < half; ++i) {
    const int32_t x0 = in[2 * i], x1 = in[2 * i + 1];
    const int32_t t0 = w16(wadd(s0 >> 1, wmul(5243, x0) >> 14));
    s0 = wsub(x0, wmul(5243, t0) >> 12);
    const int32_t t1 = w16(wadd(s1 >> 1, wmul(1392, x1) >> 14));
    s1 = wsub(x1, wmul(1392, t1) >> 12);
    out[i] = w16(wadd(t0, t1));
  }
}

// `_split_filter` in place over x[k STEP], k < 2 HALF: the high band to
// the even samples, the low band to the odd ones
template <int HALF, int STEP>
__device__ __forceinline__ void split_filter(int32_t* x, int32_t& up16,
                                             int32_t& lo16) {
  int32_t su = shl(up16, 16), sl = shl(lo16, 16);
#pragma unroll 4
  for (int i = 0; i < HALF; ++i) {
    const int32_t xu = x[2 * i * STEP], xl = x[(2 * i + 1) * STEP];
    const int32_t tu = w16(wadd(su, wmul(20972, xu)) >> 16);
    su = shl(wsub(shl(xu, 14), wmul(20972, tu)), 1);
    const int32_t tl = w16(wadd(sl, wmul(5571, xl)) >> 16);
    sl = shl(wsub(shl(xl, 14), wmul(5571, tl)), 1);
    x[2 * i * STEP] = w16(wsub(tu, tl));
    x[(2 * i + 1) * STEP] = w16(wadd(tl, tu));
  }
  up16 = w16(su >> 16);
  lo16 = w16(sl >> 16);
}

// `_highpass` in place over x[k STEP], k < LEN
template <int LEN, int STEP>
__device__ __forceinline__ void highpass(int32_t* x, int32_t* f) {
  int32_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3];
#pragma unroll
  for (int i = 0; i < LEN; ++i) {
    const int32_t xv = x[i * STEP];
    int32_t t = wadd(wadd(wmul(6631, xv), wmul(-13262, f0)),
                     wmul(6631, f1));
    f1 = f0;
    f0 = xv;
    t = wsub(wsub(t, wmul(-7756, f2)), wmul(5620, f3));
    f3 = f2;
    f2 = w16(t >> 14);
    x[i * STEP] = f2;
  }
  f[0] = f0; f[1] = f1; f[2] = f2; f[3] = f3;
}

// `_log_of_energy` over x[k STEP], k < LEN; updates total
template <int LEN, int STEP>
__device__ __forceinline__ int32_t log_energy(const int32_t* x,
                                              int32_t offset,
                                              int32_t& total) {
  constexpr int NBITS = BitLength<LEN>::value;
  int32_t smax = -1;    // sabs wraps to int16: -32768 never wins the max
#pragma unroll 5
  for (int i = 0; i < LEN; ++i) smax = max(smax, w16(iabs(x[i * STEP])));
  const int t = norm_w32(wmul(smax, smax));
  const int scaling = smax == 0 ? 0 : (t > NBITS ? 0 : NBITS - t);
  uint32_t energy = 0;  // the sum modulo 2^32
#pragma unroll 5
  for (int i = 0; i < LEN; ++i) {
    const int32_t v = x[i * STEP];
    energy += static_cast<uint32_t>(wmul(v, v) >> scaling);
  }
  if (energy == 0) return offset;
  const int norm_rs = 17 - __clz(static_cast<int>(energy));
  const int tot_rshifts = scaling + norm_rs;
  const uint32_t e_norm = norm_rs < 0 ? energy << -norm_rs
                                      : energy >> norm_rs;
  const int32_t log2_energy =
      w16(LOG_ENERGY_INT + (static_cast<int32_t>(e_norm & 0x3FFF) >> 4));
  int32_t log_e = w16(wadd(wmul(LOG_CONST, log2_energy) >> 19,
                           wmul(tot_rshifts, LOG_CONST) >> 9));
  log_e = w16(max(log_e, 0) + offset);
  if (total <= MIN_ENERGY)
    total = w16(wadd(total, tot_rshifts >= 0
                                ? MIN_ENERGY + 1
                                : w16(static_cast<int32_t>(
                                      energy >> -tot_rshifts))));
  return log_e;
}

// `_calculate_features` over the 8 kHz signal x[NB], in place
template <int NB>
__device__ __forceinline__ int32_t features(State& s, int32_t* x,
                                            int32_t* f) {
  int32_t total = 0;
  split_filter<NB / 2, 1>(x, s.up[0], s.lo[0]);       // hp120 0:2, lp120 1:2
  split_filter<NB / 4, 2>(x, s.up[1], s.lo[1]);       // hp60 0:4, lp60 2:4
  f[5] = log_energy<NB / 4, 4>(x, 176, total);
  f[4] = log_energy<NB / 4, 4>(x + 2, 176, total);
  split_filter<NB / 4, 2>(x + 1, s.up[2], s.lo[2]);   // hp60b 1:4, lp60b 3:4
  f[3] = log_energy<NB / 4, 4>(x + 1, 176, total);
  split_filter<NB / 8, 4>(x + 3, s.up[3], s.lo[3]);   // hp120b 3:8, lp 7:8
  f[2] = log_energy<NB / 8, 8>(x + 3, 272, total);
  split_filter<NB / 16, 8>(x + 7, s.up[4], s.lo[4]);  // hp60c 7:16, lp 15:16
  f[1] = log_energy<NB / 16, 16>(x + 7, 368, total);
  highpass<NB / 16, 16>(x + 15, s.hp);
  f[0] = log_energy<NB / 16, 16>(x + 15, 368, total);
  return total;
}

// ------------------------------------------------ GMM (vad_gmm.c)

// `_gaussian_probability`: the probability; delta in Q11 to *delta
__device__ __forceinline__ int32_t gaussian(int32_t inp, int32_t mean,
                                            int32_t std, int32_t* delta) {
  const int32_t inv_std = w16(div_w32_w16(wadd(131072, std >> 1), std));
  const int32_t tmp16 = inv_std >> 2;
  const int32_t inv_std2 = w16(wmul(tmp16, tmp16) >> 2);
  const int32_t xm = w16(wsub(w16(shl(inp, 3)), mean));
  const int32_t d = w16(wmul(inv_std2, xm) >> 10);
  const int32_t expo = wmul(d, xm) >> 9;
  int32_t t16 = w16(wsub(0, w16(wmul(LOG2_EXP, expo) >> 12)));
  int32_t exp_value = 0x0400 | (t16 & 0x03FF);
  t16 = wadd(w16(t16 ^ 0xFFFF) >> 10, 1);
  exp_value = exp_value >> min(max(t16, 0), 31);
  if (!(expo < COMP_VAR)) exp_value = 0;
  *delta = d;
  return wmul(inv_std, exp_value);
}

// `_find_minimum` for one band: v, g its 16 values and ages (vad_sp.c's
// order: aging with removal, then insertion); returns the new mean
__device__ __forceinline__ int32_t find_minimum(int32_t* v, int32_t* g,
                                                int32_t mean, int32_t fc,
                                                int32_t feature) {
  for (int i = 0; i < 16; ++i) {
    if (g[i] != 100) {
      g[i] = wadd(g[i], 1);
    } else {
      for (int j = i; j < 15; ++j) {
        v[j] = v[j + 1];
        g[j] = g[j + 1];
      }
      v[15] = 10000;
      g[15] = 101;
    }
  }
  int pos = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) pos += v[k] <= feature;
  if (pos < 16) {
    for (int k = 15; k > pos; --k) {
      v[k] = v[k - 1];
      g[k] = g[k - 1];
    }
    v[pos] = feature;
    g[pos] = 1;
  }
  const int32_t median = fc > 2 ? v[2] : fc > 0 ? v[0] : 1600;
  const int32_t alpha = fc > 0 ? (median < mean ? 6553 : 32439) : 0;
  const int32_t t = wadd(wadd(wmul(alpha + 1, mean),
                              wmul(32767 - alpha, median)), 16384);
  return w16(t >> 15);
}

// `_gmm_probability` for one frame of NB samples at 8 kHz: the decision
// before the hangover is folded in (`flag > 0`)
template <int NB>
__device__ __forceinline__ bool gmm(State& s, const int32_t* f,
                                    int32_t total, int32_t* vals,
                                    int32_t* ages) {
  constexpr int FI = NB == 80 ? 0 : 1;
  constexpr int32_t GLOBAL = FI == 0 ? 1100 : 1050;
  constexpr int32_t LOCAL = 94;
  constexpr int32_t OVER_HANG_1 = FI == 0 ? 6 : 3;
  constexpr int32_t OVER_HANG_2 = FI == 0 ? 9 : 5;
  int32_t vadflag = 0;
  // a frame under the power gate commits nothing but vadflag = 0
  if (total > MIN_ENERGY) {
    int32_t dn[TBL], dsp[TBL], ngp[TBL], sgp[TBL];
    int32_t sum_llr = 0;
    bool local = false;
#pragma unroll
    for (int ch = 0; ch < N_CH; ++ch) {
      int32_t npw[2], spw[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = k * N_CH + ch;
        npw[k] = wmul(kNoiseW[i], gaussian(f[ch], s.nm[i], s.ns[i], &dn[i]));
        spw[k] = wmul(kSpeechW[i],
                      gaussian(f[ch], s.sm[i], s.ss[i], &dsp[i]));
      }
      const int32_t h0 = wadd(npw[0], npw[1]), h1 = wadd(spw[0], spw[1]);
      const int32_t llr = (h0 == 0 ? 31 : norm_w32(h0)) -
                          (h1 == 0 ? 31 : norm_w32(h1));
      sum_llr += llr * kSpectrumW[ch];
      local = local || shl(llr, 2) > LOCAL;
      const int32_t h0_16 = w16(h0 >> 12), h1_16 = w16(h1 >> 12);
      const int32_t ngr0 = w16(div_w32_w16(shl(npw[0] & -4096, 2),
                                           h0_16 > 0 ? h0_16 : 1));
      ngp[ch] = h0_16 > 0 ? ngr0 : 16384;
      ngp[N_CH + ch] = h0_16 > 0 ? 16384 - ngr0 : 0;
      const int32_t sgr0 = w16(div_w32_w16(shl(spw[0] & -4096, 2),
                                           h1_16 > 0 ? h1_16 : 1));
      sgp[ch] = h1_16 > 0 ? sgr0 : 0;
      sgp[N_CH + ch] = h1_16 > 0 ? 16384 - sgr0 : 0;
    }
    vadflag = local || sum_llr >= GLOBAL ? 1 : 0;

#pragma unroll
    for (int ch = 0; ch < N_CH; ++ch) {
      const int32_t fmin = find_minimum(vals + 16 * ch, ages + 16 * ch,
                                        s.mean[ch], s.fc, f[ch]);
      s.mean[ch] = fmin;
      const int32_t tmp1_16 = w16(static_cast<int32_t>(
          (static_cast<int64_t>(wmul(s.nm[ch], kNoiseW[ch])) +
           wmul(s.nm[N_CH + ch], kNoiseW[N_CH + ch])) >> 6));
      int32_t nm2[2], sm2[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = k * N_CH + ch;
        const int32_t nm = s.nm[i], sm = s.sm[i], ns = s.ns[i],
                      ss = s.ss[i];
        // noise mean
        const int32_t delt_n = w16(wmul(ngp[i], dn[i]) >> 11);
        const int32_t nmk2 =
            vadflag == 0
                ? w16(wadd(nm, w16(wmul(delt_n, NOISE_UPDATE) >> 22)))
                : nm;
        const int32_t ndelt = w16(wsub(shl(fmin, 4), tmp1_16));
        const int32_t nmk3 = w16(wadd(nmk2, w16(wmul(ndelt, BACK_ETA) >> 9)));
        nm2[k] = min(max(nmk3, (k + 5) << 7), (72 + k - ch) << 7);
        // speech mean
        const int32_t delt_s = w16(wmul(sgp[i], dsp[i]) >> 11);
        const int32_t t16 = w16(wmul(delt_s, SPEECH_UPDATE) >> 21);
        const int32_t smk2 =
            min(max(w16(wadd(sm, wadd(t16, 1) >> 1)), k == 0 ? 640 : 768),
                kMaxSpeSeq[ch] + 640);
        sm2[k] = vadflag == 1 ? smk2 : sm;
        // speech std
        const int32_t t16b = w16(wsub(f[ch], wadd(sm, 4) >> 3));
        const int32_t t32 = wmul(dsp[i], t16b) >> 3;
        const int32_t t32d = wmul(sgp[i] >> 2, wsub(t32, 4096)) >> 4;
        const int32_t q = w16(div_w32_w16(iabs(t32d), w16(wmul(ss, 10))));
        const int32_t t16d = w16(wadd(t32d > 0 ? q : w16(wsub(0, q)), 128));
        if (vadflag == 1) s.ss[i] = max(w16(wadd(ss, t16d >> 8)), MIN_STD);
        // noise std
        const int32_t t16e = w16(wsub(f[ch], nm >> 3));
        const int32_t t32e = wsub(wmul(dn[i], t16e) >> 3, 4096);
        const int32_t t32g = wmul(wadd(ngp[i], 2) >> 2, t32e) >> 14;
        const int32_t qn = w16(div_w32_w16(iabs(t32g), ns));
        const int32_t t16g = w16(wadd(t32g > 0 ? qn : w16(wsub(0, qn)), 32));
        if (vadflag == 0) s.ns[i] = max(w16(wadd(ns, t16g >> 6)), MIN_STD);
      }
      // separate the models if they are too close (vad_core.c:402-436)
      int64_t ngm = static_cast<int64_t>(wmul(nm2[0], kNoiseW[ch])) +
                    wmul(nm2[1], kNoiseW[N_CH + ch]);
      int64_t sgm = static_cast<int64_t>(wmul(sm2[0], kSpeechW[ch])) +
                    wmul(sm2[1], kSpeechW[N_CH + ch]);
      const int32_t diff = w16(static_cast<int32_t>(sgm >> 9)) -
                           w16(static_cast<int32_t>(ngm >> 9));
      if (diff < kMinDiff[ch]) {
        const int32_t t16h = w16(kMinDiff[ch] - diff);
        const int32_t up_s = w16((13 * t16h) >> 2);
        const int32_t dn_n = w16((3 * t16h) >> 2);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          sm2[k] = w16(sm2[k] + up_s);
          nm2[k] = w16(nm2[k] - dn_n);
        }
        ngm = static_cast<int64_t>(wmul(nm2[0], kNoiseW[ch])) +
              wmul(nm2[1], kNoiseW[N_CH + ch]);
        sgm = static_cast<int64_t>(wmul(sm2[0], kSpeechW[ch])) +
              wmul(sm2[1], kSpeechW[N_CH + ch]);
      }
      // drift control (vad_core.c:438-457)
      const int32_t t2 = w16(static_cast<int32_t>(sgm >> 7));
      const int32_t over_s = t2 > kMaxSpeech[ch] ? t2 - kMaxSpeech[ch] : 0;
      const int32_t t2n = w16(static_cast<int32_t>(ngm >> 7));
      const int32_t over_n = t2n > kMaxNoise[ch] ? t2n - kMaxNoise[ch] : 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        s.sm[k * N_CH + ch] = w16(sm2[k] - over_s);
        s.nm[k * N_CH + ch] = w16(nm2[k] - over_n);
      }
    }
    s.fc = wadd(s.fc, 1);
  }

  // hangover smoothing (vad_core.c:462-477)
  const int32_t oh = s.oh, nsp = s.nsp;
  const bool fire = vadflag == 0 && oh > 0;
  const int32_t out_flag = vadflag != 0 ? vadflag : fire ? wadd(2, oh) : 0;
  s.oh = vadflag != 0
             ? (wadd(nsp, 1) > MAX_SPEECH_FRAMES ? OVER_HANG_2 : OVER_HANG_1)
             : fire ? wsub(oh, 1) : oh;
  s.nsp = vadflag != 0 ? min(wadd(nsp, 1), MAX_SPEECH_FRAMES) : 0;
  return out_flag > 0;
}

// ------------------------------------------------ one stream's package

// A row's words before the two minimum tables: the first subpackage
// (nb << ds samples, ds halvings to 8 kHz) and the scratch, which holds
// the 8 kHz signal (at 32 kHz first the 16 kHz one, halved in place)
__host__ __device__ constexpr int tables_at(int nb, int ds) {
  return (nb << ds) + (ds == 0 ? nb : (nb << ds) / 2);
}

// `calc_vad` on the subpackage seg[NB << ds], with x as scratch
template <int NB>
__device__ __forceinline__ bool calc_vad(State& s, int ds,
                                         const int32_t* seg, int32_t* x,
                                         int32_t* vals, int32_t* ages) {
  if (ds == 0) {
    for (int i = 0; i < NB; ++i) x[i] = seg[i];
  } else if (ds == 1) {
    downsample(seg, x, NB, s.ds[0], s.ds[1]);
  } else {
    downsample(seg, x, 2 * NB, s.ds[2], s.ds[3]);
    downsample(x, x, NB, s.ds[0], s.ds[1]);
  }
  int32_t f[N_CH];
  const int32_t total = features<NB>(s, x, f);
  return gmm<NB>(s, f, total, vals, ages);
}

// The subpackages of one stream's package (`process_body`'s loop): row
// holds the first subpackage (downmixed), the scratch, then
// low_value_vector and index_vector as [6, 16] each
template <int NB>
__device__ __forceinline__ void vad_stream(State& s, int32_t* row, int ds,
                                           int passes) {
  const int seg = NB << ds;
  int32_t* vals = row + tables_at(NB, ds);
  for (int p = 0; p < passes; ++p) {
    const bool speech =
        calc_vad<NB>(s, ds, row, row + seg, vals, vals + MIN_W);
    s.red = speech ? max(wsub(s.red, 1), 0) : min(wadd(s.red, 1), 4);
    // only the first pass's mute loop attenuates (src/webrtc.c:140)
    if (p == 0)
      for (int m = 0; m < seg; ++m) row[m] = sra(row[m], s.red);
  }
}

// The truncating downmix of sample m of an interleaved row (the channel
// sum in 64 bits, as torch sums int32)
__device__ __forceinline__ int32_t downmix(const int32_t* src, int m,
                                           int chn) {
  if (chn == 1) return src[m];
  int64_t sum = 0;
  for (int c = 0; c < chn; ++c) sum += src[m * chn + c];
  return static_cast<int32_t>(sum / chn);
}

// Stream b's leaves other than the two minimum tables
__device__ __forceinline__ void load_state(State& s, const Args& a, int b) {
#pragma unroll
  for (int i = 0; i < TBL; ++i) {
    s.nm[i] = a.leaf[L_NM][b * TBL + i];
    s.sm[i] = a.leaf[L_SM][b * TBL + i];
    s.ns[i] = a.leaf[L_NS][b * TBL + i];
    s.ss[i] = a.leaf[L_SS][b * TBL + i];
  }
  s.fc = a.leaf[L_FC][b];
  s.oh = a.leaf[L_OH][b];
  s.nsp = a.leaf[L_NSP][b];
#pragma unroll
  for (int i = 0; i < N_CH; ++i) s.mean[i] = a.leaf[L_MEAN][b * N_CH + i];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    s.up[i] = a.leaf[L_UP][b * 5 + i];
    s.lo[i] = a.leaf[L_LO][b * 5 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.hp[i] = a.leaf[L_HP][b * 4 + i];
    s.ds[i] = a.leaf[L_DS][b * 4 + i];
  }
  s.red = a.leaf[L_RED][b];
}

__device__ __forceinline__ void store_state(const State& s, int32_t* st,
                                            int b, int batch) {
#pragma unroll
  for (int i = 0; i < TBL; ++i) {
    st[O_NM * batch + b * TBL + i] = s.nm[i];
    st[O_SM * batch + b * TBL + i] = s.sm[i];
    st[O_NS * batch + b * TBL + i] = s.ns[i];
    st[O_SS * batch + b * TBL + i] = s.ss[i];
  }
  st[O_FC * batch + b] = s.fc;
  st[O_OH * batch + b] = s.oh;
  st[O_NSP * batch + b] = s.nsp;
#pragma unroll
  for (int i = 0; i < N_CH; ++i) st[O_MEAN * batch + b * N_CH + i] = s.mean[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    st[O_UP * batch + b * 5 + i] = s.up[i];
    st[O_LO * batch + b * 5 + i] = s.lo[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st[O_HP * batch + b * 4 + i] = s.hp[i];
    st[O_DS * batch + b * 4 + i] = s.ds[i];
  }
  st[O_RED * batch + b] = s.red;
}

// ------------------------------------------------------ the kernel

// Dynamic shared memory: blockDim.x rows of `stride` words, each the
// stream's first subpackage, its scratch and its two minimum tables.
template <int NB>
__global__ void __launch_bounds__(MAX_STREAMS)
vad_package_kernel(Args a, int batch, int frames, int chn, int ds,
                   int passes, int stride) {
  const int tables = tables_at(NB, ds);
  extern __shared__ int32_t smem[];
  const int streams = blockDim.x;
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * streams;
  const int rows = min(streams, batch - b0);
  const int row_len = frames * chn;
  const int staged = passes > 0 ? NB << ds : 0;

  // coalesced staging, one row at a time: the first subpackage downmixed,
  // then low_value_vector and index_vector
  for (int r = 0; r < rows; ++r) {
    const int32_t* src = a.in + static_cast<size_t>(b0 + r) * row_len;
    int32_t* dst = smem + r * stride;
    for (int m = t; m < staged; m += streams) dst[m] = downmix(src, m, chn);
    const size_t at = static_cast<size_t>(b0 + r) * MIN_W;
    for (int j = t; j < MIN_W; j += streams) {
      dst[tables + j] = a.leaf[L_LOW][at + j];
      dst[tables + MIN_W + j] = a.leaf[L_IDX][at + j];
    }
  }
  __syncthreads();

  if (t < rows) {
    const int b = b0 + t;
    State s;
    load_state(s, a, b);
    vad_stream<NB>(s, smem + t * stride, ds, passes);
    store_state(s, a.state, b, batch);
  }
  __syncthreads();

  for (int r = 0; r < rows; ++r) {
    const int32_t* src = smem + r * stride;
    const size_t at = static_cast<size_t>(b0 + r) * MIN_W;
    for (int j = t; j < MIN_W; j += streams) {
      a.state[O_LOW * static_cast<size_t>(batch) + at + j] = src[tables + j];
      a.state[O_IDX * static_cast<size_t>(batch) + at + j] =
          src[tables + MIN_W + j];
    }
    const int32_t* in = a.in + static_cast<size_t>(b0 + r) * row_len;
    int32_t* dst = a.out + static_cast<size_t>(b0 + r) * row_len;
    for (int j = t; j < row_len; j += streams) {
      const int m = j / chn;
      dst[j] = w16(m < staged ? src[m] : downmix(in, m, chn));
    }
  }
}

constexpr size_t kMaxSmem = 232448;     // a block's dynamic shared memory

template <int NB>
cudaError_t launch(const Args& a, int batch, int frames, int chn, int ds,
                   int passes, cudaStream_t st) {
  const int stride = (tables_at(NB, ds) + 2 * MIN_W) | 1;  // odd: no conflicts
  const int streams = batch < MAX_STREAMS ? batch : MAX_STREAMS;
  const size_t smem = static_cast<size_t>(streams) * stride * sizeof(int32_t);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // above 48 KB a block's dynamic shared memory has to be asked for
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vad_package_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + streams - 1) / streams;
  vad_package_kernel<NB><<<blocks, streams, smem, st>>>(
      a, batch, frames, chn, ds, passes, stride);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: ptrs holds the kNumPtrs device pointers in
// `Args` order, all on CUDA device `device`, every tensor contiguous, and
// `stream` is a stream of that device.  `freq` is 8000, 16000 or 32000,
// `sub_len` the wrapper's subpackage (80 or 160 at 8 kHz, 160 or 320 at
// 16 kHz, 320 at 32 kHz), `frames` the package's samples per channel
// (any number: a package shorter than a subpackage passes through with
// the state copied), chn >= 1.  The launch makes `device` current,
// launches on `stream`, restores the device that was current before and
// returns the first error (the launch's cudaGetLastError() included).
extern "C" int wmix_vad_launch(void* const* ptrs, int n_ptrs, int batch,
                               int frames, int chn, int freq, int sub_len,
                               int device, void* stream) {
  const int ds = freq == 8000 ? 0 : freq == 16000 ? 1 : freq == 32000 ? 2
                                                                       : -1;
  const int nb = ds < 0 ? 0 : sub_len >> ds;
  if (n_ptrs != kNumPtrs || batch < 0 || chn < 1 || frames < 0 || ds < 0 ||
      (nb != 80 && nb != 160) || (nb << ds) != sub_len ||
      (ds == 2 && nb != 80) || device < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Args a;
  void** dst = reinterpret_cast<void**>(&a);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];
  const int passes = frames / sub_len;

  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one kernel a frame length at 8 kHz; the halvings are an argument
  err = nb == 80 ? launch<80>(a, batch, frames, chn, ds, passes, st)
                 : launch<160>(a, batch, frames, chn, ds, passes, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* wmix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
