// One 20 ms, 16 kHz AEC package (5 blocks of 64 samples) per stream, for
// every stream of the batch, in one launch.
//
// Replaces the Pallas TPU kernel of wmix_tpu/engine/aec_pallas.py
// (build_package_fn -> kernel, pallas_call at :666).  Computes the same
// function as its `_package_body` with mult=2, nlp_mode=2: per block the
// near FFT and power smoothing, the noise-floor tracker, FilterFar and the
// echo estimate, the error FFT, ScaleErrorSignal and FilterAdaptation (the
// ifft -> zero -> fft round trip), NonLinearProcessing (partition-delay
// first max, coherence PSDs, divergence and filter reset, quantiles by
// rank selection, minimum tracking), overdrive-and-suppress, comfort noise
// and the output inverse FFT with overlap-add; then the 48-sample output
// carry.  The plain PyTorch version is engine/aec_package.py
// `package_body`.
//
// What bounds it.  A launch must move about 54 KB per stream (the 23 KB
// state in and out, the near package, four [5,65] far spectra, the
// output): 221 MB at 4096 streams, 0.066 ms at the H100's 3.35 TB/s.  In
// the FFT form below the arithmetic is about 0.5 MFLOP per stream, 0.03 ms
// at the 67 TFLOP/s float32 peak.  So device-memory bytes bound it, and
// everything between the one read and the one write of the state has to
// stay out of device memory and cheap.
//
// Design.  One CTA of 128 threads (four warps) per stream.  The stream's
// state is read from device memory once, the five blocks run in a loop
// inside the CTA out of shared memory, and the state is written back
// once, in place.  The partition histories are rings with a moving head
// inside the kernel and are stored newest first again on the way out, so
// no block shifts 12x65 arrays.
//
// Every transform is a real 128-point FFT in Ooura's rdft convention
// (re = sum x cos, im = +sum x sin, im[0] = im[64] = 0; the inverse scaled
// by 2/128), computed by ONE WARP as a 64-point complex FFT of the
// even/odd packing z[n] = x[2n] + i x[2n+1] plus a split (forward) or
// merge (inverse) step.  Lane l holds points l and l + 32: one radix-2
// stage works in registers and five through __shfl_xor_sync, with no
// shared memory and no barrier inside a transform.  The forward is
// decimation in frequency (natural order in, bit-reversed out), the
// inverse decimation in time (bit-reversed in, natural out), so neither
// reorders data: a lane's two spectrum values are the bins 2 brev5(l) and
// 2 brev5(l) + 1.  A forward leaves its 64 complex values in a 512-byte
// scratch row of its warp, from which the split step reads bins k and
// 64 - k; an inverse forms its merged input straight from the spectrum
// in shared memory.  All twiddles come from the cos/sin table of
// 2 pi m / 128 in `consts` (the five a lane needs sit in registers).
//
// The 30 transforms of a block: the near spectrum on one warp while the
// others run FilterFar; the echo-estimate inverse on one warp while the
// others smooth the powers; the error spectrum and the two windowed
// spectra side by side on three warps; the adaptation round trip with warp w owning partitions w, w + 4,
// w + 8 (gradient spectrum formed in registers, inverse, upper half
// zeroed in registers, forward, added into the filter) without a
// block-wide barrier; the output inverse with its overlap-add inside the
// lanes.  engine/aec_package.py `kernel_rfft_ref` / `kernel_irfft_ref`
// spell the same index arithmetic out in plain torch for the CPU tests.
//
// Everything is float32 on the CUDA cores: no tensor cores, no TF32
// (reduced-precision DFT passes drift through the adaptation loop).  The
// transcendentals use the accurate logf/expf/sinf/cosf (no fast math).
// The per-stream decision logic runs on one warp (sums and rank selection
// across its lanes, the scalar rest on lane 0) while the others form the
// comfort noise.  The state moves as coalesced 4-byte accesses: 16-byte
// accesses for the slices that allow them were measured and gained nothing
// (the kernel is not bound by its load and store instructions).

#include <cuda_runtime.h>

namespace {

constexpr int P1 = 65;            // PART_LEN1
constexpr int PL = 64;            // PART_LEN
constexpr int P2 = 128;           // PART_LEN2
constexpr int NP = 12;            // NUM_PARTITIONS
constexpr int NV = 11;            // smoothed spectra rows
constexpr int NB = 5;             // blocks per package
constexpr int PKG = NB * PL;      // 320
constexpr int OUT_DELAY = 48;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

enum { V_XPOW, V_DPOW, V_DMIN, V_DINITMIN, V_SD, V_SE, V_SX,
       V_SDE0, V_SDE1, V_SXD0, V_SXD1 };

// Pointer order: engine/aec_package.py `_INPUTS`, `STATE_FIELDS`, out.
struct Args {
  const int* flags;     // [5, 3] noise_sel_init, noise_gate_open, upd
  const int* rand;      // [5, 65], lane 0 zero
  const float* near;    // [B, 320]
  const float* xf5r;    // [B, 5, 65]
  const float* xf5i;
  const float* xfw5r;
  const float* xfw5i;
  const float* consts;  // cos[128], sin[128], win[65], wcurve[65], odcurve[65]
  float* vecs;          // [B, 11, 65]
  float* xf_re;         // [B, 12, 65], newest first
  float* xf_im;
  float* wf_re;
  float* wf_im;
  float* xfw_re;
  float* xfw_im;
  float* d_buf;         // [B, 128]
  float* e_buf;         // [B, 128]
  float* out_buf;       // [B, 64]
  float* out_carry;     // [B, 48]
  float* fb_min;        // [B]
  float* fb_local_min;
  float* xd_avg_min;
  float* over_drive;
  float* over_drive_sm;
  int* delay_idx;       // [B]
  int* new_min;
  int* min_ctr;
  int* st_near;
  int* echo;
  int* diverge;
  float* out;           // [B, 320]
};
constexpr int kNumPtrs = sizeof(Args) / sizeof(void*);

struct Scalars {
  float fb_min, fb_local_min, xd_avg_min, over_drive, over_drive_sm;
  float h_fb;
  int delay_idx, new_min, min_ctr, st_near, echo, diverge;
  int is_min1, near1, reset;
};

struct Smem {
  float cs[P2], sn[P2], win[P1], wcurve[P1], odcurve[P1];
  float vecs[NV][P1];
  float xf[2][NP][P1];    // ring, logical i at (head + i) % 12
  float xfw[2][NP][P1];   // ring, same head
  float wf[2][NP][P1];
  float dbuf[P2], ebuf[P2], obuf[PL], carry[OUT_DELAY];
  float near[PKG], stream[PKG];
  float df[2][P1], dfw[2][P1], efw[2][P1], ef[2][P1], yf[2][P1];
  float zr[WARPS][PL], zi[WARPS][PL];   // each warp's FFT scratch row
  float noise_pow[P1], coh_de[P1], coh_xd[P1], cn[2][P1], en[NP];
  Scalars sc;
};

// Smoothing and NLP constants for mult = 2, nlp_mode = 2 (aec_core.c).
constexpr float kG0 = 0.93f, kG1 = 0.07f;
constexpr float kMu = 0.5f;
constexpr float kErrTh = 1.5e-6f;
constexpr float kMinOd = 5.0f;
constexpr float kTargetSupp = -18.4f;
constexpr int kPrefBand = 12;     // PREF_BAND_SIZE / mult
constexpr int kMinPref = 2;       // 4 / mult
constexpr int kQ75 = 8;           // floor(0.75 * 11)
constexpr int kQ50 = 5;           // floor(0.5 * 11)

__device__ __forceinline__ float win128(const Smem& s, int j) {
  return j < PL ? s.win[j] : s.win[P2 - j];
}

// ---- the warp-level FFT ----

// A lane's twiddles: index 0 for the in-register stage (span 32), 1..4 for
// the shuffle stages of span 16, 8, 4, 2; span 1 multiplies by one.
struct Tw {
  float c[5], s[5];
};

__device__ __forceinline__ Tw load_twiddles(const float* consts, int lane) {
  Tw w;
  w.c[0] = consts[2 * lane];
  w.s[0] = consts[P2 + 2 * lane];
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    const int h = 32 >> i;
    const int m = (lane & (h - 1)) * (PL / h);
    w.c[i] = consts[m];
    w.s[i] = consts[P2 + m];
  }
  return w;
}

// a * (c + i s)
__device__ __forceinline__ float2 cmul(float2 a, float c, float s) {
  return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

// The sum of v over the warp, in every lane (a fixed butterfly order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v += __shfl_xor_sync(FULL, v, h);
  return v;
}

// The span-1 stage, whose twiddle is one, in either direction: the lower
// lane gets a + b, the upper a - b.
__device__ __forceinline__ void butterfly1(float2& a, bool upper) {
  const float2 p = make_float2(__shfl_xor_sync(FULL, a.x, 1),
                               __shfl_xor_sync(FULL, a.y, 1));
  a = upper ? make_float2(p.x - a.x, p.y - a.y)
            : make_float2(a.x + p.x, a.y + p.y);
}

// One radix-2 stage across lanes l and l ^ h.  Decimation in frequency
// (forward): lower = a + b, upper = (a - b) tw.  Decimation in time
// (inverse, conjugate twiddle): lower = a + tw b, upper = a - tw b.
template <bool kInverse>
__device__ __forceinline__ void butterfly(float2& a, int h, bool upper,
                                          float c, float s) {
  if (kInverse) {
    const float2 m = cmul(a, c, -s);
    if (upper) a = m;
  }
  const float2 p = make_float2(__shfl_xor_sync(FULL, a.x, h),
                               __shfl_xor_sync(FULL, a.y, h));
  const float2 r = upper ? make_float2(p.x - a.x, p.y - a.y)
                         : make_float2(a.x + p.x, a.y + p.y);
  if (kInverse) {
    a = r;
  } else {
    const float2 m = cmul(r, c, s);
    a = upper ? m : r;
  }
}

// Forward 64-point complex FFT, sum z[n] e^{+2 pi i n k / 64}: a0, a1 are
// points lane and lane + 32 on entry, bins 2 brev5(lane) and
// 2 brev5(lane) + 1 on return.
__device__ __forceinline__ void fft64_forward(float2& a0, float2& a1,
                                              const Tw& w, int lane) {
  const float2 d = make_float2(a0.x - a1.x, a0.y - a1.y);
  a0 = make_float2(a0.x + a1.x, a0.y + a1.y);
  a1 = cmul(d, w.c[0], w.s[0]);
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    const int h = 32 >> i;
    butterfly<false>(a0, h, (lane & h) != 0, w.c[i], w.s[i]);
    butterfly<false>(a1, h, (lane & h) != 0, w.c[i], w.s[i]);
  }
  butterfly1(a0, (lane & 1) != 0);
  butterfly1(a1, (lane & 1) != 0);
}

// Inverse (conjugate kernel, unscaled): bins 2 brev5(lane) and
// 2 brev5(lane) + 1 on entry, points lane and lane + 32 on return.
__device__ __forceinline__ void fft64_inverse(float2& a0, float2& a1,
                                              const Tw& w, int lane) {
  butterfly1(a0, (lane & 1) != 0);
  butterfly1(a1, (lane & 1) != 0);
#pragma unroll
  for (int i = 4; i >= 1; --i) {
    const int h = 32 >> i;
    butterfly<true>(a0, h, (lane & h) != 0, w.c[i], w.s[i]);
    butterfly<true>(a1, h, (lane & h) != 0, w.c[i], w.s[i]);
  }
  const float2 m = cmul(a1, w.c[0], -w.s[0]);
  a1 = make_float2(a0.x - m.x, a0.y - m.y);
  a0 = make_float2(a0.x + m.x, a0.y + m.y);
}

// Forward real transform, first half: the lane's samples x[2l], x[2l+1],
// x[2l+64], x[2l+65] go through the complex FFT, and its 64 values land
// in the warp's scratch row in natural order.
__device__ __forceinline__ void rfft_to_scratch(float x0, float x1, float x64,
                                                float x65, const Tw& w,
                                                int lane, float* zr,
                                                float* zi) {
  float2 a0 = make_float2(x0, x1), a1 = make_float2(x64, x65);
  fft64_forward(a0, a1, w, lane);
  const int k = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27) * 2;
  zr[k] = a0.x;
  zi[k] = a0.y;
  zr[k + 1] = a1.x;
  zi[k + 1] = a1.y;
  __syncwarp();
}

// Forward real transform, second half: bin k (0..64) of the spectrum from
// the scratch row, X[k] = E[k] + e^{2 pi i k / 128} O[k] with E, O the
// transforms of the even and odd samples; im[0] = im[64] = 0.
__device__ __forceinline__ void split_bin(const Smem& s, const float* zr,
                                          const float* zi, int k, float& re,
                                          float& im) {
  const int k1 = k & (PL - 1), k2 = (PL - k) & (PL - 1);
  const float ar = zr[k1], ai = zi[k1], br = zr[k2], bi = -zi[k2];
  const float er = 0.5f * (ar + br), ei = 0.5f * (ai + bi);
  const float orr = 0.5f * (ai - bi), oi = -0.5f * (ar - br);
  const float c = s.cs[k], sn = s.sn[k];
  re = er + (c * orr - sn * oi);
  im = (k == 0 || k == PL) ? 0.f : ei + (c * oi + sn * orr);
}

// Inverse real transform: `spec(k, re, im)` gives bin k (0..64) of the
// packed spectrum; im[0] and im[64] count as zero.  Returns the unscaled
// samples t[2l], t[2l+1] in a0 and t[2l+64], t[2l+65] in a1, where
// t[j] = sum over all 128 bins of the hermitian spectrum; the caller
// scales by 1/128 (the reference's 2/128 on its half-weighted sum).
template <class Spec>
__device__ __forceinline__ void irfft(const Smem& s, Spec spec, const Tw& w,
                                      int lane, float2& a0, float2& a1) {
  const int kb = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27) * 2;
  float2 z[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = kb + r;
    float xr, xi, mr, mi;
    spec(k, xr, xi);
    spec(PL - k, mr, mi);
    if (k == 0) {
      xi = 0.f;
      mi = 0.f;
    }
    // A = X[k] + conj(X[64-k]); B = (X[k] - conj(X[64-k])) e^{-2 pi i k/128}
    const float2 b = cmul(make_float2(xr - mr, xi + mi), s.cs[k], -s.sn[k]);
    z[r] = make_float2((xr + mr) - b.y, (xi - mi) + b.x);
  }
  a0 = z[0];
  a1 = z[1];
  fft64_inverse(a0, a1, w, lane);
}

__global__ void __launch_bounds__(THREADS)
aec_package_kernel(Args a) {
  __shared__ Smem s;
  const int b = blockIdx.x;        // stream
  const int t = threadIdx.x;
  const float kInvPb = static_cast<float>(1.0 / kPrefBand);
  const float kStepLocal = static_cast<float>(0.0008 / 2);
  const float kStepXd = static_cast<float>(0.0006 / 2);
  const float kG1x12 = 0.1f * 12.0f;

  // ---- load constants and the stream's state ----
  for (int i = t; i < P2; i += THREADS) {
    s.cs[i] = a.consts[i];
    s.sn[i] = a.consts[P2 + i];
  }
  for (int i = t; i < P1; i += THREADS) {
    s.win[i] = a.consts[2 * P2 + i];
    s.wcurve[i] = a.consts[2 * P2 + P1 + i];
    s.odcurve[i] = a.consts[2 * P2 + 2 * P1 + i];
  }
  const size_t part_off = static_cast<size_t>(b) * NP * P1;
  for (int i = t; i < NP * P1; i += THREADS) {
    (&s.xf[0][0][0])[i] = a.xf_re[part_off + i];
    (&s.xf[1][0][0])[i] = a.xf_im[part_off + i];
    (&s.xfw[0][0][0])[i] = a.xfw_re[part_off + i];
    (&s.xfw[1][0][0])[i] = a.xfw_im[part_off + i];
    (&s.wf[0][0][0])[i] = a.wf_re[part_off + i];
    (&s.wf[1][0][0])[i] = a.wf_im[part_off + i];
  }
  for (int i = t; i < NV * P1; i += THREADS)
    (&s.vecs[0][0])[i] = a.vecs[static_cast<size_t>(b) * NV * P1 + i];
  for (int i = t; i < P2; i += THREADS) {
    s.dbuf[i] = a.d_buf[static_cast<size_t>(b) * P2 + i];
    s.ebuf[i] = a.e_buf[static_cast<size_t>(b) * P2 + i];
  }
  for (int i = t; i < PL; i += THREADS)
    s.obuf[i] = a.out_buf[static_cast<size_t>(b) * PL + i];
  for (int i = t; i < OUT_DELAY; i += THREADS)
    s.carry[i] = a.out_carry[static_cast<size_t>(b) * OUT_DELAY + i];
  for (int i = t; i < PKG; i += THREADS)
    s.near[i] = a.near[static_cast<size_t>(b) * PKG + i];
  if (t == 0) {
    s.sc.fb_min = a.fb_min[b];
    s.sc.fb_local_min = a.fb_local_min[b];
    s.sc.xd_avg_min = a.xd_avg_min[b];
    s.sc.over_drive = a.over_drive[b];
    s.sc.over_drive_sm = a.over_drive_sm[b];
    s.sc.delay_idx = a.delay_idx[b];
    s.sc.new_min = a.new_min[b];
    s.sc.min_ctr = a.min_ctr[b];
    s.sc.st_near = a.st_near[b];
    s.sc.echo = a.echo[b];
    s.sc.diverge = a.diverge[b];
  }
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  const Tw tw = load_twiddles(a.consts, lane);
  float* const zr = s.zr[warp];
  float* const zi = s.zi[warp];
  const float kInvN = 1.0f / P2;

  int head = 0;
  for (int blk = 0; blk < NB; ++blk) {
    const bool f_sel = a.flags[blk * 3 + 0] != 0;
    const bool f_gate = a.flags[blk * 3 + 1] != 0;
    const bool f_upd = a.flags[blk * 3 + 2] != 0;
    head = (head + NP - 1) % NP;   // the oldest slot takes the new partition

    // ---- 1. shift the near block into dBuf; insert the far partitions ----
    if (t < PL) {     // thread t alone touches dbuf[t] and dbuf[64 + t]
      s.dbuf[t] = s.dbuf[PL + t];
      s.dbuf[PL + t] = s.near[blk * PL + t];
    }
    if (t < P1) {
      const size_t in_off = (static_cast<size_t>(b) * NB + blk) * P1 + t;
      s.xf[0][head][t] = a.xf5r[in_off];
      s.xf[1][head][t] = a.xf5i[in_off];
      s.xfw[0][head][t] = a.xfw5r[in_off];
      s.xfw[1][head][t] = a.xfw5i[in_off];
    }
    __syncthreads();

    // ---- 2. near spectrum (warp 0); far power and FilterFar per bin
    //         (warps 1..3) ----
    if (warp == 0) {
      const int j = 2 * lane;
      rfft_to_scratch(s.dbuf[j], s.dbuf[j + 1], s.dbuf[PL + j],
                      s.dbuf[PL + j + 1], tw, lane, zr, zi);
      for (int k = lane; k < P1; k += 32)
        split_bin(s, zr, zi, k, s.df[0][k], s.df[1][k]);
    } else if (t - 32 < P1) {
      const int k = t - 32;
      const float xr = s.xf[0][head][k], xi = s.xf[1][head][k];
      s.vecs[V_XPOW][k] = 0.9f * s.vecs[V_XPOW][k] + kG1x12 * (xr * xr + xi * xi);
      float yr = 0.f, yi = 0.f;
      for (int i = 0; i < NP; ++i) {
        const int p = (head + i) % NP;
        const float ar = s.xf[0][p][k], ai = s.xf[1][p][k];
        const float wr = s.wf[0][i][k], wi = s.wf[1][i][k];
        yr += ar * wr - ai * wi;
        yi += ar * wi + ai * wr;
      }
      s.yf[0][k] = yr;
      s.yf[1][k] = yi;
    }
    __syncthreads();

    // ---- 3. echo estimate = second half of the inverse, error e into
    //         eBuf (warp 0); near power and noise floor per bin (warps
    //         1..3) ----
    if (warp == 0) {
      float2 a0, a1;
      irfft(s, [&](int k, float& re, float& im) {
        re = s.yf[0][k];
        im = s.yf[1][k];
      }, tw, lane, a0, a1);
      const int j = 2 * lane;   // the lane alone touches ebuf[j], [64 + j] (+1)
      s.ebuf[j] = s.ebuf[PL + j];
      s.ebuf[j + 1] = s.ebuf[PL + j + 1];
      s.ebuf[PL + j] = s.near[blk * PL + j] - a1.x * kInvN;
      s.ebuf[PL + j + 1] = s.near[blk * PL + j + 1] - a1.y * kInvN;
    } else if (t - 32 < P1) {
      const int k = t - 32;
      const float dr = s.df[0][k], di = s.df[1][k];
      const float d_pow = 0.9f * s.vecs[V_DPOW][k] + 0.1f * (dr * dr + di * di);
      const float dmin_prev = s.vecs[V_DMIN][k];
      const float lower = (d_pow + 0.1f * (dmin_prev - d_pow)) * 1.0002f;
      const float dmin_upd = d_pow < dmin_prev ? lower : dmin_prev * 1.0002f;
      const float d_min_pow = f_gate ? dmin_upd : dmin_prev;
      const float dinit_prev = s.vecs[V_DINITMIN][k];
      const float dinit_upd = d_min_pow > dinit_prev
          ? 0.999f * dinit_prev + 0.001f * d_min_pow : d_min_pow;
      const float d_init_min_pow = f_sel ? dinit_upd : dinit_prev;
      s.noise_pow[k] = f_sel ? d_init_min_pow : d_min_pow;
      s.vecs[V_DPOW][k] = d_pow;
      s.vecs[V_DMIN][k] = d_min_pow;
      s.vecs[V_DINITMIN][k] = d_init_min_pow;
    }
    __syncthreads();

    // ---- 4. error spectrum of [zeros(64), e] + ScaleErrorSignal (warp
    //         0); windowed error and near spectra (warps 1, 2).  The two
    //         windowed transforms are ONE instruction stream run by two
    //         warps: while the filter is empty e equals d exactly, and the
    //         divergence test `se_sum > sd_sum` relies on equal inputs
    //         giving bit-equal spectra (two inlined copies could contract
    //         their multiply-adds differently) ----
    if (warp == 0) {
      const int j = 2 * lane;
      rfft_to_scratch(0.f, 0.f, s.ebuf[PL + j], s.ebuf[PL + j + 1], tw, lane,
                      zr, zi);
      for (int k = lane; k < P1; k += 32) {
        float re, im;
        split_bin(s, zr, zi, k, re, im);
        const float den = s.vecs[V_XPOW][k] + 1e-10f;
        re = re / den;
        im = im / den;
        const float abs_ef = sqrtf(re * re + im * im);
        const float fac = kErrTh / (abs_ef + 1e-10f);
        if (abs_ef > kErrTh) {
          re *= fac;
          im *= fac;
        }
        s.ef[0][k] = re * kMu;
        s.ef[1][k] = im * kMu;
      }
    } else if (warp <= 2) {
      const float* src = warp == 1 ? s.ebuf : s.dbuf;
      float (*dst)[P1] = warp == 1 ? s.efw : s.dfw;
      const int j = 2 * lane;
      rfft_to_scratch(src[j] * win128(s, j), src[j + 1] * win128(s, j + 1),
                      src[PL + j] * win128(s, PL + j),
                      src[PL + j + 1] * win128(s, PL + j + 1), tw, lane,
                      zr, zi);
      for (int k = lane; k < P1; k += 32)
        split_bin(s, zr, zi, k, dst[0][k], dst[1][k]);
    }
    __syncthreads();

    // ---- 5. FilterAdaptation: warp w owns partitions w, w + 4, w + 8.
    //         Gradient spectrum conj(X) E -> inverse -> keep the first 64
    //         samples -> forward -> add into the filter ----
    for (int i = warp; i < NP; i += WARPS) {
      const int p = (head + i) % NP;
      float2 a0, a1;
      irfft(s, [&](int k, float& re, float& im) {
        const float xr = s.xf[0][p][k], xi = s.xf[1][p][k];
        const float er = s.ef[0][k], ei = s.ef[1][k];
        re = xr * er + xi * ei;
        im = xr * ei - xi * er;
      }, tw, lane, a0, a1);
      rfft_to_scratch(a0.x * kInvN, a0.y * kInvN, 0.f, 0.f, tw, lane, zr, zi);
      float energy = 0.f;        // of the updated partition, for step 7
      for (int k = lane; k < P1; k += 32) {
        float re, im;
        split_bin(s, zr, zi, k, re, im);
        const float wr = s.wf[0][i][k] + re;
        const float wi = s.wf[1][i][k] + im;     // im is zero at k = 0, 64
        s.wf[0][i][k] = wr;
        s.wf[1][i][k] = wi;
        energy += wr * wr + wi * wi;
      }
      energy = warp_sum(energy);
      if (lane == 0) s.en[i] = energy;
      __syncwarp();              // the scratch row is free again
    }
    __syncthreads();

    // ---- 7. NonLinearProcessing ----
    int didx = s.sc.delay_idx;
    if (f_upd) {      // PartitionDelay: the FIRST max wins
      float mx = s.en[0];
      didx = 0;
      for (int i = 1; i < NP; ++i)
        if (s.en[i] > mx) {
          mx = s.en[i];
          didx = i;
        }
    }
    const int pd = (head + didx) % NP;
    if (t < P1) {     // SmoothedPSD and coherence
      const float dr = s.dfw[0][t], di = s.dfw[1][t];
      const float er = s.efw[0][t], ei = s.efw[1][t];
      const float xr = s.xfw[0][pd][t], xi = s.xfw[1][pd][t];
      const float sd = kG0 * s.vecs[V_SD][t] + kG1 * (dr * dr + di * di);
      const float se = kG0 * s.vecs[V_SE][t] + kG1 * (er * er + ei * ei);
      const float sx = kG0 * s.vecs[V_SX][t] + kG1 * fmaxf(xr * xr + xi * xi, 15.f);
      const float sde0 = kG0 * s.vecs[V_SDE0][t] + kG1 * (dr * er + di * ei);
      const float sde1 = kG0 * s.vecs[V_SDE1][t] + kG1 * (dr * ei - di * er);
      const float sxd0 = kG0 * s.vecs[V_SXD0][t] + kG1 * (dr * xr + di * xi);
      const float sxd1 = kG0 * s.vecs[V_SXD1][t] + kG1 * (dr * xi - di * xr);
      s.vecs[V_SD][t] = sd;
      s.vecs[V_SE][t] = se;
      s.vecs[V_SX][t] = sx;
      s.vecs[V_SDE0][t] = sde0;
      s.vecs[V_SDE1][t] = sde1;
      s.vecs[V_SXD0][t] = sxd0;
      s.vecs[V_SXD1][t] = sxd1;
      s.coh_de[t] = (sde0 * sde0 + sde1 * sde1) / (sd * se + 1e-10f);
      s.coh_xd[t] = (sxd0 * sxd0 + sxd1 * sxd1) / (sx * sd + 1e-10f);
    }
    __syncthreads();

    // The per-stream decision logic on warp 0: the sums and the rank
    // selection across its lanes, the scalar rest on lane 0.  Warps 1..3
    // form the comfort noise meanwhile, which does not depend on it.
    if (warp == 0) {
      Scalars& c = s.sc;
      // one instruction stream for both sums: equal spectra give equal sums
      const float sd_sum = warp_sum(s.vecs[V_SD][lane] + s.vecs[V_SD][lane + 32] +
                                    (lane == 0 ? s.vecs[V_SD][PL] : 0.f));
      const float se_sum = warp_sum(s.vecs[V_SE][lane] + s.vecs[V_SE][lane + 32] +
                                    (lane == 0 ? s.vecs[V_SE][PL] : 0.f));
      const bool in_band = lane < kPrefBand;
      const float cxd = in_band ? s.coh_xd[kMinPref + lane] : 0.f;
      const float cde = in_band ? s.coh_de[kMinPref + lane] : 0.f;
      const float sum_xd = warp_sum(cxd), sum_de = warp_sum(cde);
      // rank selection, every band lane its own rank; ties go to the
      // lower index; the lane of rank q holds the q-th order statistic
      const float v = fminf(cde, 1.0f - cxd);
      int rank = 0;
#pragma unroll
      for (int j = 0; j < kPrefBand; ++j) {
        const float vj = __shfl_sync(FULL, v, j);
        rank += (vj < v) || (vj == v && j < lane);
      }
      const unsigned m75 = __ballot_sync(FULL, in_band && rank == kQ75);
      const unsigned m50 = __ballot_sync(FULL, in_band && rank == kQ50);
      const float q75 = __shfl_sync(FULL, v, m75 ? 31 - __clz(m75) : 0);
      const float q50 = __shfl_sync(FULL, v, m50 ? 31 - __clz(m50) : 0);
      const float v_q75 = m75 ? q75 : 0.f, v_q50 = m50 ? q50 : 0.f;

      if (lane == 0) {
        c.diverge = ((c.diverge != 0 ? 1.05f * se_sum : se_sum) > sd_sum) ? 1 : 0;
        c.reset = se_sum > 19.95f * sd_sum;
        c.delay_idx = didx;
        const float h_xd_avg = 1.0f - sum_xd * kInvPb;
        const float h_de_avg = sum_de * kInvPb;
        float xd_min = (h_xd_avg < 0.75f && h_xd_avg < c.xd_avg_min) ? h_xd_avg : c.xd_avg_min;
        if (h_de_avg > 0.98f && h_xd_avg > 0.9f)
          c.st_near = 1;
        else if (h_de_avg < 0.95f || h_xd_avg < 0.8f)
          c.st_near = 0;
        const bool is_min1 = xd_min == 1.0f;
        const bool near1 = c.st_near == 1;
        c.is_min1 = is_min1;
        c.near1 = near1;
        c.echo = (is_min1 || near1) ? 0 : 1;
        float od = is_min1 ? kMinOd : c.over_drive;
        c.h_fb = near1 ? h_de_avg : (is_min1 ? h_xd_avg : v_q75);
        const float h_fb_low = near1 ? h_de_avg : (is_min1 ? h_xd_avg : v_q50);

        // minimum tracking
        const bool new_min = h_fb_low < 0.6f && h_fb_low < c.fb_local_min;
        float fb_local = new_min ? h_fb_low : c.fb_local_min;
        if (new_min) {
          c.fb_min = h_fb_low;
          c.new_min = 1;
          c.min_ctr = 0;
        }
        c.fb_local_min = fminf(fb_local + kStepLocal, 1.0f);
        c.xd_avg_min = fminf(xd_min + kStepXd, 1.0f);
        if (c.new_min == 1) c.min_ctr += 1;
        if (c.min_ctr == 2) {
          c.new_min = 0;
          c.min_ctr = 0;
          od = fmaxf(kTargetSupp / (logf(c.fb_min + 1e-10f) + 1e-10f), kMinOd);
        }
        c.over_drive = od;
        c.over_drive_sm = od < c.over_drive_sm
            ? 0.99f * c.over_drive_sm + 0.01f * od
            : 0.9f * c.over_drive_sm + 0.1f * od;
      }
    } else if (t - 32 < P1) {
      const int k = t - 32;
      const float r = static_cast<float>(a.rand[blk * P1 + k]) * (1.0f / 32768.0f);
      const float ang = 6.28318530717959f * r;
      const float noise = sqrtf(fmaxf(s.noise_pow[k], 0.f));
      s.cn[0][k] = k == 0 ? 0.f : noise * cosf(ang);
      s.cn[1][k] = (k == 0 || k == PL) ? 0.f : -(noise * sinf(ang));
    }
    __syncthreads();

    // ---- 8. suppression + comfort noise (per bin); filter reset ----
    {
      const Scalars& c = s.sc;
      if (t < P1) {
        float efr = c.diverge ? s.dfw[0][t] : s.efw[0][t];
        float efi = c.diverge ? s.dfw[1][t] : s.efw[1][t];
        const float omx = 1.0f - s.coh_xd[t];
        float h_nl = c.near1 ? s.coh_de[t]
                             : (c.is_min1 ? omx : fminf(s.coh_de[t], omx));
        const float blend = s.wcurve[t] * c.h_fb + (1.0f - s.wcurve[t]) * h_nl;
        if (h_nl > c.h_fb) h_nl = blend;
        h_nl = expf((c.over_drive_sm * s.odcurve[t]) * logf(h_nl + 1e-30f));
        efr = efr * h_nl;
        efi = efi * h_nl * -1.0f;
        const float lam2 = sqrtf(fmaxf(1.0f - h_nl * h_nl, 0.0f));
        s.efw[0][t] = efr + lam2 * s.cn[0][t];
        s.efw[1][t] = efi + lam2 * s.cn[1][t];
      }
      if (c.reset)
        for (int i = t; i < 2 * NP * P1; i += THREADS) (&s.wf[0][0][0])[i] = 0.f;
    }
    __syncthreads();

    // ---- 9. output inverse fft (of the conjugate) + overlap-add, inside
    //         the lanes of warp 0; nothing it touches is written by the
    //         other warps before the next block's first barrier ----
    if (warp == 0) {
      float2 a0, a1;
      irfft(s, [&](int k, float& re, float& im) {
        re = s.efw[0][k];
        im = -s.efw[1][k];
      }, tw, lane, a0, a1);
      const float lo[2] = {a0.x * kInvN, a0.y * kInvN};
      const float hi[2] = {a1.x * kInvN, a1.y * kInvN};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = 2 * lane + r;
        const float first = lo[r] * s.win[j] + s.obuf[j];
        s.obuf[j] = hi[r] * s.win[PL - j];
        s.stream[blk * PL + j] = fminf(fmaxf(first, -32768.0f), 32767.0f);
      }
    }
  }
  __syncthreads();

  // ---- package output (48-sample carry) and state write-back ----
  for (int i = t; i < PKG; i += THREADS)
    a.out[static_cast<size_t>(b) * PKG + i] =
        i < OUT_DELAY ? s.carry[i] : s.stream[i - OUT_DELAY];
  for (int i = t; i < OUT_DELAY; i += THREADS)
    a.out_carry[static_cast<size_t>(b) * OUT_DELAY + i] = s.stream[PKG - OUT_DELAY + i];
  for (int idx = t; idx < NP * P1; idx += THREADS) {
    const int i = idx / P1, k = idx % P1;
    const int p = (head + i) % NP;
    a.xf_re[part_off + idx] = s.xf[0][p][k];
    a.xf_im[part_off + idx] = s.xf[1][p][k];
    a.xfw_re[part_off + idx] = s.xfw[0][p][k];
    a.xfw_im[part_off + idx] = s.xfw[1][p][k];
    a.wf_re[part_off + idx] = s.wf[0][i][k];
    a.wf_im[part_off + idx] = s.wf[1][i][k];
  }
  for (int i = t; i < NV * P1; i += THREADS)
    a.vecs[static_cast<size_t>(b) * NV * P1 + i] = (&s.vecs[0][0])[i];
  for (int i = t; i < P2; i += THREADS) {
    a.d_buf[static_cast<size_t>(b) * P2 + i] = s.dbuf[i];
    a.e_buf[static_cast<size_t>(b) * P2 + i] = s.ebuf[i];
  }
  for (int i = t; i < PL; i += THREADS)
    a.out_buf[static_cast<size_t>(b) * PL + i] = s.obuf[i];
  if (t == 0) {
    a.fb_min[b] = s.sc.fb_min;
    a.fb_local_min[b] = s.sc.fb_local_min;
    a.xd_avg_min[b] = s.sc.xd_avg_min;
    a.over_drive[b] = s.sc.over_drive;
    a.over_drive_sm[b] = s.sc.over_drive_sm;
    a.delay_idx[b] = s.sc.delay_idx;
    a.new_min[b] = s.sc.new_min;
    a.min_ctr[b] = s.sc.min_ctr;
    a.st_near[b] = s.sc.st_near;
    a.echo[b] = s.sc.echo;
    a.diverge[b] = s.sc.diverge;
  }
}

}  // namespace

// Plain C entry for ctypes: ptrs holds the kNumPtrs device pointers in
// `Args` order.  Launches on `stream` and returns cudaGetLastError().
extern "C" int wmix_aec_package_launch(void* const* ptrs, int n_ptrs,
                                       int batch, int mult, int nlp_mode,
                                       void* stream) {
  if (n_ptrs != kNumPtrs || batch < 0 || mult != 2 || nlp_mode != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Args a;
  void** dst = reinterpret_cast<void**>(&a);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];
  aec_package_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wmix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
