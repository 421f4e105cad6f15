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
// Design.  One CTA of 128 threads per stream.  The stream's state (about
// 23 KB: 11x65 smoothed spectra, six 12x65 partition arrays, the time
// buffers and 11 scalars) is read from device memory once, the five
// blocks run in a loop inside the CTA out of shared memory, and the state
// is written back once, in place.  The partition histories are rings with
// a moving head inside the kernel and are stored newest first again on the
// way out, so no block shifts 12x65 arrays.  The DFTs are direct sums over
// a 128-entry cos/sin table in shared memory in place of the reference's
// 13 DFT matrices (about 330 KB, which do not fit); every entry of those
// matrices is +-cos or sin of 2 pi j k / 128, a window value or the 2/128
// scale, which is a power of two and applied exactly after the sum.
//
// What bounds it.  The direct-DFT form costs about 3 MFLOP per stream per
// package (most of it the adaptation round trip: 12 partitions x (65x64 +
// 64x65) complex-by-real multiply-adds per block) against about 52 KB of
// state and inputs moved: some 60 FLOP/byte, above the H100's f32
// CUDA-core ridge of about 20, so arithmetic (and the shared-memory
// operand traffic behind each FMA), not device-memory bandwidth, bounds
// it.  Everything is float32 on the CUDA cores: no tensor cores, no TF32
// (bf16 DFT passes drifted to 822 LSB over 10 s on the reference side).
// The transcendentals use the accurate logf/expf/sinf/cosf (no fast math).
// Speeding it up (an FFT form, several streams per CTA) is later work.

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
  float dbuf[P2], ebuf[P2], dw[P2], ew[P2], obuf[PL], carry[OUT_DELAY];
  float near[PKG], stream[PKG];
  float df[2][P1], dfw[2][P1], efw[2][P1], ef[2][P1], yf[2][P1];
  float e64[PL], t128[P2];
  float grad[2][NP][P1];
  float h64[NP][PL];
  float noise_pow[P1], coh_de[P1], coh_xd[P1], en[NP];
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

  int head = 0;
  for (int blk = 0; blk < NB; ++blk) {
    const bool f_sel = a.flags[blk * 3 + 0] != 0;
    const bool f_gate = a.flags[blk * 3 + 1] != 0;
    const bool f_upd = a.flags[blk * 3 + 2] != 0;
    head = (head + NP - 1) % NP;   // the oldest slot takes the new partition

    // ---- 1. shift the near block into dBuf; insert the far partitions ----
    const float dkeep = t < PL ? s.dbuf[PL + t] : 0.f;
    __syncthreads();
    if (t < PL) {
      s.dbuf[t] = dkeep;
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
    s.dw[t] = s.dbuf[t] * win128(s, t);
    __syncthreads();

    // ---- 2. near spectra, plain and windowed ----
    for (int o = t; o < 2 * P1; o += THREADS) {
      const int k = o % P1;
      const float* src = o < P1 ? s.dbuf : s.dw;
      float re = 0.f, im = 0.f;
      for (int j = 0; j < P2; ++j) {
        const int m = (j * k) & (P2 - 1);
        re = fmaf(src[j], s.cs[m], re);
        im = fmaf(src[j], s.sn[m], im);
      }
      if (k == 0 || k == PL) im = 0.f;
      float (*dst)[P1] = o < P1 ? s.df : s.dfw;
      dst[0][k] = re;
      dst[1][k] = im;
    }
    __syncthreads();

    // ---- 3. power smoothing, noise floor, FilterFar (per bin) ----
    if (t < P1) {
      const float xr = s.xf[0][head][t], xi = s.xf[1][head][t];
      const float x_pow = 0.9f * s.vecs[V_XPOW][t] + kG1x12 * (xr * xr + xi * xi);
      const float dr = s.df[0][t], di = s.df[1][t];
      const float d_pow = 0.9f * s.vecs[V_DPOW][t] + 0.1f * (dr * dr + di * di);
      const float dmin_prev = s.vecs[V_DMIN][t];
      const float lower = (d_pow + 0.1f * (dmin_prev - d_pow)) * 1.0002f;
      const float dmin_upd = d_pow < dmin_prev ? lower : dmin_prev * 1.0002f;
      const float d_min_pow = f_gate ? dmin_upd : dmin_prev;
      const float dinit_prev = s.vecs[V_DINITMIN][t];
      const float dinit_upd = d_min_pow > dinit_prev
          ? 0.999f * dinit_prev + 0.001f * d_min_pow : d_min_pow;
      const float d_init_min_pow = f_sel ? dinit_upd : dinit_prev;
      s.noise_pow[t] = f_sel ? d_init_min_pow : d_min_pow;
      s.vecs[V_XPOW][t] = x_pow;
      s.vecs[V_DPOW][t] = d_pow;
      s.vecs[V_DMIN][t] = d_min_pow;
      s.vecs[V_DINITMIN][t] = d_init_min_pow;

      float yr = 0.f, yi = 0.f;
      for (int i = 0; i < NP; ++i) {
        const int p = (head + i) % NP;
        const float ar = s.xf[0][p][t], ai = s.xf[1][p][t];
        const float wr = s.wf[0][i][t], wi = s.wf[1][i][t];
        yr += ar * wr - ai * wi;
        yi += ar * wi + ai * wr;
      }
      s.yf[0][t] = yr;
      s.yf[1][t] = yi;
    }
    __syncthreads();

    // ---- 4. echo estimate y = second half of the inverse, error e ----
    if (t < PL) {
      const int j = PL + t;
      float acc = 0.5f * s.yf[0][0] + 0.5f * ((j & 1) ? -s.yf[0][PL] : s.yf[0][PL]);
      for (int k = 1; k < PL; ++k) {
        const int m = (k * j) & (P2 - 1);
        acc = fmaf(s.yf[0][k], s.cs[m], acc);
        acc = fmaf(s.yf[1][k], s.sn[m], acc);
      }
      s.e64[t] = s.near[blk * PL + t] - acc * (2.0f / P2);
    }
    const float ekeep = t < PL ? s.ebuf[PL + t] : 0.f;
    __syncthreads();
    if (t < PL) {
      s.ebuf[t] = ekeep;
      s.ebuf[PL + t] = s.e64[t];
    }
    __syncthreads();
    s.ew[t] = s.ebuf[t] * win128(s, t);
    __syncthreads();

    // ---- 5. error spectrum + ScaleErrorSignal; windowed error spectrum ----
    for (int o = t; o < 2 * P1; o += THREADS) {
      const int k = o % P1;
      float re = 0.f, im = 0.f;
      if (o < P1) {     // fft of [zeros(64), e]
        for (int j = 0; j < PL; ++j) {
          const int m = ((j + PL) * k) & (P2 - 1);
          re = fmaf(s.e64[j], s.cs[m], re);
          im = fmaf(s.e64[j], s.sn[m], im);
        }
        if (k == 0 || k == PL) im = 0.f;
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
      } else {
        for (int j = 0; j < P2; ++j) {
          const int m = (j * k) & (P2 - 1);
          re = fmaf(s.ew[j], s.cs[m], re);
          im = fmaf(s.ew[j], s.sn[m], im);
        }
        if (k == 0 || k == PL) im = 0.f;
        s.efw[0][k] = re;
        s.efw[1][k] = im;
      }
    }
    __syncthreads();

    // ---- 6. FilterAdaptation: gradient spectrum per partition ----
    for (int idx = t; idx < NP * P1; idx += THREADS) {
      const int i = idx / P1, k = idx % P1;
      const int p = (head + i) % NP;
      const float xr = s.xf[0][p][k], xi = s.xf[1][p][k];
      const float er = s.ef[0][k], ei = s.ef[1][k];
      s.grad[0][i][k] = xr * er + xi * ei;
      s.grad[1][i][k] = xr * ei - xi * er;
    }
    __syncthreads();
    // hop 1: spectrum -> first 64 samples of the scaled inverse
    for (int idx = t; idx < NP * PL; idx += THREADS) {
      const int i = idx / PL, j = idx % PL;
      float acc = 0.5f * s.grad[0][i][0] +
                  0.5f * ((j & 1) ? -s.grad[0][i][PL] : s.grad[0][i][PL]);
      for (int k = 1; k < PL; ++k) {
        const int m = (k * j) & (P2 - 1);
        acc = fmaf(s.grad[0][i][k], s.cs[m], acc);
        acc = fmaf(s.grad[1][i][k], s.sn[m], acc);
      }
      s.h64[i][j] = acc * (2.0f / P2);
    }
    __syncthreads();
    // hop 2: the 64-sample signal (upper half zero) -> spectrum, added
    for (int idx = t; idx < NP * P1; idx += THREADS) {
      const int i = idx / P1, k = idx % P1;
      float re = 0.f, im = 0.f;
      for (int j = 0; j < PL; ++j) {
        const int m = (j * k) & (P2 - 1);
        re = fmaf(s.h64[i][j], s.cs[m], re);
        im = fmaf(s.h64[i][j], s.sn[m], im);
      }
      s.wf[0][i][k] += re;
      if (k != 0 && k != PL) s.wf[1][i][k] += im;
    }
    __syncthreads();

    // ---- 7. NonLinearProcessing ----
    if (t < NP) {     // partition energies of the updated filter
      float acc = 0.f;
      for (int k = 0; k < P1; ++k)
        acc += s.wf[0][t][k] * s.wf[0][t][k] + s.wf[1][t][k] * s.wf[1][t][k];
      s.en[t] = acc;
    }
    __syncthreads();
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

    if (t == 0) {     // the per-stream decision logic, serial
      Scalars& c = s.sc;
      float sd_sum = 0.f, se_sum = 0.f;
      for (int k = 0; k < P1; ++k) {
        sd_sum += s.vecs[V_SD][k];
        se_sum += s.vecs[V_SE][k];
      }
      c.diverge = ((c.diverge != 0 ? 1.05f * se_sum : se_sum) > sd_sum) ? 1 : 0;
      c.reset = se_sum > 19.95f * sd_sum;
      c.delay_idx = didx;

      float sum_xd = 0.f, sum_de = 0.f, v[kPrefBand];
      for (int j = 0; j < kPrefBand; ++j) {
        const int k = kMinPref + j;
        sum_xd += s.coh_xd[k];
        sum_de += s.coh_de[k];
        v[j] = fminf(s.coh_de[k], 1.0f - s.coh_xd[k]);
      }
      const float h_xd_avg = 1.0f - sum_xd * kInvPb;
      const float h_de_avg = sum_de * kInvPb;
      float xd_min = (h_xd_avg < 0.75f && h_xd_avg < c.xd_avg_min) ? h_xd_avg : c.xd_avg_min;
      if (h_de_avg > 0.98f && h_xd_avg > 0.9f)
        c.st_near = 1;
      else if (h_de_avg < 0.95f || h_xd_avg < 0.8f)
        c.st_near = 0;

      // rank selection; ties go to the lower index
      float v_q75 = 0.f, v_q50 = 0.f;
      for (int i = 0; i < kPrefBand; ++i) {
        int rank = 0;
        for (int j = 0; j < kPrefBand; ++j)
          rank += (v[j] < v[i]) || (v[j] == v[i] && j < i);
        if (rank == kQ75) v_q75 = v[i];
        if (rank == kQ50) v_q50 = v[i];
      }
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
        const float r = static_cast<float>(a.rand[blk * P1 + t]) * (1.0f / 32768.0f);
        const float ang = 6.28318530717959f * r;
        const float noise = sqrtf(fmaxf(s.noise_pow[t], 0.f));
        const float cnr = t == 0 ? 0.f : noise * cosf(ang);
        const float cni = (t == 0 || t == PL) ? 0.f : -(noise * sinf(ang));
        const float lam2 = sqrtf(fmaxf(1.0f - h_nl * h_nl, 0.0f));
        s.efw[0][t] = efr + lam2 * cnr;
        s.efw[1][t] = efi + lam2 * cni;
      }
      if (c.reset)
        for (int i = t; i < 2 * NP * P1; i += THREADS) (&s.wf[0][0][0])[i] = 0.f;
    }
    __syncthreads();

    // ---- 9. output inverse fft + overlap-add ----
    {
      const int j = t;
      float acc = 0.5f * s.efw[0][0] + 0.5f * ((j & 1) ? -s.efw[0][PL] : s.efw[0][PL]);
      for (int k = 1; k < PL; ++k) {
        const int m = (k * j) & (P2 - 1);
        acc = fmaf(s.efw[0][k], s.cs[m], acc);
        acc = fmaf(-s.efw[1][k], s.sn[m], acc);
      }
      s.t128[j] = acc * (2.0f / P2);
    }
    __syncthreads();
    if (t < PL) {
      const float first = s.t128[t] * s.win[t] + s.obuf[t];
      s.obuf[t] = s.t128[PL + t] * s.win[PL - t];
      s.stream[blk * PL + t] = fminf(fmaxf(first, -32768.0f), 32767.0f);
    }
    __syncthreads();
  }

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
