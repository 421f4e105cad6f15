// One daemon package of the AGC (webrtc's legacy digital AGC, adaptive
// digital mode) per stream, for every stream of the batch, in one launch.
//
// Replaces no TPU kernel: wmix_tpu's AGC (wmix_tpu/dsp/agc.py) is plain
// jnp.  This kernel was added because the port's eager form, dsp/agc.py
// `process_pkg_body`, is a scalar program per stream written as Python
// loops over [B] tensors: about 9,000 launches of tiny elementwise kernels
// a 20 ms, 16 kHz package, and one device read a subpackage for the
// limiter's loop condition.  The host's launches, not the device, bounded
// it.  It computes the same function bit for bit: the truncating downmix
// (`intops.downmix`), then per 10 ms subpackage (5 ms above 16 kHz)
// `process_digital`: `_process_vad` (the pair average at 160 samples, the
// allpass decimator, the high-pass energy, the leading-zeros cascade,
// `_spl_sqrt`), the capacitors and the gain-table interpolation, the gate,
// the overload limiter, the 1 ms-early minimum and the gain ramp with the
// first subframe's saturation; the result duplicated to every channel.
//
// What bounds it.  A launch moves the package in and out (5.2 MB each way
// at 4096 streams of 320 int32 samples) and the 21-word state in and out
// (0.35 MB each way): about 11 MB, 3 us at the H100's 3.35 TB/s.  The
// arithmetic is a serial chain per stream: the decimator's and the
// high-pass's recursions carry from sample to sample, the capacitors from
// subframe to subframe, a few thousand dependent integer operations a
// package, so a stream's latency (tens of us) bounds the launch, not the
// card's throughput.
//
// Design.  One thread per stream walks its whole package in order with
// every state leaf in registers.  Blocks hold few streams (32 at most),
// so 4096 streams make 128 blocks and spread over the SMs, one chain per
// SM.  A block stages its rows of the package in shared memory with
// coalesced loads (downmixing on the way in), each row padded to an odd
// length so that the threads' walks, one row each, fall on distinct
// banks; the output leaves the same way, duplicated to every channel.
// The 32-entry gain table sits in shared memory.  The limiter runs per
// stream and subframe until that subframe is under its limit: a row's
// shrink depends only on that row, so this equals the eager form's
// batch-wide loop, and no flag comes back to the host.
//
// Everything is integer with C's semantics, as the eager form keeps them
// on int32 tensors: wraparound (add and multiply in uint32, then cast),
// arithmetic right shifts (nvcc shifts a signed value arithmetically),
// truncating division, the decimator's 64-bit-safe low-half product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STREAMS = 32;   // streams (threads) a block
constexpr int NSCALAR = 13;       // the AgcState leaves before down_state
constexpr int NDOWN = 8;          // down_state's width

// AgcState's scalar leaves, in field order
enum { CAP_SLOW, CAP_FAST, GAIN, GATE_PREV, HP, LOG_RATIO, MEAN_LT, VAR_LT,
       STD_LT, MEAN_ST, VAR_ST, STD_ST, COUNTER };

// Pointer order: dsp/agc.py `_kernel_pkg`.
struct Args {
  const int32_t* in;               // [B, frames * chn], interleaved
  const int32_t* table;            // [32], the gain table in Q16
  const int32_t* leaf[NSCALAR];    // [B] each
  const int32_t* down;             // [B, 8]
  int32_t* out;                    // [B, frames * chn]
  int32_t* state;                  // 13 x [B], then [B, 8]
};
constexpr int kNumPtrs = sizeof(Args) / sizeof(void*);

struct State {
  int32_t v[NSCALAR];
  int32_t down[NDOWN];
};

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
__device__ __forceinline__ int32_t w16(int32_t a) {    // intops.wrap16
  return static_cast<int16_t>(a);
}
__device__ __forceinline__ int32_t sat16(int32_t a) {  // intops.sat_w16
  return min(max(a, -32768), 32767);
}
// intops.div_trunc: INT32_MIN / -1 wraps to INT32_MIN
__device__ __forceinline__ int32_t div_trunc(int32_t n, int32_t d) {
  return d == -1 ? wsub(0, n) : n / d;
}
// WebRtcSpl_NormW32: redundant sign bits; 0 for 0
__device__ __forceinline__ int norm_w32(int32_t a) {
  return a == 0 ? 0 : __clz(a < 0 ? ~a : a) - 1;
}
// leading zeros of the uint32 pattern, 31 for 0 (the eager form's
// `where(cur == 0, 31, norm_u32(cur))` and `_process_vad`'s cascade)
__device__ __forceinline__ int zeros31(int32_t a) {
  return a == 0 ? 31 : __clz(a);
}

// AGC_SCALEDIFF32
__device__ __forceinline__ int32_t scalediff32(int32_t a, int32_t b,
                                               int32_t c) {
  return wadd(wadd(c, wmul(b >> 16, a)), wmul(b & 0xFFFF, a) >> 16);
}
// AGC_MUL32
__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return wadd(wmul(b >> 13, a), wmul(b & 0x1FFF, a) >> 13);
}
// WEBRTC_SPL_SCALEDIFF32 (`_mul_accum`): the low-half product in uint32
// (below 2**32 for 0 <= a < 65536) with a logical shift
__device__ __forceinline__ int32_t mul_accum(uint32_t a, int32_t b,
                                             int32_t c) {
  const int32_t lo = static_cast<int32_t>(
      (static_cast<uint32_t>(b & 0xFFFF) * a) >> 16);
  return wadd(wadd(c, wmul(b >> 16, static_cast<int32_t>(a))), lo);
}

// WebRtcSpl_SqrtLocal (`_sqrt_local`)
__device__ __forceinline__ int32_t sqrt_local(int32_t in) {
  int32_t B = div_trunc(in, 2);
  B = wsub(B, 0x40000000);
  const int32_t x_half = w16(B >> 16);
  B = wadd(B, 0x40000000);
  B = wadd(B, 0x40000000);
  const int32_t x2 = wmul(wmul(x_half, x_half), 2);
  int32_t A = wsub(0, x2);
  B = wadd(B, A >> 1);
  A = A >> 16;
  A = wmul(wmul(A, A), 2);
  int32_t t16 = w16(A >> 16);
  B = wadd(B, wmul(wmul(-20480, t16), 2));
  A = wmul(wmul(x_half, t16), 2);
  t16 = w16(A >> 16);
  B = wadd(B, wmul(wmul(28672, t16), 2));
  t16 = w16(x2 >> 16);
  A = wmul(wmul(x_half, t16), 2);
  B = wadd(B, A >> 1);
  return wadd(B, 32768);
}

// WebRtcSpl_Sqrt (`_spl_sqrt`)
__device__ __forceinline__ int32_t spl_sqrt(int32_t value) {
  if (value == 0) return 0;
  const int sh = norm_w32(value);
  int32_t An = shl(value, sh);
  An = An < 0x7FFFFFFF - 32767 ? wadd(An, 32768) : 0x7FFFFFFF;
  const int32_t x_norm = w16(An >> 16);
  const int nshift = sh / 2;
  int32_t A2 = shl(x_norm, 16);
  A2 = A2 < 0 ? wsub(0, A2) : A2;
  const int32_t A3 = sqrt_local(A2);
  int32_t res;
  if (2 * nshift == sh) {
    const int32_t t16 = w16(A3 >> 16);
    res = wadd(wmul(wmul(23170, t16), 2), 32768);
    res = (res & 0x7FFF0000) >> 15;
  } else {
    res = A3 >> 16;
  }
  return (res & 0x0000FFFF) >> nshift;
}

// ------------------------------------------------- one subpackage

// `_process_vad` over the subpackage x[10 L]: the pair average (L = 16),
// the decimator to 40 samples and the high-pass energy fused in one pass,
// then the statistics.  Updates the VAD's leaves of s.
template <int L>
__device__ __forceinline__ void process_vad(State& s, const int32_t* x) {
  constexpr uint32_t A1_0 = 3284, A1_1 = 24441, A1_2 = 49528;
  constexpr uint32_t A2_0 = 12199, A2_1 = 37471, A2_2 = 60255;
  int32_t s0 = s.down[0], s1 = s.down[1], s2 = s.down[2], s3 = s.down[3];
  int32_t s4 = s.down[4], s5 = s.down[5], s6 = s.down[6], s7 = s.down[7];
  int32_t hp = s.v[HP], nrg = 0;
#pragma unroll 4
  for (int p = 0; p < 40; ++p) {
    int32_t ev, od;
    if (L == 16) {
      ev = wadd(x[4 * p], x[4 * p + 1]) >> 1;
      od = wadd(x[4 * p + 2], x[4 * p + 3]) >> 1;
    } else {
      ev = x[2 * p];
      od = x[2 * p + 1];
    }
    int32_t in32 = shl(ev, 10);
    int32_t tmp1 = mul_accum(A2_0, wsub(in32, s1), s0);
    s0 = in32;
    int32_t tmp2 = mul_accum(A2_1, wsub(tmp1, s2), s1);
    s1 = tmp1;
    s3 = mul_accum(A2_2, wsub(tmp2, s3), s2);
    s2 = tmp2;
    in32 = shl(od, 10);
    tmp1 = mul_accum(A1_0, wsub(in32, s5), s4);
    s4 = in32;
    tmp2 = mul_accum(A1_1, wsub(tmp1, s6), s5);
    s5 = tmp1;
    s7 = mul_accum(A1_2, wsub(tmp2, s7), s6);
    s6 = tmp2;
    const int32_t b = sat16(wadd(wadd(s3, s7), 1024) >> 11);
    const int32_t o = wadd(b, hp);
    hp = w16(wsub(wmul(600, o) >> 10, b));
    nrg = wadd(nrg, wmul(o, o) >> 6);
  }
  s.down[0] = s0; s.down[1] = s1; s.down[2] = s2; s.down[3] = s3;
  s.down[4] = s4; s.down[5] = s5; s.down[6] = s6; s.down[7] = s7;
  s.v[HP] = hp;

  const int32_t dB = w16(shl(15 - zeros31(nrg), 11));
  const int32_t counter = wadd(s.v[COUNTER], s.v[COUNTER] < 250 ? 1 : 0);
  const int32_t dB2 = wmul(dB, dB) >> 12;

  const int32_t mean_st = w16(wadd(wmul(s.v[MEAN_ST], 15), dB) >> 4);
  const int32_t var_st = div_trunc(wadd(dB2, wmul(s.v[VAR_ST], 15)), 16);
  const int32_t std_st =
      w16(spl_sqrt(wsub(shl(var_st, 12), wmul(mean_st, mean_st))));

  const int32_t cnt1 = sat16(wadd(counter, 1));
  const int32_t mean_lt =
      w16(div_trunc(wadd(wmul(s.v[MEAN_LT], counter), dB), cnt1));
  const int32_t var_lt =
      div_trunc(wadd(dB2, wmul(s.v[VAR_LT], counter)), cnt1);
  const int32_t std_lt =
      w16(spl_sqrt(wsub(shl(var_lt, 12), wmul(mean_lt, mean_lt))));

  int32_t tmp = wmul(3 << 12, w16(wsub(dB, mean_lt)));
  tmp = std_lt == 0 ? 0x7FFFFFFF : div_trunc(tmp, std_lt);
  tmp = wadd(tmp, wmul(s.v[LOG_RATIO], 13 << 12) >> 10);

  s.v[COUNTER] = counter;
  s.v[MEAN_ST] = mean_st;
  s.v[VAR_ST] = var_st;
  s.v[STD_ST] = std_st;
  s.v[MEAN_LT] = mean_lt;
  s.v[VAR_LT] = var_lt;
  s.v[STD_LT] = std_lt;
  s.v[LOG_RATIO] = min(max(w16(tmp >> 6), -2048), 2048);
}

// `process_digital` on the subpackage x[10 L], in place.
template <int L>
__device__ __forceinline__ void process_digital(State& s, int32_t* x,
                                                const int32_t* table) {
  constexpr int SH = L == 8 ? 1 : 0;      // 4 - L2
  process_vad<L>(s, x);

  const int32_t lr = s.v[LOG_RATIO];
  int32_t decay = lr > 1024 ? -65
                  : lr < 0  ? 0
                            : w16(wmul(wsub(0, lr), 65) >> 10);
  const int32_t std_lt = s.v[STD_LT];
  decay = std_lt < 4000 ? 0
          : std_lt < 8096 ? w16(wmul(wsub(std_lt, 4000), decay) >> 12)
                          : decay;

  int32_t env[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    int32_t e = 0;
#pragma unroll
    for (int n = 0; n < L; ++n) e = max(e, wmul(x[k * L + n], x[k * L + n]));
    env[k] = e;
  }

  // capacitors and the per-subframe gain
  int32_t fast = s.v[CAP_FAST], slow = s.v[CAP_SLOW];
  int32_t gains[11];
  gains[0] = s.v[GAIN];
  int zeros = 0;
  int32_t frac = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const int32_t e = env[k];
    fast = max(scalediff32(-1000, fast, fast), e);
    slow = e > slow ? scalediff32(500, wsub(e, slow), slow)
                    : scalediff32(decay, slow, slow);
    const int32_t cur = max(fast, slow);
    zeros = zeros31(cur);
    frac = (shl(cur, zeros) & 0x7FFFFFFF) >> 19;
    const int32_t g_hi = table[zeros > 0 ? zeros - 1 : 0];
    const int32_t g_lo = table[zeros];
    gains[k + 1] = wadd(g_lo, wmul(wsub(g_hi, g_lo), frac) >> 12);
  }

  // the gate, from the last subframe's zeros and fraction
  const int32_t zeros_g = wsub(shl(zeros, 9), frac >> 3);
  const int zf = zeros31(fast);
  const int32_t zeros_fast =
      wsub(shl(zf, 9), (shl(fast, zf) & 0x7FFFFFFF) >> 22);
  int32_t gate = w16(wsub(wsub(wadd(1000, zeros_fast), zeros_g),
                          s.v[STD_ST]));
  const int32_t gate_prev =
      gate < 0 ? 0 : w16(wadd(gate, wmul(s.v[GATE_PREV], 7)) >> 3);
  gate = gate < 0 ? gate : gate_prev;
  if (gate > 0) {
    const int32_t adj = 178 + (gate < 2500 ? (2500 - gate) >> 5 : 0);
    const int32_t g0 = table[0];
#pragma unroll
    for (int k = 1; k <= 10; ++k) {
      const int32_t dg = wsub(gains[k], g0);
      gains[k] = wadd(g0, dg > 8388608 ? wmul(dg >> 8, adj)
                                       : wmul(dg, adj) >> 8);
    }
  }

  // the overload limiter, per subframe until it is under its limit (z
  // and the limit from the incoming gain).  The gain shrinks to 0, where
  // it stays: a subframe still over the limit there would keep the eager
  // loop running for ever, and here ends the loop.
#pragma unroll
  for (int k = 1; k <= 10; ++k) {
    int32_t g = gains[k];
    const int z = g > 47453132 ? 16 - norm_w32(g) : 10;
    const int lim_sh = 2 * (11 - z);
    const int32_t lim = lim_sh >= 0 ? 32767 << lim_sh : 32767 >> -lim_sh;
    const int32_t e12 = (env[k - 1] >> 12) + 1;
    for (;;) {
      const int32_t g32 = wadd(g >> z, 1);
      if (mul32(e12, wmul(g32, g32)) <= lim) break;
      const int32_t shrunk = g > 8388607 ? wmul(g / 256, 253)
                                         : wmul(g, 253) / 256;
      if (shrunk == g) break;
      g = shrunk;
    }
    gains[k] = g;
  }

  // gain reductions 1 ms early
#pragma unroll
  for (int k = 1; k < 10; ++k) gains[k] = min(gains[k], gains[k + 1]);

  // the ramp: the first subframe with saturation checks
  {
    const int32_t d = shl(wsub(gains[1], gains[0]), SH);
    const int32_t g_start = shl(gains[0], 4);
#pragma unroll
    for (int n = 0; n < L; ++n) {
      const int32_t g32 = wadd(g_start, wmul(n, d));
      const int32_t xv = x[n];
      const int32_t t = wmul(xv, wadd(g32, 127) >> 7) >> 16;
      x[n] = t > 4095    ? 32767
             : t < -4096 ? -32768
                         : w16(wmul(xv, g32 >> 4) >> 16);
    }
  }
#pragma unroll
  for (int k = 1; k < 10; ++k) {
    const int32_t d = shl(wsub(gains[k + 1], gains[k]), SH);
    const int32_t g_start = shl(gains[k], 4);
#pragma unroll
    for (int n = 0; n < L; ++n) {
      const int32_t g32 = wadd(g_start, wmul(n, d));
      x[k * L + n] = w16(wmul(x[k * L + n], g32 >> 4) >> 16);
    }
  }

  s.v[CAP_FAST] = fast;
  s.v[CAP_SLOW] = slow;
  s.v[GAIN] = gains[10];
  s.v[GATE_PREV] = gate < 0 ? 0 : gate_prev;
}

// ------------------------------------------------------ the kernel

// Dynamic shared memory: blockDim.x rows of `stride` words (the mono
// package, then its output in place), then the 32-entry table.
template <int L>
__global__ void __launch_bounds__(MAX_STREAMS)
agc_package_kernel(Args a, int batch, int frames, int chn, int stride) {
  extern __shared__ int32_t smem[];
  const int streams = blockDim.x;
  int32_t* table = smem + streams * stride;
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * streams;
  const int rows = min(streams, batch - b0);
  const int row_len = frames * chn;

  for (int i = t; i < 32; i += streams) table[i] = a.table[i];
  // coalesced staging: the block reads one row at a time, the truncating
  // downmix (the channel sum in 64 bits, as torch sums int32) on the way
  for (int r = 0; r < rows; ++r) {
    const int32_t* src = a.in + static_cast<size_t>(b0 + r) * row_len;
    int32_t* dst = smem + r * stride;
    if (chn == 1) {
      for (int m = t; m < frames; m += streams) dst[m] = src[m];
    } else {
      for (int m = t; m < frames; m += streams)
        dst[m] = static_cast<int32_t>(
            (static_cast<int64_t>(src[2 * m]) + src[2 * m + 1]) / 2);
    }
  }
  __syncthreads();

  if (t < rows) {
    const int b = b0 + t;
    State s;
#pragma unroll
    for (int i = 0; i < NSCALAR; ++i) s.v[i] = a.leaf[i][b];
#pragma unroll
    for (int j = 0; j < NDOWN; ++j) s.down[j] = a.down[b * NDOWN + j];
    int32_t* x = smem + t * stride;
    for (int off = 0; off < frames; off += 10 * L)
      process_digital<L>(s, x + off, table);
#pragma unroll
    for (int i = 0; i < NSCALAR; ++i) a.state[i * batch + b] = s.v[i];
    int32_t* down = a.state + NSCALAR * batch;
#pragma unroll
    for (int j = 0; j < NDOWN; ++j) down[b * NDOWN + j] = s.down[j];
  }
  __syncthreads();

  for (int r = 0; r < rows; ++r) {
    const int32_t* src = smem + r * stride;
    int32_t* dst = a.out + static_cast<size_t>(b0 + r) * row_len;
    for (int j = t; j < row_len; j += streams) dst[j] = src[j / chn];
  }
}

constexpr size_t kMaxSmem = 232448;     // a block's dynamic shared memory

}  // namespace

// Plain C entry for ctypes: ptrs holds the kNumPtrs device pointers in
// `Args` order, all on CUDA device `device`, every tensor contiguous, and
// `stream` is a stream of that device.  `sub_len` is the subpackage (80
// at 8 kHz, 160 at 16 and 32 kHz) and must divide `frames`, the package's
// samples per channel (a block's rows of it must fit in its 227 KB of
// shared memory: up to 1,814 samples; a 20 ms package at 32 kHz has 640);
// chn is 1 or 2.  The launch makes `device` current,
// launches on `stream`, restores the device that was current before and
// returns the first error (the launch's cudaGetLastError() included).
extern "C" int wmix_agc_launch(void* const* ptrs, int n_ptrs, int batch,
                               int frames, int chn, int sub_len, int device,
                               void* stream) {
  if (n_ptrs != kNumPtrs || batch < 0 || (chn != 1 && chn != 2) ||
      (sub_len != 80 && sub_len != 160) || frames <= 0 ||
      frames % sub_len != 0 || device < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Args a;
  void** dst = reinterpret_cast<void**>(&a);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];

  const int stride = frames + 1 + (frames & 1);        // odd: no conflicts
  const int streams = batch < MAX_STREAMS ? batch : MAX_STREAMS;
  const size_t smem =
      (static_cast<size_t>(streams) * stride + 32) * sizeof(int32_t);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + streams - 1) / streams;

  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // above 48 KB a block's dynamic shared memory has to be asked for (a
  // 20 ms package at 32 kHz); below it the launch needs no host call
  // besides itself
  const bool big = smem > 48 * 1024;
  if (sub_len == 80) {
    if (big)
      err = cudaFuncSetAttribute(agc_package_kernel<8>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      agc_package_kernel<8><<<blocks, streams, smem, st>>>(a, batch, frames,
                                                           chn, stride);
  } else {
    if (big)
      err = cudaFuncSetAttribute(agc_package_kernel<16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      agc_package_kernel<16><<<blocks, streams, smem, st>>>(a, batch, frames,
                                                            chn, stride);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* wmix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
