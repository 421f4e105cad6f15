"""The reference's display-path FFT (math/fft.{h,c}), bit-exact.

This is the first-party radix-2 FFT wired to the `WMT_FFT` visualization
message (state in WMix_Struct, src/wmixConf.h:221-227); it is not on the
streaming DSP path, so it lives here as a host/numpy kernel with the C
file's exact numerics:

- butterfly twiddles are evaluated in double via libm (math.cos/sin of
  2.0*3.1415926535897*p/N — note the truncated pi constant, fft.c:20),
- Tr/Ti are float: the products and their sum evaluate in double and
  round once on the float store (fft.c:120-121),
- the add/sub into the array is a float op; IFFT halves each result with
  an exact float /2 (fft.c:272-283),
- the amplitude curve squares/sums in float, then sqrt and the /(N/2)
  divide run in double before the float store (fft.c:143-145),
- the stages vectorize exactly because butterflies within a stage touch
  disjoint (r, r+B) pairs.

All public entry points mirror fft.c: FFT (fft.c:121-153), FFTR
(:156-249), IFFT (:252-310), IFFTR (:313-399), fft_stream (:413-424,
including its quirk of only ever refreshing the first 2*inLen slots of
the pool).
"""
from __future__ import annotations

import functools
import math

import numpy as np

F32 = np.float32
F64 = np.float64

FFT_PI = 3.1415926535897


@functools.lru_cache(maxsize=None)
def _twiddles(N: int):
    """cos/sin(2*FFT_PI*p/N) for p in [0, N) via libm (matches C)."""
    c = np.array([math.cos(2.0 * FFT_PI * p / N) for p in range(N)], F64)
    s = np.array([math.sin(2.0 * FFT_PI * p / N) for p in range(N)], F64)
    return c, s


@functools.lru_cache(maxsize=None)
def _reversal_perm(N: int, M: int) -> np.ndarray:
    """_reversal (fft.c:36-75): bit-reverse permutation via pair swaps."""
    idx = np.arange(N)
    for I in range(N):
        J = 0
        for k in range(int(M / 2 + 0.5)):
            m = 1 << k
            n = (1 << (M - 1)) >> k
            if I & n:
                J |= m
            if I & m:
                J |= n
        if I < J:
            idx[I], idx[J] = idx[J], idx[I]
    return idx


def _prep(in_real, in_imag, N):
    re = np.zeros(N, F32) if in_real is None else \
        np.asarray(in_real, F32).copy()
    im = np.zeros(N, F32) if in_imag is None else \
        np.asarray(in_imag, F32).copy()
    return re, im


def _stages(re, im, N, M, inverse: bool):
    """_FFT (fft.c:78-118) / _IFFT (:250-295), stage-vectorized."""
    c_all, s_all = _twiddles(N)
    for L in range(1, M + 1):
        B = 1 << (L - 1)
        k = 1 << (M - L)
        j = np.arange(B)
        i = np.arange(k)
        r = (j[:, None] + 2 * B * i[None, :]).ravel()
        p = np.repeat(j * k, k)
        c = c_all[p]
        s = s_all[p]
        aR = re[r + B].astype(F64)
        aI = im[r + B].astype(F64)
        if not inverse:
            Tr = (aR * c + aI * s).astype(F32)
            Ti = (aI * c - aR * s).astype(F32)
        else:
            Tr = (aR * c - aI * s).astype(F32)
            Ti = (aI * c + aR * s).astype(F32)
        hiR = (re[r] - Tr).astype(F32)
        hiI = (im[r] - Ti).astype(F32)
        loR = (re[r] + Tr).astype(F32)
        loI = (im[r] + Ti).astype(F32)
        if inverse:
            hiR = (hiR / F32(2)).astype(F32)
            hiI = (hiI / F32(2)).astype(F32)
            loR = (loR / F32(2)).astype(F32)
            loI = (loI / F32(2)).astype(F32)
        re[r + B] = hiR
        im[r + B] = hiI
        re[r] = loR
        im[r] = loI
    return re, im


def _af_pf(re, im, N, want_af, want_pf):
    af = pf = None
    if want_af:
        s = (re * re + im * im).astype(F32)
        af = (np.sqrt(s.astype(F64)) / F64(N // 2)).astype(F32)
    if want_pf:
        pf = np.array([math.atan2(float(b), float(a))
                       for a, b in zip(re.astype(F64), im.astype(F64))],
                      F64).astype(F32)
    return af, pf


def fft(in_real, in_imag=None, N=None, want_af=False, want_pf=False):
    """FFT (fft.c:121-153).  Returns (re, im, af, pf)."""
    N = N or len(in_real)
    M = int(math.log2(N))
    re, im = _prep(in_real, in_imag, N)
    perm = _reversal_perm(N, M)
    re, im = re[perm], im[perm]
    re, im = _stages(re, im, N, M, inverse=False)
    af, pf = _af_pf(re, im, N, want_af, want_pf)
    return re, im, af, pf


def ifft(in_real, in_imag=None, N=None):
    """IFFT (fft.c:252-310).  Returns (re, im)."""
    N = N or len(in_real)
    M = int(math.log2(N))
    re, im = _prep(in_real, in_imag, N)
    perm = _reversal_perm(N, M)
    re, im = re[perm], im[perm]
    re, im = _stages(re, im, N, M, inverse=True)
    return re, im


def _split_halves(re_in, N, M, inverse):
    """The shared N/2-point core + X1/X2 split of FFTR/IFFTR."""
    y_r = re_in[0::2].copy()
    y_i = re_in[1::2].copy()
    perm = _reversal_perm(N // 2, M - 1)
    y_r, y_i = y_r[perm], y_i[perm]
    y_r, y_i = _stages(y_r, y_i, N // 2, M - 1, inverse=inverse)

    h = N // 2
    x1R = np.empty(h, F32)
    x1I = np.empty(h, F32)
    x2R = np.empty(h, F32)
    x2I = np.empty(h, F32)
    x1R[0], x1I[0] = y_r[0], y_i[0]
    x2R[0], x2I[0] = y_i[0], -y_r[0]
    k = np.arange(1, h)
    x1R[1:] = ((y_r[k] + y_r[h - k]) / F32(2)).astype(F32)
    x1I[1:] = ((y_i[k] - y_i[h - k]) / F32(2)).astype(F32)
    x2R[1:] = ((y_i[k] + y_i[h - k]) / F32(2)).astype(F32)
    x2I[1:] = ((y_r[h - k] - y_r[k]) / F32(2)).astype(F32)
    return x1R, x1I, x2R, x2I


def fftr(in_real, in_imag=None, N=None, want_af=False, want_pf=False):
    """FFTR (fft.c:156-249): real-input FFT via the N/2 complex core."""
    N = N or len(in_real)
    M = int(math.log2(N))
    re_in, _ = _prep(in_real, in_imag, N)
    x1R, x1I, x2R, x2I = _split_halves(re_in, N, M, inverse=False)

    h = N // 2
    c_all, s_all = _twiddles(N)
    j = np.arange(h)
    Tr = (x2R.astype(F64) * c_all[j] + x2I.astype(F64) * s_all[j]) \
        .astype(F32)
    Ti = (x2I.astype(F64) * c_all[j] - x2R.astype(F64) * s_all[j]) \
        .astype(F32)
    xR = np.zeros(N, F32)
    xI = np.zeros(N, F32)
    xR[:h] = (x1R + Tr).astype(F32)
    xI[:h] = (x1I + Ti).astype(F32)
    xR[h] = F32(x1R[0]) - F32(x2R[0])
    xI[h] = F32(x1I[0]) - F32(x2I[0])
    xR[N - j[1:]] = xR[j[1:]]
    xI[N - j[1:]] = -xI[j[1:]]
    af, pf = _af_pf(xR, xI, N, want_af, want_pf)
    return xR, xI, af, pf


def ifftr(in_real, in_imag=None, N=None):
    """IFFTR (fft.c:313-399)."""
    N = N or len(in_real)
    M = int(math.log2(N))
    re_in, _ = _prep(in_real, in_imag, N)
    x1R, x1I, x2R, x2I = _split_halves(re_in, N, M, inverse=True)

    h = N // 2
    c_all, s_all = _twiddles(N)
    j = np.arange(h)
    Tr = (x2R.astype(F64) * c_all[j] - x2I.astype(F64) * s_all[j]) \
        .astype(F32)
    Ti = (x2I.astype(F64) * c_all[j] + x2R.astype(F64) * s_all[j]) \
        .astype(F32)
    re = np.zeros(N, F32)
    im = np.zeros(N, F32)
    re[:h] = ((x1R + Tr) / F32(2)).astype(F32)
    im[:h] = ((x1I + Ti) / F32(2)).astype(F32)
    re[h] = (F32(x1R[0]) - F32(x2R[0])) / F32(2)
    im[h] = (F32(x1I[0]) - F32(x2I[0])) / F32(2)
    re[N - j[1:]] = re[j[1:]]
    im[N - j[1:]] = -im[j[1:]]
    return re, im


def fft_stream(new_data, stream, want_pf=True):
    """fft_stream (fft.c:413-424): FIFO the new block into the pool, then
    FFT the pool.  Faithfully reproduces the reference's shift, which
    moves stream[inLen:2*inLen] down and refills [inLen:2*inLen] — slots
    beyond 2*inLen are never touched.  Mutates `stream`; returns
    (af, pf)."""
    in_len = len(new_data)
    st_len = len(stream)
    n_shift = min(in_len, st_len)
    stream[:n_shift] = stream[in_len:in_len + n_shift]
    lo = in_len
    hi = min(st_len, 2 * in_len)
    stream[lo:hi] = np.asarray(new_data, F32)[:hi - lo]
    _, _, af, pf = fft(stream, None, st_len, want_af=True, want_pf=want_pf)
    return af, pf
