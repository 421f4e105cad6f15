"""Real DFT in the Ooura packing: `torch.fft` in fast mode, the fft4g
butterflies in exact mode.

Port of `wmix_tpu/ops/rdft.py`.  The packing is Ooura's: a[0] = R[0],
a[1] = R[n/2], a[2k] = R[k], a[2k+1] = I[k] with I[k] = +sum_j a[j]
sin(2 pi j k / n), i.e. the negated numpy imaginary part; the inverse takes
that packing and returns the unscaled time signal (callers multiply by
2/n, as the C reference does).

Exact mode reproduces Takuya Ooura's split-radix real FFT
(webrtc/common_audio/fft4g.c, `WebRtc_rdft`) and the AEC's length-128
variant with shipped twiddle tables (aec_rdft.c) bit for bit:

  * bitrv2 is a permutation, precomputed as a gather index;
  * cft1st(n) is cftmdl(n, l=2) unrolled, so one generic stage serves;
  * every stage section touches disjoint index blocks, so a stage is:
    gather the 8 butterfly inputs per work item, compute the 8 outputs,
    concatenate in a canonical order, apply one precomputed inverse
    permutation;
  * rftfsub / rftbsub act on disjoint (j, n - j) pairs.

The twiddles are computed on the host in numpy float32 with the C
operation order (including wk3 = wk1 - 2*wk2i*wk1i and the trig tables'
double-precision cos/sin rounded to float).  Every butterfly is separate
float32 multiplies, adds and subtracts in the reference's order: no
`torch.fft`, no complex dtype, no matrix product, so each product is
rounded before it is added.  The transform runs on the last axis; leading
axes are batch.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from wbench.reference.dsp.floatops import is_exact

F32 = torch.float32
f32 = np.float32


# ------------------------------------------------------------ fast mode

def fast_rdft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward or inverse packed real DFT on the last axis."""
    n = x.shape[-1]
    x = x.to(F32)
    if not inverse:
        X = torch.fft.rfft(x, dim=-1)
        re = X.real
        im = -X.imag
        pairs = torch.stack([re[..., 1:n // 2], im[..., 1:n // 2]],
                            dim=-1).reshape(*x.shape[:-1], n - 2)
        return torch.cat([re[..., 0:1], re[..., n // 2:n // 2 + 1], pairs],
                         dim=-1)
    re = torch.cat([x[..., 0:1], x[..., 2::2], x[..., 1:2]], dim=-1)
    zero = torch.zeros_like(x[..., :1])
    im = torch.cat([zero, x[..., 3::2], zero], dim=-1)
    t = torch.fft.irfft(torch.complex(re, -im), n, dim=-1).to(F32)
    return t * (n / 2)


# ------------------------------------- host precomputation (numpy, C order)

def _bitrv2_perm(n: int) -> np.ndarray:
    """The permutation applied by bitrv2 (fft4g.c:693-791): returns perm
    such that new[i] = old[perm[i]]."""
    ip = [0] * (n // 2 + 2)
    a = list(range(n))  # identity "data": values are source indices

    ip[0] = 0
    l = n
    m = 1
    while (m << 3) < l:
        l >>= 1
        for j in range(m):
            ip[m + j] = ip[j] + l
        m <<= 1
    m2 = 2 * m

    def swap(j1, k1):
        a[j1], a[k1] = a[k1], a[j1]
        a[j1 + 1], a[k1 + 1] = a[k1 + 1], a[j1 + 1]

    if (m << 3) == l:
        for k in range(m):
            for j in range(k):
                j1 = 2 * j + ip[k]
                k1 = 2 * k + ip[j]
                swap(j1, k1)
                j1 += m2
                k1 += 2 * m2
                swap(j1, k1)
                j1 += m2
                k1 -= m2
                swap(j1, k1)
                j1 += m2
                k1 += 2 * m2
                swap(j1, k1)
            j1 = 2 * k + m2 + ip[k]
            k1 = j1 + m2
            swap(j1, k1)
    else:
        for k in range(1, m):
            for j in range(k):
                j1 = 2 * j + ip[k]
                k1 = 2 * k + ip[j]
                swap(j1, k1)
                j1 += m2
                k1 += m2
                swap(j1, k1)
    return np.array(a, np.int64)


def _makewt(nw: int) -> np.ndarray:
    """makewt (fft4g.c:642-668): float table, double trig, then bitrv2."""
    w = np.zeros(nw, f32)
    if nw > 2:
        nwh = nw >> 1
        delta = f32(f32(np.arctan(1.0)) / f32(nwh))
        w[0] = 1
        w[1] = 0
        w[nwh] = f32(np.cos(np.float64(f32(delta * nwh))))
        w[nwh + 1] = w[nwh]
        if nwh > 2:
            for j in range(2, nwh, 2):
                x = f32(np.cos(np.float64(f32(delta * j))))
                y = f32(np.sin(np.float64(f32(delta * j))))
                w[j] = x
                w[j + 1] = y
                w[nw - j] = y
                w[nw - j + 1] = x
            w = w[_bitrv2_perm(nw)]
    return w


def _makect(nc: int) -> np.ndarray:
    """makect (fft4g.c:671-687)."""
    c = np.zeros(nc, f32)
    if nc > 1:
        nch = nc >> 1
        delta = f32(f32(np.arctan(1.0)) / f32(nch))
        c[0] = f32(np.cos(np.float64(f32(delta * nch))))
        c[nch] = f32(f32(0.5) * c[0])
        for j in range(1, nch):
            c[j] = f32(f32(0.5) * f32(np.cos(np.float64(f32(delta * j)))))
            c[nc - j] = f32(f32(0.5) * f32(np.sin(np.float64(f32(delta * j)))))
    return c


def _cftmdl_spec(n: int, l: int, w: np.ndarray, wk3_first=None,
                 wk3_second=None):
    """Work spec for one cftmdl stage (fft4g.c:1107-1231; cft1st is the
    l == 2 case): per section, the base indices and twiddles.

    fft4g derives the third-harmonic twiddles as wk3 = wk1 - 2*wk2*wk1 in
    float; the AEC's length-128 variant ships them as tables with another
    last-ulp rounding (aec_rdft.c:52-66), given as wk3_first/wk3_second."""
    m = l << 2
    jA = np.arange(0, l, 2, np.int64)           # section A: no twiddle
    jB = np.arange(m, m + l, 2, np.int64)       # section B: wk1r = w[2]
    jC, tC = [], []
    jD, tD = [], []
    k1 = 0
    m2 = 2 * m
    for k in range(m2, n, m2):
        k1 += 2
        k2 = 2 * k1
        wk2r, wk2i = w[k1], w[k1 + 1]
        wk1r, wk1i = w[k2], w[k2 + 1]
        if wk3_first is not None:
            wk3r, wk3i = wk3_first[k1], wk3_first[k1 + 1]
        else:
            wk3r = f32(wk1r - f32(f32(f32(2) * wk2i) * wk1i))
            wk3i = f32(f32(f32(f32(2) * wk2i) * wk1r) - wk1i)
        for j in range(k, k + l, 2):
            jC.append(j)
            tC.append((wk1r, wk1i, wk2r, wk2i, wk3r, wk3i))
        wk1r, wk1i = w[k2 + 2], w[k2 + 3]
        if wk3_second is not None:
            wk3r, wk3i = wk3_second[k1], wk3_second[k1 + 1]
        else:
            wk3r = f32(wk1r - f32(f32(f32(2) * wk2r) * wk1i))
            wk3i = f32(f32(f32(f32(2) * wk2r) * wk1r) - wk1i)
        for j in range(k + m, k + m + l, 2):
            jD.append(j)
            tD.append((wk1r, wk1i, wk2r, wk2i, wk3r, wk3i))
    return (jA, jB,
            np.array(jC, np.int64), np.array(tC, f32).reshape(-1, 6),
            np.array(jD, np.int64), np.array(tD, f32).reshape(-1, 6))


def _section_targets(j: np.ndarray, l: int) -> np.ndarray:
    """Target indices in the value order of the `_vals_*` helpers."""
    cols = [j, j + 1, j + l, j + l + 1, j + 2 * l, j + 2 * l + 1,
            j + 3 * l, j + 3 * l + 1]
    return np.stack(cols, axis=1).reshape(-1)


def _stage_inv_perm(n: int, l: int, spec) -> np.ndarray:
    """Inverse permutation putting a cftmdl stage's concatenated section
    outputs back into index order."""
    jA, jB, jC, _, jD, _ = spec
    tgt = np.concatenate([_section_targets(j, l)
                          for j in (jA, jB, jC, jD) if len(j)])
    inv = np.empty(n, np.int64)
    inv[tgt] = np.arange(n)
    return inv


def _final_inv_perm(n: int, l: int, radix4: bool) -> np.ndarray:
    j = np.arange(0, l, 2, np.int64)
    if radix4:
        tgt = _section_targets(j, l)
    else:
        tgt = np.stack([j, j + 1, j + l, j + l + 1], axis=1).reshape(-1)
    inv = np.empty(n, np.int64)
    inv[tgt] = np.arange(n)
    return inv


def _finish_plan(n, w, c_half, ks, stage_ls, stages, l_final):
    """The stage specs with their inverse permutations, the final radix
    section and the rftfsub/rftbsub twiddles (fft4g.c:1239-1246)."""
    radix4 = (l_final << 2) == n
    m = n >> 1
    jR = np.arange(2, m, 2, np.int64)
    kk = ks * np.arange(1, len(jR) + 1)
    nc = len(c_half)
    return dict(
        n=n, w2=float(w[2]), perm=_bitrv2_perm(n),
        stages=[(l, spec, _stage_inv_perm(n, l, spec))
                for l, spec in zip(stage_ls, stages)],
        final_radix4=radix4, l_final=l_final,
        jF=np.arange(0, l_final, 2, np.int64),
        final_inv=_final_inv_perm(n, l_final, radix4),
        jR=jR, kR=n - jR,
        wkr=(f32(0.5) - c_half[nc - kk]).astype(f32),
        wki=c_half[kk].astype(f32))


@functools.lru_cache(maxsize=None)
def _plan(n: int):
    """All host-side constants of WebRtc_rdft for size n."""
    nw = nc = n >> 2
    w = _makewt(nw)
    c = _makect(nc)
    # cftfsub stage schedule: l = 2 (cft1st), then l *= 4 while (l<<2) < n
    stage_ls, l = [], 2
    if n > 8:
        stage_ls.append(2)
        l = 8
        while (l << 2) < n:
            stage_ls.append(l)
            l <<= 2
    stages = [_cftmdl_spec(n, sl, w) for sl in stage_ls]
    return _finish_plan(n, w, c, 2 * nc // (n >> 1), stage_ls, stages, l)


@functools.lru_cache(maxsize=None)
def _plan_aec128():
    """The AEC's length-128 variant (aec_rdft.c): the same structure with
    shipped twiddle tables."""
    from wbench.reference.ops._aec_rdft_tables import (RDFT_W, WK3_FIRST,
                                                     WK3_SECOND)
    n = 128
    w = RDFT_W[:32]
    stages = [_cftmdl_spec(n, 2, w, WK3_FIRST, WK3_SECOND),
              _cftmdl_spec(n, 8, w, WK3_FIRST, WK3_SECOND)]
    return _finish_plan(n, w, RDFT_W[32:], 1, [2, 8], stages, 32)


def _to_device(obj, device):
    """The plan with its numpy arrays as tensors on `device`."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj).to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


@functools.lru_cache(maxsize=16)
def _plan_on(kind, device: str):
    """Plan `kind` (a size, or "aec128") on a device."""
    plan = _plan_aec128() if kind == "aec128" else _plan(kind)
    return _to_device(plan, device)


# ------------------------------- butterflies on tensors [..., n] (exact mode)

def _inputs(x, j, l):
    j1, j2, j3 = j + l, j + 2 * l, j + 3 * l
    ar, ai = x[..., j], x[..., j + 1]
    br, bi = x[..., j1], x[..., j1 + 1]
    cr, ci = x[..., j2], x[..., j2 + 1]
    dr, di = x[..., j3], x[..., j3 + 1]
    return (ar + br, ai + bi, ar - br, ai - bi,
            cr + dr, ci + di, cr - dr, ci - di)


def _vals_v0(x, j, l):
    """No-twiddle butterfly (cftmdl section A and the final radix-4,
    fft4g.c:1114-1134, 916-937): outputs for [j, j+1, j1, j1+1, j2, ...]."""
    x0r, x0i, x1r, x1i, x2r, x2i, x3r, x3i = _inputs(x, j, l)
    return [x0r + x2r, x0i + x2i,
            x1r - x3i, x1i + x3r,
            x0r - x2r, x0i - x2i,
            x1r + x3i, x1i - x3r]


def _vals_v1(x, j, l, w2: float):
    """cftmdl section B (fft4g.c:1136-1160): wk1r = w[2] twiddle."""
    x0r, x0i, x1r, x1i, x2r, x2i, x3r, x3i = _inputs(x, j, l)
    y0r = x1r - x3i
    y0i = x1i + x3r
    z0r = x3i + x1r
    z0i = x3r - x1i
    return [x0r + x2r, x0i + x2i,
            w2 * (y0r - y0i), w2 * (y0r + y0i),
            x2i - x0i, x0r - x2r,
            w2 * (z0i - z0r), w2 * (z0i + z0r)]


def _vals_v23(x, j, l, tw, second: bool):
    """cftmdl k-loop butterfly (fft4g.c:1172-1229)."""
    wk1r, wk1i, wk2r, wk2i, wk3r, wk3i = (tw[:, i] for i in range(6))
    x0r, x0i, x1r, x1i, x2r, x2i, x3r, x3i = _inputs(x, j, l)
    u0r = x0r - x2r
    u0i = x0i - x2i
    if second:
        o2r = (-wk2i) * u0r - wk2r * u0i
        o2i = (-wk2i) * u0i + wk2r * u0r
    else:
        o2r = wk2r * u0r - wk2i * u0i
        o2i = wk2r * u0i + wk2i * u0r
    v0r = x1r - x3i
    v0i = x1i + x3r
    t0r = x1r + x3i
    t0i = x1i - x3r
    return [x0r + x2r, x0i + x2i,
            wk1r * v0r - wk1i * v0i, wk1r * v0i + wk1i * v0r,
            o2r, o2i,
            wk3r * t0r - wk3i * t0i, wk3r * t0i + wk3i * t0r]


def _stack_vals(vals):
    return torch.stack(vals, dim=-1).flatten(-2)


def _cft_sub(x, plan, forward: bool):
    """cftfsub / cftbsub (fft4g.c:902-999): they share cft1st/cftmdl and
    differ in the final radix section's conjugation."""
    for l, (jA, jB, jC, tC, jD, tD), inv in plan["stages"]:
        parts = [_stack_vals(_vals_v0(x, jA, l)),
                 _stack_vals(_vals_v1(x, jB, l, plan["w2"]))]
        if len(jC):
            parts.append(_stack_vals(_vals_v23(x, jC, l, tC, False)))
        if len(jD):
            parts.append(_stack_vals(_vals_v23(x, jD, l, tD, True)))
        x = torch.cat(parts, dim=-1)[..., inv]
    l = plan["l_final"]
    j = plan["jF"]
    if plan["final_radix4"]:
        if forward:
            vals = _vals_v0(x, j, l)
        else:
            j1, j2, j3 = j + l, j + 2 * l, j + 3 * l
            ar, ai = x[..., j], x[..., j + 1]
            br, bi = x[..., j1], x[..., j1 + 1]
            cr, ci = x[..., j2], x[..., j2 + 1]
            dr, di = x[..., j3], x[..., j3 + 1]
            x0r, x0i = ar + br, -ai - bi
            x1r, x1i = ar - br, -ai + bi
            x2r, x2i = cr + dr, ci + di
            x3r, x3i = cr - dr, ci - di
            vals = [x0r + x2r, x0i - x2i,
                    x1r - x3i, x1i - x3r,
                    x0r - x2r, x0i + x2i,
                    x1r + x3i, x1i + x3r]
    else:
        j1 = j + l
        ar, ai = x[..., j], x[..., j + 1]
        br, bi = x[..., j1], x[..., j1 + 1]
        if forward:
            vals = [ar + br, ai + bi, ar - br, ai - bi]
        else:
            vals = [ar + br, -ai - bi, ar - br, -ai + bi]
    return _stack_vals(vals)[..., plan["final_inv"]]


def _rft_sub(x, plan, forward: bool):
    """rftfsub / rftbsub (fft4g.c:1234-1283).  The (j, n-j) pairs are
    disjoint and skip indices {0, 1, m, m+1}."""
    j, k = plan["jR"], plan["kR"]
    wkr, wki = plan["wkr"], plan["wki"]
    m = plan["n"] >> 1
    xj, xj1, xk, xk1 = x[..., j], x[..., j + 1], x[..., k], x[..., k + 1]
    xr = xj - xk
    xi = xj1 + xk1
    out = x.clone()
    if forward:
        yr = wkr * xr - wki * xi
        yi = wkr * xi + wki * xr
        out[..., j] = xj - yr
        out[..., j + 1] = xj1 - yi
        out[..., k] = xk + yr
        out[..., k + 1] = xk1 - yi
    else:
        yr = wkr * xr + wki * xi
        yi = wkr * xi - wki * xr
        out[..., j] = xj - yr
        out[..., j + 1] = yi - xj1
        out[..., k] = xk + yr
        out[..., k + 1] = yi - xk1
        out[..., 1] = -x[..., 1]
        out[..., m + 1] = -x[..., m + 1]
    return out


def _exact_rdft(x: torch.Tensor, plan, inverse: bool) -> torch.Tensor:
    v = x.to(F32)
    if not inverse:
        v = _rft_sub(_cft_sub(v[..., plan["perm"]], plan, True), plan, True)
        v0, v1 = v[..., 0], v[..., 1]
        out = v.clone()
        out[..., 0] = v0 + v1
        out[..., 1] = v0 - v1
        return out
    v = v.clone()
    a1 = 0.5 * (v[..., 0] - v[..., 1])
    v[..., 0] = v[..., 0] - a1
    v[..., 1] = a1
    v = _rft_sub(v, plan, False)
    return _cft_sub(v[..., plan["perm"]], plan, False)


# ------------------------------------------------------------ entry points

def _use_fast_fft(exact) -> bool:
    """Fast mode takes `torch.fft`; `WMIX_FAST_FFT=0` keeps the Ooura
    stages in fast mode too (the reference's switch)."""
    if os.environ.get("WMIX_FAST_FFT", "") == "0":
        return False
    return not is_exact(exact)


def rdft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """WebRtc_rdft (fft4g.c:324-361) on the last axis (128 or 256 points),
    always in the exact Ooura form."""
    return _exact_rdft(x, _plan_on(x.shape[-1], str(x.device)), bool(inverse))


def aec_rdft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """aec_rdft_forward_128 / aec_rdft_inverse_128 (aec_rdft.c:539-555) on
    the last axis, always in the exact form."""
    return _exact_rdft(x, _plan_on("aec128", str(x.device)), bool(inverse))


def rdft_traced(x: torch.Tensor, inverse: bool = False,
                exact=None) -> torch.Tensor:
    """WebRtc_rdft on the last axis in the mode asked for (`exact` None:
    the environment's)."""
    if _use_fast_fft(exact):
        return fast_rdft(x, inverse)
    return rdft(x, inverse)


def aec_rdft_traced(x: torch.Tensor, inverse: bool = False,
                    exact=None) -> torch.Tensor:
    """The AEC's 128-point transform on the last axis in the mode asked
    for."""
    if _use_fast_fft(exact):
        return fast_rdft(x, inverse)
    return aec_rdft(x, inverse)
