"""The AEC package kernel's module: one 20 ms, 16 kHz AEC package (5 blocks)
per launch, for every stream of the batch.

Counterpart of `wmix_tpu/engine/aec_pallas.py` (the Pallas TPU kernel
`build_package_fn`).  Here the package step is `package_step`, which on
CUDA tensors launches the hand-written kernel `csrc/aec_package.cu`
and on CPU tensors runs `package_body`, its plain PyTorch version (the
same math as the reference's `_block_math` / `_package_body`, DFTs as
float32 matrix products).

Layout, as in the reference kernel: per-stream state in `STATE_FIELDS`,
partition histories newest first, the near/out frame rings replaced by the
package itself plus a 48-sample output carry, per-stream scalars as
[B, 1] columns.  Start-up and the first irregular package run the
exact-layout engine (`engine/aec_step.py`); `convert_eng_state` moves the
state into this layout once, at the first steady package.

Fast mode, float32 only.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.aec import (
    MIN_FAREND_PSD,
    MIN_OVERDRIVE,
    NUM_PARTITIONS,
    PART_LEN,
    PART_LEN1,
    PART_LEN2,
    PREF_BAND_SIZE,
    SMOOTHING,
    TARGET_SUPP,
    _overdrive_curve,
    _sqrt_hanning,
    _weight_curve,
)
from wmix_tpu_torch.dsp.floatops import cdiv
from wmix_tpu_torch.engine import aec_step
from wmix_tpu_torch.engine.aec_plan import FAR_PRE_BUF_SIZE, AecPlanner

F32 = torch.float32
I32 = torch.int32

BLOCKS_PER_PKG = 5          # 320-sample 16 kHz package / PART_LEN
OUT_DELAY = 48              # output stream lag vs near stream (samples)
PKG_LEN = BLOCKS_PER_PKG * PART_LEN
N_VECS = 11                 # packed [B, N_VECS, 65] spectral state rows
(V_XPOW, V_DPOW, V_DMIN, V_DINITMIN, V_SD, V_SE, V_SX,
 V_SDE0, V_SDE1, V_SXD0, V_SXD1) = range(N_VECS)
SCALAR_F = ("fb_min", "fb_local_min", "xd_avg_min", "over_drive",
            "over_drive_sm")        # [B, 1] float32 per-stream scalars
SCALAR_I = ("delay_idx", "new_min", "min_ctr", "st_near", "echo",
            "diverge")              # [B, 1] int32 per-stream scalars
STATE_FIELDS = (("vecs", "xf_re", "xf_im", "wf_re", "wf_im",
                 "xfw_re", "xfw_im", "d_buf", "e_buf", "out_buf",
                 "out_carry") + SCALAR_F + SCALAR_I)
STATE_SHAPES = dict(
    vecs=(N_VECS, PART_LEN1),
    **{k: (NUM_PARTITIONS, PART_LEN1)
       for k in ("xf_re", "xf_im", "wf_re", "wf_im", "xfw_re", "xfw_im")},
    d_buf=(PART_LEN2,), e_buf=(PART_LEN2,), out_buf=(PART_LEN,),
    out_carry=(OUT_DELAY,), **{k: (1,) for k in SCALAR_F + SCALAR_I})


# -------------------------------------------------------------- matrices

@functools.lru_cache(maxsize=None)
def _dft_mats():
    """DFT matrices in the Ooura-packed (re[65], im[65]) domain, as the
    reference builds them: re[k] = sum_j x_j cos(2 pi j k / 128),
    im[k] = +sum_j x_j sin(...) with im[0] = im[64] = 0; the unscaled
    inverse t_j = 0.5 re_0 + 0.5 (-1)^j re_64 + sum_{k=1..63} (re_k cos +
    im_k sin); windows and the 2/128 scale folded in where the reference
    applies them."""
    n = PART_LEN2
    j = np.arange(n)[:, None]
    k = np.arange(PART_LEN1)[None, :]
    ang = 2.0 * np.pi * j * k / n
    fre = np.cos(ang)
    fim = np.sin(ang)
    fim[:, 0] = 0.0
    fim[:, PART_LEN] = 0.0
    win = _sqrt_hanning().astype(np.float64)
    win128 = np.concatenate([win[:PART_LEN], win[PART_LEN:0:-1]])
    fwre = win128[:, None] * fre
    fwim = win128[:, None] * fim
    f64re = fre[PART_LEN:, :]
    f64im = fim[PART_LEN:, :]
    gre = np.empty((PART_LEN1, n))
    gim = np.zeros((PART_LEN1, n))
    jj = np.arange(n)[None, :]
    kk = np.arange(PART_LEN1)[:, None]
    gre[:] = np.cos(2.0 * np.pi * kk * jj / n)
    gre[0, :] = 0.5
    gre[PART_LEN, :] = 0.5 * ((-1.0) ** np.arange(n))
    gim[1:PART_LEN, :] = np.sin(
        2.0 * np.pi * np.arange(1, PART_LEN)[:, None] * jj / n)
    scale = 2.0 / n
    gyre = gre[:, PART_LEN:] * scale
    gyim = gim[:, PART_LEN:] * scale
    gore = gre * scale
    goim = gim * scale
    a = gre[:, :PART_LEN] * scale
    b = gim[:, :PART_LEN] * scale
    f64f_re = fre[:PART_LEN, :]
    f64f_im = fim[:PART_LEN, :]
    f = np.float32
    imask = np.ones(PART_LEN1, np.float32)
    imask[0] = 0.0
    imask[PART_LEN] = 0.0
    cn_re_mask = np.ones(PART_LEN1, np.float32)
    cn_re_mask[0] = 0.0
    cn_im_mask = np.ones(PART_LEN1, np.float32)
    cn_im_mask[0] = 0.0
    cn_im_mask[PART_LEN] = 0.0
    w32 = win.astype(np.float32)
    return dict(
        m128=f(np.concatenate([fre, fim, fwre, fwim], axis=1)),
        m64=f(np.concatenate([f64re, f64im], axis=1)),
        mgy=f(np.concatenate([gyre, gyim], axis=0)),
        mgo=f(np.concatenate([gore, goim], axis=1)),
        mab=f(np.concatenate([a, b], axis=1)),
        mf64=f(np.concatenate([f64f_re, f64f_im], axis=1)),
        imask=imask[None, :],
        cn_re_mask=cn_re_mask[None, :],
        cn_im_mask=cn_im_mask[None, :],
        win_a=w32[None, :PART_LEN],
        win_b=w32[None, PART_LEN:0:-1],
        wcurve=_weight_curve().astype(np.float32)[None, :],
        odcurve=_overdrive_curve().astype(np.float32)[None, :],
    )


@functools.lru_cache(maxsize=8)
def _mats_on(device: str):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in _dft_mats().items()}


# The kernel's transforms, spelled out in plain torch for the CPU tests
# (nothing on the main path calls these).  A real 128-point transform is
# a complex 64-point FFT of the even/odd packing z[n] = x[2n] + i x[2n+1]
# plus a split (forward) or merge (inverse) step.  The FFT runs in one
# warp: lane l holds points l and l + 32, one radix-2 stage works inside
# the lane and five across lanes by `shfl_xor`, emulated here by indexing
# with `lane ^ h`.  The forward is decimation in frequency (natural order
# in, bit-reversed out), the inverse decimation in time (bit-reversed in,
# natural out), so neither reorders: lane l's two values of a spectrum are
# the bins 2 brev5(l) and 2 brev5(l) + 1.

_LANE = torch.arange(32)
_BREV5 = torch.tensor([int(f"{i:05b}"[::-1], 2) for i in range(32)])


def _kernel_twiddle(m, inverse: bool = False):
    """e^{+-2 pi i m / 128} from the kernel's cos/sin table."""
    tab = _kernel_consts("cpu")
    sn = tab[PART_LEN2:2 * PART_LEN2][m]
    return torch.complex(tab[:PART_LEN2][m], -sn if inverse else sn)


def _warp_fft64(a0, a1, inverse: bool):
    """The 64-point complex FFT as the kernel's warp runs it: a0, a1
    [..., 32] complex are every lane's two registers.  Forward: sum of
    z[n] e^{+2 pi i n k / 64}; inverse: the conjugate kernel, unscaled."""
    spans = (16, 8, 4, 2, 1)
    if not inverse:
        a0, a1 = a0 + a1, (a0 - a1) * _kernel_twiddle(2 * _LANE)
    for h in (reversed(spans) if inverse else spans):
        upper = (_LANE & h) != 0
        tw = _kernel_twiddle((_LANE & (h - 1)) * (64 // h), inverse)
        regs = []
        for a in (a0, a1):
            if inverse:
                a = torch.where(upper, a * tw, a)
                p = a[..., _LANE ^ h]
                regs.append(torch.where(upper, p - a, a + p))
            else:
                p = a[..., _LANE ^ h]
                regs.append(torch.where(upper, (p - a) * tw, a + p))
        a0, a1 = regs
    if inverse:
        a1 = a1 * _kernel_twiddle(2 * _LANE, inverse=True)
        a0, a1 = a0 + a1, a0 - a1
    return a0, a1


def kernel_rfft_ref(x128):
    """The kernel's forward transform of [..., 128] real samples: (re, im)
    [..., 65] in the Ooura convention of `_dft_mats` (im = +sum x sin,
    im[0] = im[64] = 0)."""
    z = torch.complex(x128[..., 0::2], x128[..., 1::2])
    a0, a1 = _warp_fft64(z[..., :32], z[..., 32:], inverse=False)
    zs = torch.empty_like(z)                # the warp's scratch row
    zs[..., 2 * _BREV5] = a0
    zs[..., 2 * _BREV5 + 1] = a1
    k = torch.arange(PART_LEN1)
    zk, zm = zs[..., k & 63], zs[..., (64 - k) & 63].conj()
    even = (zk + zm) * 0.5
    odd = (zk - zm) * torch.complex(torch.tensor(0.0), torch.tensor(-0.5))
    spec = even + _kernel_twiddle(k % PART_LEN2) * odd
    im = spec.imag.clone()
    im[..., 0] = 0.0
    im[..., PART_LEN] = 0.0
    return spec.real, im


def kernel_irfft_ref(re, im, negate_im: bool = False):
    """The kernel's inverse of a packed (re, im) [..., 65] spectrum:
    [..., 128] samples, scaled by 2/128 as `_dft_mats` scales; im[0] and
    im[64] are ignored; `negate_im` is the output inverse's -im."""
    im = im.clone()
    im[..., 0] = 0.0
    im[..., PART_LEN] = 0.0
    spec = torch.complex(re, -im if negate_im else im)

    def merged(k):
        xk, xm = spec[..., k], spec[..., 64 - k].conj()
        return (xk + xm) + 1j * ((xk - xm) * _kernel_twiddle(k, True))
    a0, a1 = _warp_fft64(merged(2 * _BREV5), merged(2 * _BREV5 + 1),
                         inverse=True)
    z = torch.cat([a0, a1], dim=-1) * (1.0 / PART_LEN2)
    return torch.stack([z.real, z.imag], dim=-1).flatten(-2)


def _mm(x, m):
    """float32 matrix product; TF32 would cost hundreds of LSB of drift
    through the adaptation loop, so it must be off."""
    assert not torch.backends.cuda.matmul.allow_tf32
    if x.device.type == "cpu":
        # On the CPU this body is the served path, and a stream's output
        # must not depend on how many streams share its batch (a server
        # slot equals a dedicated chain bit for bit).  `x @ m` sums in
        # another order for one row than for several; a batched product of
        # one-row matrices gives every row the same sum whatever the batch.
        return torch.bmm(x[:, None, :], m.expand(x.shape[0], -1, -1))[:, 0]
    return x @ m


# ------------------------------------------------------------ plain body

# The two divisions of a constant by a tensor divide once, as the
# reference and the kernel do: torch runs `c / x` as `reciprocal(x) * c`,
# two roundings, which differ from one division on about a quarter of
# float32 inputs.
_EPS = float(np.float32(1e-10))


def error_scale(abs_ef, err_th: float):
    """ScaleErrorSignal's factor err_th / (|ef| + 1e-10)."""
    return cdiv(err_th, abs_ef + _EPS)


def overdrive_candidate(h_fb_min, nlp_mode: int):
    """The overdrive a fired minimum sets: max(target_supp /
    (log(fb_min + 1e-10) + 1e-10), min_overdrive)."""
    return torch.clamp_min(
        cdiv(float(TARGET_SUPP[nlp_mode]), torch.log(h_fb_min + _EPS) + _EPS),
        float(MIN_OVERDRIVE[nlp_mode]))


def _block_math(c, st, near64, xf_re_new, xf_im_new, xfw_re_new,
                xfw_im_new, rand65, f_sel, f_gate, f_upd, mult: int,
                nlp_mode: int, probe: dict | None = None):
    """One ProcessBlock + NonLinearProcessing (aec_core.c:1143-1351,
    911-1141) over [B] streams; returns (state dict, output [B, 64]).
    `probe`, when given, receives the operands of the block's decisions
    (tools/aec_parting.py)."""
    P1 = PART_LEN1
    g0, g1 = (float(v) for v in SMOOTHING[mult])
    gp0, gp1 = 0.9, 0.1

    d_buf = torch.cat([st["d_buf"][:, PART_LEN:], near64], dim=1)
    dspec = _mm(d_buf, c["m128"])
    df_re, df_im = dspec[:, :P1], dspec[:, P1:2 * P1]

    xf_re = torch.cat([xf_re_new[:, None], st["xf_re"][:, :-1]], dim=1)
    xf_im = torch.cat([xf_im_new[:, None], st["xf_im"][:, :-1]], dim=1)

    vecs = st["vecs"]
    far_spec = xf_re_new * xf_re_new + xf_im_new * xf_im_new
    x_pow = gp0 * vecs[:, V_XPOW] + float(np.float32(
        np.float32(gp1) * NUM_PARTITIONS)) * far_spec
    near_spec = df_re * df_re + df_im * df_im
    d_pow = gp0 * vecs[:, V_DPOW] + gp1 * near_spec

    ramp = float(np.float32(1.0002))
    d_min_prev = vecs[:, V_DMIN]
    lower = (d_pow + 0.1 * (d_min_prev - d_pow)) * ramp
    d_min_upd = torch.where(d_pow < d_min_prev, lower, d_min_prev * ramp)
    d_min_pow = torch.where(f_gate, d_min_upd, d_min_prev)
    d_init_prev = vecs[:, V_DINITMIN]
    d_init_upd = torch.where(d_min_pow > d_init_prev,
                             0.999 * d_init_prev + 0.001 * d_min_pow,
                             d_min_pow)
    d_init_min_pow = torch.where(f_sel, d_init_upd, d_init_prev)
    noise_pow = torch.where(f_sel, d_init_min_pow, d_min_pow)

    # FilterFar + echo-estimate inverse
    wf_re, wf_im = st["wf_re"], st["wf_im"]
    yf_re = (xf_re * wf_re - xf_im * wf_im).sum(dim=1)
    yf_im = (xf_re * wf_im + xf_im * wf_re).sum(dim=1)
    y64 = _mm(torch.cat([yf_re, yf_im], dim=1), c["mgy"])
    e = near64 - y64
    e_buf = torch.cat([st["e_buf"][:, PART_LEN:], e], dim=1)

    espec = _mm(e, c["m64"])
    ef_re, ef_im = espec[:, :P1], espec[:, P1:]

    # ScaleErrorSignal
    mu = 0.6 if mult == 1 else 0.5
    err_th = float(np.float32(2e-6 if mult == 1 else 1.5e-6))
    eps = _EPS
    denom = x_pow + eps
    ef_re = ef_re / denom
    ef_im = ef_im / denom
    abs_ef = torch.sqrt(ef_re * ef_re + ef_im * ef_im)
    fac = error_scale(abs_ef, err_th)
    big = abs_ef > err_th
    ef_re = torch.where(big, ef_re * fac, ef_re) * mu
    ef_im = torch.where(big, ef_im * fac, ef_im) * mu

    # FilterAdaptation: gradient spectrum, then the ifft/zero/fft round
    # trip as two matrix hops
    g_re = xf_re * ef_re[:, None] + xf_im * ef_im[:, None]
    g_im = xf_re * ef_im[:, None] - xf_im * ef_re[:, None]
    tb = g_re.shape[0]
    g2r = g_re.reshape(tb * NUM_PARTITIONS, P1)
    g2i = g_im.reshape(tb * NUM_PARTITIONS, P1)
    mab = c["mab"]
    h64 = _mm(g2r, mab[:, :PART_LEN]) + _mm(g2i, mab[:, PART_LEN:])
    d4 = _mm(h64, c["mf64"]).reshape(tb, NUM_PARTITIONS, 2 * P1)
    wf_re = wf_re + d4[:, :, :P1]
    wf_im = wf_im + d4[:, :, P1:] * c["imask"].reshape(1, 1, -1)

    # ---------------- NonLinearProcessing ----------------
    xfw_re = torch.cat([xfw_re_new[:, None], st["xfw_re"][:, :-1]], dim=1)
    xfw_im = torch.cat([xfw_im_new[:, None], st["xfw_im"][:, :-1]], dim=1)

    # PartitionDelay: FIRST max over partition energies, gated
    en = (wf_re * wf_re + wf_im * wf_im).sum(dim=2)
    iota12 = torch.arange(NUM_PARTITIONS, dtype=I32, device=en.device)
    mx = en.amax(dim=1, keepdim=True)
    first_max = torch.where(en == mx, iota12,
                            NUM_PARTITIONS).amin(dim=1, keepdim=True)
    delay_idx = torch.where(f_upd, first_max, st["delay_idx"]).to(I32)
    sel = (iota12 == delay_idx).to(F32)[:, :, None]
    xfw_d_re = (xfw_re * sel).sum(dim=1)
    xfw_d_im = (xfw_im * sel).sum(dim=1)

    m128w = c["m128"][:, 2 * P1:]
    dw = _mm(d_buf, m128w)
    dfw_re, dfw_im = dw[:, :P1], dw[:, P1:]
    ew = _mm(e_buf, m128w)
    efw_re, efw_im = ew[:, :P1], ew[:, P1:]

    sd = g0 * vecs[:, V_SD] + g1 * (dfw_re * dfw_re + dfw_im * dfw_im)
    se = g0 * vecs[:, V_SE] + g1 * (efw_re * efw_re + efw_im * efw_im)
    sx = g0 * vecs[:, V_SX] + g1 * torch.clamp_min(
        xfw_d_re * xfw_d_re + xfw_d_im * xfw_d_im, float(MIN_FAREND_PSD))
    sde0 = g0 * vecs[:, V_SDE0] + g1 * (dfw_re * efw_re + dfw_im * efw_im)
    sde1 = g0 * vecs[:, V_SDE1] + g1 * (dfw_re * efw_im - dfw_im * efw_re)
    sxd0 = g0 * vecs[:, V_SXD0] + g1 * (dfw_re * xfw_d_re +
                                        dfw_im * xfw_d_im)
    sxd1 = g0 * vecs[:, V_SXD1] + g1 * (dfw_re * xfw_d_im -
                                        dfw_im * xfw_d_re)
    sd_sum = sd.sum(dim=1, keepdim=True)
    se_sum = se.sum(dim=1, keepdim=True)

    diverge = torch.where(st["diverge"] != 0, 1.05 * se_sum,
                          se_sum) > sd_sum
    efw_re = torch.where(diverge, dfw_re, efw_re)
    efw_im = torch.where(diverge, dfw_im, efw_im)
    reset_wf = (se_sum > float(np.float32(19.95)) * sd_sum)[:, :, None]
    wf_re = torch.where(reset_wf, torch.zeros_like(wf_re), wf_re)
    wf_im = torch.where(reset_wf, torch.zeros_like(wf_im), wf_im)

    cohde = (sde0 * sde0 + sde1 * sde1) / (sd * se + eps)
    cohxd = (sxd0 * sxd0 + sxd1 * sxd1) / (sx * sd + eps)

    # NLP decision logic
    pref_band = PREF_BAND_SIZE // mult
    min_pref = 4 // mult
    band = slice(min_pref, min_pref + pref_band)
    inv_pb = float(np.float32(1.0 / pref_band))
    h_xd_avg = 1.0 - cohxd[:, band].sum(dim=1, keepdim=True) * inv_pb
    h_de_avg = cohde[:, band].sum(dim=1, keepdim=True) * inv_pb

    xd_min_prev = st["xd_avg_min"]
    h_nl_xd_avg_min = torch.where(
        (h_xd_avg < 0.75) & (h_xd_avg < xd_min_prev), h_xd_avg, xd_min_prev)
    st_near = torch.where(
        (h_de_avg > float(np.float32(0.98))) & (h_xd_avg > 0.9), 1,
        torch.where((h_de_avg < float(np.float32(0.95))) |
                    (h_xd_avg < 0.8), 0, st["st_near"])).to(I32)

    min_od = float(MIN_OVERDRIVE[nlp_mode])
    one_m_cohxd = 1.0 - cohxd
    both_min = torch.minimum(cohde, one_m_cohxd)

    # order statistics of the preferred band by rank selection: ties go to
    # the lower index, as the reference's qsort + index pick
    v = both_min[:, band]
    vi, vj = v[:, :, None], v[:, None, :]
    ii = torch.arange(pref_band, device=v.device)[:, None]
    jj = torch.arange(pref_band, device=v.device)[None, :]
    rank = ((vj < vi) | ((vj == vi) & (jj < ii))).to(I32).sum(dim=2)
    q75 = int(np.floor(0.75 * (pref_band - 1)))
    q50 = int(np.floor(0.5 * (pref_band - 1)))
    v_q75 = (v * (rank == q75).to(F32)).sum(dim=1, keepdim=True)
    v_q50 = (v * (rank == q50).to(F32)).sum(dim=1, keepdim=True)

    is_min1 = h_nl_xd_avg_min == 1.0
    near1 = st_near == 1
    echo_state = torch.where(is_min1 | near1, 0, 1).to(I32)
    over_drive = torch.where(is_min1, min_od, st["over_drive"])

    h_nl = torch.where(is_min1, torch.where(near1, cohde, one_m_cohxd),
                       torch.where(near1, cohde, both_min))
    h_fb = torch.where(is_min1, torch.where(near1, h_de_avg, h_xd_avg),
                       torch.where(near1, h_de_avg, v_q75))
    h_fb_low = torch.where(is_min1, torch.where(near1, h_de_avg, h_xd_avg),
                           torch.where(near1, h_de_avg, v_q50))
    if probe is not None:
        probe.update(en=en, se_sum=se_sum, sd_sum=sd_sum, h_xd_avg=h_xd_avg,
                     h_de_avg=h_de_avg, h_fb_low=h_fb_low)

    # minimum tracking
    fb_local_prev = st["fb_local_min"]
    new_min = (h_fb_low < float(np.float32(0.6))) & \
        (h_fb_low < fb_local_prev)
    h_fb_local_min = torch.where(new_min, h_fb_low, fb_local_prev)
    h_fb_min = torch.where(new_min, h_fb_low, st["fb_min"])
    h_new_min = torch.where(new_min, 1, st["new_min"])
    h_min_ctr = torch.where(new_min, 0, st["min_ctr"])
    h_fb_local_min = (h_fb_local_min +
                      float(np.float32(0.0008 / mult))).clamp(max=1.0)
    h_nl_xd_avg_min = (h_nl_xd_avg_min +
                       float(np.float32(0.0006 / mult))).clamp(max=1.0)
    h_min_ctr = torch.where(h_new_min == 1, h_min_ctr + 1, h_min_ctr)
    fire = h_min_ctr == 2
    h_new_min = torch.where(fire, 0, h_new_min).to(I32)
    h_min_ctr = torch.where(fire, 0, h_min_ctr).to(I32)
    od_cand = overdrive_candidate(h_fb_min, nlp_mode)
    over_drive = torch.where(fire, od_cand, over_drive)
    od_sm_prev = st["over_drive_sm"]
    over_drive_sm = torch.where(
        over_drive < od_sm_prev,
        0.99 * od_sm_prev + 0.01 * over_drive,
        0.9 * od_sm_prev + 0.1 * over_drive)

    # OverdriveAndSuppress
    wcurve = c["wcurve"]
    blend = wcurve * h_fb + (1.0 - wcurve) * h_nl
    h_nl = torch.where(h_nl > h_fb, blend, h_nl)
    h_nl = torch.exp((over_drive_sm * c["odcurve"]) *
                     torch.log(h_nl + float(np.float32(1e-30))))
    efw_re = efw_re * h_nl
    efw_im = efw_im * h_nl * -1.0

    # ComfortNoise: host uniforms shared by the batch; lane 0 masked
    rand = rand65.to(F32) * (1.0 / 32768.0)
    tmp_ang = float(np.float32(6.28318530717959)) * rand
    noise = torch.sqrt(torch.clamp_min(noise_pow, 0.0))
    cn_re = noise * torch.cos(tmp_ang) * c["cn_re_mask"]
    cn_im = -(noise * torch.sin(tmp_ang)) * c["cn_im_mask"]
    lam2 = torch.sqrt(torch.clamp_min(1.0 - h_nl * h_nl, 0.0))
    efw_re = efw_re + lam2 * cn_re
    efw_im = efw_im + lam2 * cn_im

    # inverse error fft + overlap-add
    mgo = c["mgo"]
    t128 = _mm(efw_re, mgo[:, :PART_LEN2]) - _mm(efw_im, mgo[:, PART_LEN2:])
    first = t128[:, :PART_LEN] * c["win_a"] + st["out_buf"]
    out_buf = t128[:, PART_LEN:] * c["win_b"]
    output = first.clamp(-32768.0, 32767.0)

    vecs = torch.stack([x_pow, d_pow, d_min_pow, d_init_min_pow,
                        sd, se, sx, sde0, sde1, sxd0, sxd1], dim=1)
    st = dict(st)
    st.update(d_buf=d_buf, e_buf=e_buf, out_buf=out_buf, vecs=vecs,
              xf_re=xf_re, xf_im=xf_im, wf_re=wf_re, wf_im=wf_im,
              xfw_re=xfw_re, xfw_im=xfw_im,
              fb_min=h_fb_min, fb_local_min=h_fb_local_min,
              xd_avg_min=h_nl_xd_avg_min, over_drive=over_drive,
              over_drive_sm=over_drive_sm, delay_idx=delay_idx,
              new_min=h_new_min, min_ctr=h_min_ctr, st_near=st_near,
              echo=echo_state, diverge=diverge.to(I32))
    return st, output


def init_package_state(batch: int, device=None):
    """Fresh kernel-layout state matching WebRtcAec_InitAec
    (aec_core.c:1527-1688); the reference's `init_pallas_state`."""
    device = resolve_device(device)
    st = {k: torch.zeros((batch,) + STATE_SHAPES[k],
                         dtype=I32 if k in SCALAR_I else F32,
                         device=device) for k in STATE_FIELDS}
    st["vecs"][:, V_DMIN] = 1.0e6
    st["vecs"][:, V_SD] = 1.0
    st["vecs"][:, V_SX] = 1.0
    for k in ("fb_min", "fb_local_min", "xd_avg_min"):
        st[k].fill_(1.0)
    st["over_drive"].fill_(2.0)
    st["over_drive_sm"].fill_(2.0)
    return st


def package_body(state, near320, xf5r, xf5i, xfw5r, xfw5i, rand, flags,
                 mult: int = 2, nlp_mode: int = 2):
    """Plain PyTorch version of the package kernel: 5 blocks, then the
    48-sample output-stream delay.  flags [5, 3] int32 per block
    (noise_sel_init, noise_gate_open, update_delay_idx); rand [5, 65]
    int32 with lane 0 zero.  Returns (new state dict, out [B, 320])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c = _mats_on(str(near320.device))
    st = dict(state)
    outs = []
    for b in range(BLOCKS_PER_PKG):
        st, out64 = _block_math(
            c, st, near320[:, b * PART_LEN:(b + 1) * PART_LEN],
            xf5r[:, b], xf5i[:, b], xfw5r[:, b], xfw5i[:, b],
            rand[b:b + 1], flags[b, 0] != 0, flags[b, 1] != 0,
            flags[b, 2] != 0, mult, nlp_mode)
        outs.append(out64)
    stream = torch.cat(outs, dim=1)
    pkg_out = torch.cat([st["out_carry"], stream[:, :PKG_LEN - OUT_DELAY]],
                        dim=1)
    st["out_carry"] = stream[:, PKG_LEN - OUT_DELAY:]
    return st, pkg_out


# ---------------------------------------------------------- the kernel

_INPUTS = ("flags", "rand", "near320", "xf5r", "xf5i", "xfw5r", "xfw5i",
           "consts")


@functools.lru_cache(maxsize=8)
def _kernel_consts(device: str) -> torch.Tensor:
    """The kernel's constant table: cos and sin of 2 pi m / 128 (m < 128),
    the square-root Hanning half window (65), the weight and overdrive
    curves (65 each)."""
    m = np.arange(PART_LEN2)
    tab = np.concatenate([
        np.cos(2.0 * np.pi * m / PART_LEN2).astype(np.float32),
        np.sin(2.0 * np.pi * m / PART_LEN2).astype(np.float32),
        _sqrt_hanning(), _weight_curve(), _overdrive_curve()])
    return torch.from_numpy(tab.astype(np.float32)).to(device)


def _check_kernel_args(ins: dict, state: dict) -> int:
    near = ins["near320"]
    B = near.shape[0]
    dev = near.device
    want = dict(flags=((BLOCKS_PER_PKG, 3), I32),
                rand=((BLOCKS_PER_PKG, PART_LEN1), I32),
                near320=((B, PKG_LEN), F32),
                consts=((2 * PART_LEN2 + 3 * PART_LEN1,), F32),
                **{k: ((B, BLOCKS_PER_PKG, PART_LEN1), F32)
                   for k in ("xf5r", "xf5i", "xfw5r", "xfw5i")},
                **{k: ((B,) + STATE_SHAPES[k],
                       I32 if k in SCALAR_I else F32)
                   for k in STATE_FIELDS})
    tensors = dict(ins, **{k: state[k] for k in STATE_FIELDS})
    for name, (shape, dtype) in want.items():
        t = tensors[name]
        if t.device != dev:
            raise ValueError(f"aec_package: {name} on {t.device}, "
                             f"expected {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"aec_package: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"aec_package: {name} is not contiguous")
    return B


def package_step(state, near320, xf5r, xf5i, xfw5r, xfw5i, rand, flags,
                 mult: int = 2, nlp_mode: int = 2):
    """The package step: on CUDA tensors one launch of the hand-written
    kernel (state updated in place, as the reference kernel aliases it);
    on CPU tensors the plain version.  Returns (state, out [B, 320])."""
    if near320.device.type == "cpu":
        return package_body(state, near320, xf5r, xf5i, xfw5r, xfw5i,
                            rand, flags, mult, nlp_mode)
    if near320.device.type != "cuda":
        raise ValueError(f"aec_package: no kernel for {near320.device}")
    if (mult, nlp_mode) != (2, 2):
        raise NotImplementedError("aec_package kernel: mult=2, nlp_mode=2")
    from wmix_tpu_torch import kernels
    ins = dict(flags=flags, rand=rand, near320=near320, xf5r=xf5r,
               xf5i=xf5i, xfw5r=xfw5r, xfw5i=xfw5i,
               consts=_kernel_consts(str(near320.device)))
    B = _check_kernel_args(ins, state)
    out = torch.empty((B, PKG_LEN), dtype=F32, device=near320.device)
    ptrs = [ins[k].data_ptr() for k in _INPUTS] + \
        [state[k].data_ptr() for k in STATE_FIELDS] + [out.data_ptr()]
    lib = kernels.load("aec_package")
    # the tensors' device and its current stream, whatever device is
    # current in this thread: the launch makes that device current in the
    # library's own CUDA runtime and restores the previous one
    dev = near320.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wmix_aec_package_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs), B, mult, nlp_mode,
        dev.index, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"aec_package kernel launch failed: CUDA error "
                           f"{rc} ({lib.wmix_cuda_error_string(rc).decode()})")
    with _count_lock:       # shards launch from threads of their own
        package_step.launches += 1
        package_step.launches_by_device[str(dev)] += 1
    return state, out


_count_lock = threading.Lock()
package_step.launches = 0
package_step.launches_by_device = collections.Counter()   # "cuda:N" -> n


# ------------------------------------------------- engine integration

def is_steady_16k(signature) -> bool:
    """The (normalized) 16 kHz steady-state plan shape: 2 subpackages, no
    startup passthrough, frames carrying (1, 1 | 1, 2) blocks."""
    if len(signature) != 2:
        return False
    (_, s0, f0), (_, s1, f1) = signature
    return (not s0 and not s1 and len(f0) == 2 and len(f1) == 2 and
            [len(fr) for fr in f0] == [1, 1] and
            [len(fr) for fr in f1] == [1, 2])


STEADY_FRAME_NEAR_REL = (0, 80, 16, 96)
STEADY_FRAME_OUT_REL = (96, 32, 112, 48)
STEADY_BLK_REL = (0, 64, 128, 48, 112)


def is_steady_dyn(dyn) -> bool:
    """True when a package's ring offsets follow the steady 16 kHz pattern
    the kernel bakes in.  The FIRST post-startup package is irregular (the
    C out ring's initial 64-zero priming shifts its frame reads,
    aec_core.c:1589) and must run the exact-layout path."""
    fn_ = np.asarray(dyn["frame_near"])
    if fn_.shape[0] != 4:
        return False
    base = int(fn_[0])
    n = 144

    def rel(v):
        return tuple(int(x) for x in ((np.asarray(v) - base) % n))
    return (rel(dyn["frame_near"]) == STEADY_FRAME_NEAR_REL and
            rel(dyn["frame_out"]) == STEADY_FRAME_OUT_REL and
            rel(dyn["blk_near"]) == STEADY_BLK_REL and
            rel(dyn["blk_out"]) == STEADY_BLK_REL)


def convert_eng_state(eng: aec_step.AecEngState, dyn):
    """Exact-layout engine state -> kernel layout, at a package boundary,
    given the dyn of the NEXT (steady) package.  Moves data only:
    partition rings become newest-first histories, the near ring goes
    (no leftover at 16 kHz package boundaries) and the out ring reduces
    to the 48-sample stream carry."""
    dev = eng.dev
    batch = dev.d_buf.shape[0]
    vecs = torch.stack([
        dev.x_pow, dev.d_pow, dev.d_min_pow, dev.d_init_min_pow,
        dev.sd, dev.se, dev.sx,
        dev.sde[:, :, 0], dev.sde[:, :, 1],
        dev.sxd[:, :, 0], dev.sxd[:, :, 1]], dim=1)
    # the next package's first block writes at blk_xf[0], so the newest
    # partition sits at blk_xf[0] + 1
    pos = int(dyn["blk_xf"][0])
    perm = [(pos + 1 + i) % NUM_PARTITIONS for i in range(NUM_PARTITIONS)]
    xf = dev.xf_buf[:, perm]
    # xfwBuf slot 0 is scratch (rewritten every block); history is 1..11
    wperm = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 11]
    xfw = dev.xfw_buf[:, wperm]
    carry_idx = (int(dyn["frame_out"][0]) +
                 torch.arange(OUT_DELAY, device=vecs.device)) % \
        eng.out_fr.shape[1]

    def col(x, dt):
        return x.to(dt).reshape(batch, 1).clone()
    return dict(
        vecs=vecs.contiguous(),
        xf_re=xf[:, :, 0].contiguous(), xf_im=xf[:, :, 1].contiguous(),
        wf_re=dev.wf_buf[:, :, 0].contiguous(),
        wf_im=dev.wf_buf[:, :, 1].contiguous(),
        xfw_re=xfw[:, :, 0].contiguous(), xfw_im=xfw[:, :, 1].contiguous(),
        d_buf=dev.d_buf.clone(), e_buf=dev.e_buf.clone(),
        out_buf=dev.out_buf.clone(),
        out_carry=eng.out_fr[:, carry_idx].contiguous(),
        fb_min=col(dev.h_nl_fb_min, F32),
        fb_local_min=col(dev.h_nl_fb_local_min, F32),
        xd_avg_min=col(dev.h_nl_xd_avg_min, F32),
        over_drive=col(dev.over_drive, F32),
        over_drive_sm=col(dev.over_drive_sm, F32),
        delay_idx=col(dev.delay_idx, I32),
        new_min=col(dev.h_nl_new_min, I32),
        min_ctr=col(dev.h_nl_min_ctr, I32),
        st_near=col(dev.st_near_state, I32),
        echo=col(dev.echo_state, I32),
        diverge=col(dev.diverge_state, I32))


def build_far_body(signature, sub_len: int):
    """BufferFarend only (far_pre ring + partition extractions into the far
    spectrum stores), in place: the front section of the exact-layout
    package, which the kernel path keeps in plain PyTorch."""
    def fn(far_pre, far_parts, farw_parts, far_pkg, dyn):
        ei = 0
        for si, (n_extr, _startup, _blk) in enumerate(signature):
            ei = aec_step.buffer_farend_(
                far_pre, far_parts, farw_parts,
                far_pkg[:, si * sub_len:(si + 1) * sub_len], dyn, si, ei,
                n_extr, exact=False)      # the kernel path is fast mode
        return far_pre, far_parts, farw_parts
    return fn


def _kernel_inputs(far_parts, farw_parts, dyn):
    """The package's five far partitions (plain and windowed, split into
    re/im) plus the shared randoms [5, 65] (lane 0 zero) and gate flags."""
    dev = far_parts.device
    slots = torch.as_tensor(np.asarray(dyn["blk_far"], np.int64),
                            device=dev)
    xf5 = far_parts.index_select(1, slots)
    xfw5 = farw_parts.index_select(1, slots)
    rand65 = np.concatenate([np.zeros((BLOCKS_PER_PKG, 1), np.int32),
                             np.asarray(dyn["blk_rand"], np.int32)], axis=1)
    return (xf5[:, :, :PART_LEN1].contiguous(),
            xf5[:, :, PART_LEN1:].contiguous(),
            xfw5[:, :, :PART_LEN1].contiguous(),
            xfw5[:, :, PART_LEN1:].contiguous(),
            torch.as_tensor(rand65, device=dev),
            torch.as_tensor(np.asarray(dyn["blk_flags"], np.int32),
                            device=dev))


class PackageAecState(NamedTuple):
    """ChainState.aec on the kernel path (the reference's PallasAecState):
    the far-end machinery keeps the exact layout (ring + partition
    stores); the block state lives in the kernel layout."""
    far_pre: torch.Tensor       # [B, FAR_PRE_BUF_SIZE]
    far_parts: torch.Tensor     # [B, part_cap, 130]
    farw_parts: torch.Tensor    # [B, part_cap, 130]
    p: dict                     # kernel-layout block state


def convert_chain_aec(eng: aec_step.AecEngState, dyn) -> PackageAecState:
    """AecEngState -> PackageAecState at a steady package boundary."""
    return PackageAecState(eng.far_pre, eng.far_parts, eng.farw_parts,
                           convert_eng_state(eng, dyn))


def init_chain_aec(batch: int, part_cap: int, device=None):
    device = resolve_device(device)

    def z(*sh):
        return torch.zeros(sh, dtype=F32, device=device)
    return PackageAecState(z(batch, FAR_PRE_BUF_SIZE),
                           z(batch, part_cap, 2 * PART_LEN1),
                           z(batch, part_cap, 2 * PART_LEN1),
                           init_package_state(batch, device))


def build_chain_aec_body(signature, sub_len: int, mult: int, nlp_mode: int):
    """The chain's steady AEC step: fn(PackageAecState, far_pkg,
    near_pkg, dyn) -> (PackageAecState, out); far machinery in PyTorch,
    the 5-block package in one `package_step`."""
    far_fn = build_far_body(signature, sub_len)

    def fn(ast: PackageAecState, far_pkg, near_pkg, dyn):
        far_fn(ast.far_pre, ast.far_parts, ast.farw_parts, far_pkg, dyn)
        pst, out = package_step(
            ast.p, near_pkg.contiguous(),
            *_kernel_inputs(ast.far_parts, ast.farw_parts, dyn),
            mult=mult, nlp_mode=nlp_mode)
        return ast._replace(p=pst), out

    return fn


class AecBatchPackage:
    """Batched AEC with the package kernel on the steady path (the
    reference's AecBatchPallas): start-up runs the exact-layout engine and
    the state converts at the first steady package.  16 kHz only."""

    def __init__(self, batch: int, freq: int = 16000, part_cap: int = None,
                 device=None):
        if freq != 16000:
            raise NotImplementedError("the AEC package path is 16 kHz only")
        self.batch = batch
        self.part_cap = part_cap or aec_step.DEFAULT_PART_CAP
        self.planner = AecPlanner(freq)
        self.sub_len = 160
        self.eng = aec_step.init_eng_state(batch, self.part_cap, device)
        self.ast = None

    def step(self, far_pkg, near_pkg):
        """One package: [B, 320] float32 far and near in, [B, 320] out."""
        plan = self.planner.plan_pkg()
        sig = plan.signature()
        dyn = aec_step.pack_dyn(plan, self.part_cap)
        far_pkg = far_pkg.to(F32)
        near_pkg = near_pkg.to(F32)
        if self.ast is None and is_steady_16k(sig):
            self.ast = convert_chain_aec(self.eng, dyn)
            self.eng = None
        if self.ast is None:
            fn = aec_step.build_pkg_body(sig, self.sub_len,
                                         self.planner.mult,
                                         self.planner.nlp_mode)
            self.eng, out = fn(self.eng, far_pkg, near_pkg, dyn)
            return out
        if not is_steady_16k(sig):
            raise RuntimeError("non-steady plan after conversion: "
                               "planner state corrupt")
        fn = build_chain_aec_body(sig, self.sub_len, self.planner.mult,
                                  self.planner.nlp_mode)
        self.ast, out = fn(self.ast, far_pkg, near_pkg, dyn)
        return out
