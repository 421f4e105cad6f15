"""Float helpers matching the C reference's mixed float/double arithmetic.

Port of `wmix_tpu/dsp/floatops.py`.  The C reference keeps its state in
float32 but calls libm's double-precision log/exp/tanh/pow and rounds back
to float; the port does the same in float64, on the CPU and on the card
alike, in both modes.

Two arithmetic modes, switched as the reference switches them:

  * fast mode (the default): sums are `torch.sum` (tree or blocked order)
    and the transforms are `torch.fft`;
  * exact mode (`WMIX_EXACT=1`): sums are left-to-right float32 folds
    (`seq_sum`, the C `acc += x[i]` loops) and the transforms are the
    Ooura butterflies of `ops/rdft.py`, so every float32 rounding happens
    where the reference's exact mode has it and the outputs are bit-equal
    to `wmix_tpu` under x64.

The reference turns exact mode on by default when JAX runs with x64; the
port has no such switch, so its default is always fast and exact mode is
asked for by `WMIX_EXACT` (which wins over `WMIX_FAST`, as there) or by
the `exact=` argument of the functions that take one.

The reference's `gm`, `gq`, `oc` and `guard_zero` exist to stop XLA from
contracting a product into an FMA or reassociating constants.  Eager
PyTorch rounds after every op, so `a * b + c` written as two ops already
has that property and the helpers have no counterpart here.  What must
stay off an exact-mode float path is any single op that multiplies and
adds inside (`addcmul`, `lerp`, matrix products, complex multiplication,
`torch.fft`) and every library reduction.  `c / tensor` with a Python
number is one more: it runs as `tensor.reciprocal() * c`, two roundings,
hence `cdiv`; and so is `tensor / c` on the card, which multiplies by
`1 / c`, hence `divs`.
"""
from __future__ import annotations

import math
import os

import torch

F32 = torch.float32
F64 = torch.float64


def fast_mode() -> bool:
    """True unless exact mode is asked for (`WMIX_EXACT` set and not "0").
    The reference also reads `WMIX_FAST`, which there overrides an x64
    default and loses to `WMIX_EXACT`; with a default that is fast already
    it changes nothing here."""
    return os.environ.get("WMIX_EXACT", "") in ("", "0")


def is_exact(exact=None) -> bool:
    """The mode a function runs in: its `exact` argument, or the
    environment's when that is None."""
    return (not fast_mode()) if exact is None else bool(exact)


def cdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """`c / x` for a float32 constant `c`, as one correctly rounded
    division."""
    return torch.full_like(x, c) / x


def divs(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x / c` for a float32 constant `c`, as one correctly rounded
    division on every device: CUDA's division by a host scalar multiplies
    by the scalar's reciprocal, which is two roundings unless `c` is a
    power of two."""
    return x / torch.full_like(x, c)


def _via_double(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.to(F64)).to(F32)


def flog(x):
    """(float)log((double)x)."""
    return _via_double(torch.log, x)


def fexp(x):
    """(float)exp((double)x)."""
    return _via_double(torch.exp, x)


def ftanh(x):
    """(float)tanh((double)x)."""
    return _via_double(torch.tanh, x)


def fsqrt_d(x):
    """(float)sqrt((double)x): for float32 `x` the value of sqrtf(x) (a
    float64 root rounds to float32 innocuously, 53 >= 2 * 24 + 2), which
    `fsqrtf` gives on every device."""
    return fsqrtf(x)


def fsqrtf(x):
    """sqrtf(x), correctly rounded in float32 on every device.  Neither
    torch's float32 `sqrt` on a large CPU tensor nor the card's is (an ulp
    off on about 1 % of inputs), and its float64 `sqrt` on a large CPU
    tensor is not either, so the float64 root rounded to float32 is only
    within an ulp of sqrtf.  One step to the neighbour beyond the midpoint
    that `x` passes makes it exact: a midpoint of two float32 values has
    25 significant bits, so its square is exact in float64."""
    r = _via_double(torch.sqrt, x)
    xd, rd = x.to(F64), r.to(F64)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    mid_up = (rd + up.to(F64)) * 0.5
    mid_down = (rd + down.to(F64)) * 0.5
    return torch.where(xd > mid_up * mid_up, up,
                       torch.where(xd < mid_down * mid_down, down, r))


def fcosf(x):
    """cosf(x) as (float)cos((double)x)."""
    return _via_double(torch.cos, x)


def fsinf(x):
    """sinf(x) as (float)sin((double)x)."""
    return _via_double(torch.sin, x)


def fpowf(base, expo):
    """powf, computed in double."""
    return torch.pow(base.to(F64), expo.to(F64)).to(F32)


def fpow_div(num, base, expo):
    """(float)(num / pow(base, expo)) with the division in double."""
    return (num.to(F64) / torch.pow(base.to(F64), expo.to(F64))).to(F32)


def seq_sum(x: torch.Tensor, axis: int = -1, exact=None) -> torch.Tensor:
    """Sum over `axis`.  Exact mode: the left-to-right float32 fold of C's
    `for (...) acc += x[i]`, one add per term (a Python loop: as many
    launches as terms on the card).  Fast mode: `torch.sum`."""
    x = x.to(F32)
    if not is_exact(exact):
        return x.sum(dim=axis)
    acc = torch.zeros_like(x.select(axis, 0))
    for v in x.unbind(axis):
        acc = acc + v
    return acc


def seq_sum_multi(*terms, exact=None):
    """Sums over the last axis of several same-shaped term tensors that
    accumulate in one C loop into independent accumulators: in exact mode
    one fold over the stacked terms."""
    if not is_exact(exact):
        return tuple(t.to(F32).sum(dim=-1) for t in terms)
    accs = seq_sum(torch.stack([t.to(F32) for t in terms]), -1, True)
    return tuple(accs[i] for i in range(len(terms)))
