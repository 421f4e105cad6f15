"""Float helpers of the fast-mode chain.

Port of `wmix_tpu/dsp/floatops.py` in its fast mode: the reference's
guarded products, quotients and opaque constants (`gm`, `gq`, `oc`) reduce
to plain float32 ops and `seq_sum` to `torch.sum`, so the port writes them
as such.  The C reference calls libm's double-precision log/exp/tanh/pow
and rounds back to float; the JAX package does the same in fast mode
whenever float64 exists (its CPU test configuration), and so does the
port, on the CPU and on the card alike.

Exact mode (the C-bit-exact guarded forms) is not ported yet: `WMIX_EXACT`
raises.
"""
from __future__ import annotations

import os

import torch

F32 = torch.float32
F64 = torch.float64


def check_fast_mode() -> None:
    """Raise if exact mode is asked for: the port carries fast mode only."""
    if os.environ.get("WMIX_EXACT", "") not in ("", "0"):
        raise NotImplementedError(
            "WMIX_EXACT: exact mode is not ported to wmix_tpu_torch yet")


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
    """(float)sqrt((double)x)."""
    return _via_double(torch.sqrt, x)


def fsqrtf(x):
    """sqrtf(x), correctly rounded in float32."""
    return torch.sqrt(x)


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
