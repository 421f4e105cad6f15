"""Real DFT in the Ooura packing, fast mode.

Port of `wmix_tpu/ops/rdft.py` `_fast_rdft` (and its callers
`rdft_traced` / `aec_rdft_traced`) over `torch.fft`.  The packing is
Ooura's: a[0] = R[0], a[1] = R[n/2], a[2k] = R[k], a[2k+1] = I[k] with
I[k] = +sum_j a[j] sin(2 pi j k / n), i.e. the negated numpy imaginary
part; the inverse takes that packing and returns the unscaled time signal
(callers multiply by 2/n, as the C reference does).  The exact Ooura
butterfly forms wait for exact mode.
"""
from __future__ import annotations

import torch

F32 = torch.float32


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


def rdft_traced(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """WebRtc_rdft (128 or 256 points) on the last axis."""
    return fast_rdft(x, inverse)


def aec_rdft_traced(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """aec_rdft_forward_128 / aec_rdft_inverse_128 on the last axis."""
    return fast_rdft(x, inverse)
