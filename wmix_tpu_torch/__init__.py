"""wmix_tpu_torch — the wmix record chain in PyTorch, with CUDA kernels for Hopper.

A port of `wmix_tpu` (the JAX package beside it, which stays the reference):
the batched 16 kHz record chain NS -> AEC -> AGC -> VAD over B stream slots,
with the steady-state AEC package as one hand-written CUDA kernel
(`csrc/aec_package.cu`).  Every module runs on CPU tensors too, where the
kernel's plain PyTorch version stands in for it.

Layout mirrors `wmix_tpu`:
  dsp      — intops, floatops, ns, agc, vad, aec (per-block AEC math)
  ops      — rdft (fast packing over torch.fft), stepper (zoom pattern)
  engine   — aec_plan (host planner), aec_step (exact-layout AEC),
             aec_package (the kernel's module), chain (RecordChain)
  csrc     — CUDA sources
  kernels  — build-and-load of the CUDA sources (nvcc + ctypes)

Importing this package imports torch and numpy only: never jax, never
`wmix_tpu`.
"""

__version__ = "0.1.0"
