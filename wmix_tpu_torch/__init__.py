"""wmix_tpu_torch — the wmix record chain in PyTorch, with CUDA kernels for Hopper.

A port of `wmix_tpu` (the JAX package beside it, which stays the reference):
the batched 16 kHz record chain NS -> AEC -> AGC -> VAD over B stream slots,
with the steady-state AEC package as one hand-written CUDA kernel
(`csrc/aec_package.cu`).  Every module runs on CPU tensors too, where the
kernel's plain PyTorch version stands in for it.

Around the chain: checkpoint/resume of its state, the serving layer (a
B-slot `StreamServer` and its socket front door `StreamDaemon`, which move
packages between host and card through pinned staging buffers), and the
play half of the engine, the integer mix bus with G.711.

Layout mirrors `wmix_tpu`:
  dsp      — intops, floatops, ns, agc, vad, aec (per-block AEC math)
  ops      — rdft (fast packing over torch.fft), stepper (zoom pattern),
             mixer (device half: the saturating mix), g711 (table gathers)
  engine   — aec_plan (host planner), aec_step (exact-layout AEC),
             aec_package (the kernel's module), chain (RecordChain),
             checkpoint (snapshot/restore), mixbus (MixBus, TaskCursor)
  service  — stream_server (StreamServer), stream_daemon (StreamDaemon,
             StreamSocketClient, the `wmix-tpu-torch-stream` entry point)
  utils    — trace (StepTimer, torch.profiler wrappers)
  config   — EngineConfig
  staging  — the pinned host buffer ring behind every per-tick copy
  device   — the default-device rule (the card unless the CPU is asked for)
  csrc     — CUDA sources
  kernels  — build-and-load of the CUDA sources (nvcc + ctypes)

Importing this package imports torch and numpy only: never jax, never
`wmix_tpu`.
"""

__version__ = "0.1.0"
