"""wmix_tpu_torch — the wmix record chain in PyTorch, with CUDA kernels for Hopper.

A port of `wmix_tpu` (the JAX package beside it, which stays the reference):
the batched record chain NS -> AEC -> AGC -> VAD over B stream slots, with
the steady-state AEC package as one hand-written CUDA kernel
(`csrc/aec_package.cu`), and its integer variant with the fixed-point
noise suppressor (NSX) and the mobile echo canceller (AECM).  Every module runs on CPU tensors too, where the
kernel's plain PyTorch version stands in for it.

Around the chain: checkpoint/resume of its state, the serving layer (a
B-slot `StreamServer` and its socket front door `StreamDaemon`, which move
packages between host and card through pinned staging buffers), the
play half of the engine, the integer mix bus with G.711, the batched
MP3 and AAC decoders (host bitstream front-ends, device transforms), and
the wmix daemon itself (`service.core.WmixDaemon`: mix ring, play loop,
record heartbeat on the card through single-stream processors, SysV
control plane, tasks), whose record chains an `EngineBridge` serves as
slots of one `StreamServer` batch.

Layout mirrors `wmix_tpu`:
  dsp      — intops, floatops, ns, agc, vad, aec (per-block AEC math
             and the daemon's AecProcessor), nsx (the fixed-point NS and
             NsxProcessor), aecm (per-block AECM math and AecmProcessor),
             with their tables in _nsx_tables and _aecm_tables, and a
             copy of speex_aec
  ops      — rdft (fast packing over torch.fft), stepper (the float32
             pacing patterns, over native/stepper.c), resample (pcm_zoom),
             mixer (load_data on the host, the saturating mix on the
             device), g711 (table gathers)
  engine   — aec_plan (host planner), aec_step (exact-layout AEC),
             aec_package (the kernel's module), aecm_step (the AECM's
             planner and package step), chain (RecordChain),
             checkpoint (snapshot/restore), mixbus (MixBus, TaskCursor)
  service  — stream_server (StreamServer), stream_daemon (StreamDaemon,
             StreamSocketClient, the `wmix-tpu-torch-stream` entry point),
             core (WmixDaemon and its NS/AGC/VAD processors), tasks,
             engine_bridge (EngineBridge), daemon (`wmix-tpu-torch`),
             client and cli (`wmix-tpu-torch-msg`), and copies of sysv,
             mem, hal and hal_alsa
  io_      — rtp (a copy)
  codecs   — mp3_batch (BatchedSynth, Mp3BatchDecoder), aac_batch
             (BatchedFilterbank, AacBatchDecoder), and copies of the host
             decoders (mp3, aac, sbr, ps, adts) with their tables, the
             ctypes wrappers of the C front-ends (mp3fe, aacfe), the AAC
             encoder (aacenc) and wav
  native   — the C front-ends' and the stepper's sources and their build
             (system compiler)
  utils    — trace (spans, StepTimer, OpCounter, the profiler), turns
             (device reads that hand the host's turn on)
  config   — EngineConfig
  staging  — the pinned host buffer ring behind every per-tick copy
  device   — the default-device rule (the card unless the CPU is asked for)
  csrc     — CUDA sources
  kernels  — build and load of the CUDA sources (nvcc + ctypes), and
             `launch`, every kernel's one launch path and counter

Importing this package imports torch and numpy only: never jax, never
`wmix_tpu`.
"""

__version__ = "0.1.0"
