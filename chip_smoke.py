"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernel from wmix_tpu_torch/csrc/, drives the record chain's main path at
its full size, checks the kernel against its plain PyTorch version and the
chain against itself on the CPU, and prints one JSON result line.

    python3 chip_smoke.py

Phases (each prints a line; any failed check raises, so the run exits
non-zero and prints no result):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device -> exit 1
  2. build the aec_package kernel (nvcc, sm_90a), with ptxas's report
  3. main path: RecordChain(4096, 16000) in its defaults (the card,
     NS+AEC+AGC+VAD, AGC 5 dB), 4 chunks of K=25 packages of seeded
     audio; the kernel's launch count over the run must equal the steady
     packages (96), the AGC and VAD kernels' the packages (100); outputs int16,
     AEC output finite; steady chunk time and streams = B * audio_s / wall
  4. kernel vs package_body at B=4096 from the adapted state: rel <= 1e-4
     on the output and every float state field, equality on every integer
     state field; CUDA-event times beside the least time the card could
     take for the same bytes and operations: kernel_ms with 20 launches
     queued behind one another (device time alone), kernel_call_ms and
     plain_ms one call at a time (median of 20, the host's share of a
     call included)
  4b. the AGC kernel (csrc/agc.cu, with ptxas's report) vs
     agc.process_pkg_body at B=4096 from phase 3's AGC state on phase 3's
     first package: output and every state leaf equal; CUDA-event times
     as in phase 4 (kernel queued, kernel and plain version a call)
     beside the least time for the bytes a launch moves
  4c. the VAD kernel (csrc/vad.cu, with ptxas's report) vs
     vad.process_body at B=4096 from phase 3's VAD state on phase 3's
     first package: output and every state leaf equal; times as in 4b
  5. the chain at B=4 on cuda (kernel) and on cpu (plain version), same
     input, 2 chunks x K=25: origin and 8 kHz package within 4 LSB; the
     card's ms per steady package at B=4 beside phase 3's at B=4096
  6. echo check: AecBatchPackage at B=4096 on a delayed-echo scene,
     output energy below near energy over the last package
  7. checkpoint: RecordChain(256, 16000), 10 packages, snapshot, 10 more;
     the snapshot restored into a fresh chain gives the same 10 outputs,
     tick and play_count, all equal; snapshot bytes and seconds
  8. the server at full width: StreamServer(4096, 16000), every slot
     open, drain thread on, 30 ticks of feed_batch + tick_pipelined(12) +
     read_batch on phase 3's audio: blocks equal to phase 3's outputs, 26
     kernel launches; pump ms per tick against the 20 ms budget with the
     drain thread on and (10 more ticks, depth 3) off; output latency;
     bytes per tick each way; pinned memory
  9. the socket front door: a StreamDaemon (capacity 64, full chain,
     free-running pump, kernel loaded first) on a Unix socket serves nine
     StreamSocketClients, one admitted late, 8 packages each; a
     pass-through daemon of capacity 1 returns samples unchanged and
     answers a second OPEN with ERR
 10. the mix bus: MixBus(4096, 16 kHz mono) on the card against the same
     calls on the CPU (mix_waves with wrapping cursors, divisors 1 and 2,
     saturation; drain_async twice; has_data): PCM, ring, cursors equal;
     G.711 on the card equal to its tables; ms per mix_waves and
     drain_async
 11. the other geometries at full width, fast mode: RecordChain(4096,
     8000), RecordChain(4096, 16000, chn=2), RecordChain(4096, 32000), a
     10 ms chain (16 kHz, AEC off) and the integer-only 32 kHz chain (NS
     off), each 12 packages of seeded audio on the card; the first 4
     streams against the port's CPU chain on the same audio: origin and
     8 kHz package within 4 LSB and VAD flags equal (the integer-only
     chain: equal); ms per steady package of each; the stereo chain's
     kernel launches (packages - 4), none at any other geometry
 12. exact mode on the card: RecordChain(4096, 16000) built with
     WMIX_EXACT=1, 10 packages, no AEC kernel launch; the first 4 streams
     against the port's CPU exact chain: equal, outputs and every state
     leaf (were they not, the float64 log/exp/tanh/pow/cos/sin of card and
     CPU are compared on 2^20 inputs each, and only where those differ
     does the gate fall back to 1 LSB with the integer leaves equal); ms
     per package beside phase 3's fast package
 13. the integer chain on the card: RecordChain(4096, 16000) and
     RecordChain(4096, 8000) with aec_backend="aecm", ns_backend="nsx"
     (26 and 12 packages of seeded audio; the 400 ms echo path gives the
     AECM its first far end at package 21), no AEC kernel launch; the first 4
     streams against the port's CPU chain: equal, outputs, VAD flags and
     every state leaf; ms per package beside phase 3's; the aten
     operations of one more package of each chain and of phase 3's chain
     (`utils.trace.OpCounter`: all, and those that are not views)
 14. the device codec halves at full width: BatchedSynth(4096), 8 stereo
     frames of seeded Q28 subband samples (ns = 36) then 4 mono frames,
     slots reset after frames 3 and 9; BatchedFilterbank(8192) (4096
     stereo streams) over the ten-frame window walk (every sequence, both
     shapes, every transition) on seeded spectra, all slots at once, then
     one tick through `frame` with three (sequence, shape, previous shape)
     groups; the same calls on the CPU over the first 512 streams and
     1024 slots (every stream in earlier runs): PCM, hist,
     phase, time_out, overlap and shape_prev equal, floats bitwise; ms per
     frame (CUDA events, median), streams = B * frame audio / time, the
     aten operations and bytes of one frame of each kind beside the
     prediction from phase 3's cost per operation, the device's busy time
     in one frame (torch.profiler: the durations of the events on the
     device, and their count) and the idle share it leaves; no kernel
     launch
 15. the batch decoders end to end: the C front-ends must build and load;
     AacBatchDecoder(128) over the stored AAC-LC streams (44.1 kHz stereo
     with short blocks, 32 kHz mono), Mp3BatchDecoder(128) over the stored
     Layer III frames (C front-end) and Mp3BatchDecoder(8) over the stored
     Layer II stream (Python front-end), starts staggered over the first
     ticks; the card's PCM of
     every stream and frame, and the ticks streams end in, equal to the
     CPU decoders'; ms per tick and streams = decoded audio / time; no
     kernel launch
 16. the daemon core on the card: EngineBridge(4096, 16000) with 256
     WmixDaemons attached (LoopHal, NS+AEC+AGC+VAD, each its own seeded
     microphone, a record task holding the path open, so one package a
     tick), 20 ticks of pump(1) per daemon then bridge.tick(): ms per tick
     of the pumps and of bridge.tick against 20 ms, the AEC kernel's
     launches (every steady package of the batch), and every delivered
     package equal to RecordChain(4096, 16000) driven directly with the
     same packages; the same daemons through a CPU bridge of capacity
     256, measured (largest LSB, packages and daemons beyond 4 LSB: in
     fast mode a last-bit difference of the kernel can flip a VAD
     decision, whose mute moves a package by thousands of LSB), and, in
     exact mode (8 ticks), equal to the CPU's bridge for every daemon.
     One inline daemon (16 kHz, all four modules): ms per heartbeat and
     the aten operations of one over 20 packages in fast mode, within 4
     LSB of the same daemon on the CPU, and 12 packages in exact mode
     equal to the CPU's.
     The control plane: a daemon in realtime mode with its SysV queue and
     shared-memory rings under a private MSG_PATH plays a seeded WAV sent
     by `client.play` (LoopHal's speaker equal to the CPU daemon's from
     the first sample played on) and `client.mem_1x8000` reads its record
     ring, nonzero
 17. the stream batch over shards: ShardedRecordChain(4096, 16000) with
     one shard on every visible card (two shards on cuda:0 with one
     card), the first 12 packages of phase 3's audio: the kernel's
     launches on each shard's device (every steady package of every
     shard), each shard equal to a dedicated RecordChain of its width on
     its slots and device, bit for bit; against phase 3's
     RecordChain(4096) outputs the largest LSB, the equal share and the
     streams beyond 4 LSB, reported (in fast mode the card's matrix
     products follow the batch size); ms per sharded package beside
     phase 3's and beside the sum of the shard-width chains' (timed in
     this phase, so a host that slows over the script does not bias it)  Exact mode and the integer
     chain at B=1024 over the same shards, 8 packages: equal to the
     unsharded chain on the card, outputs and every state leaf.  With
     two cards or more, dryrun_multichip over all of them
 18. parity (wmix_tpu_torch.parity) at B=64 over the first second of the
     64 scenes of PARITY_r05 (echo / fartalk / noecho / silence x echo
     gains): the four configurations that must be bit-equal to wmix_tpu
     (the integer chain, exact mode, AGC alone, VAD alone), each in a
     worker process of its own (they never launch the kernel), their
     first-second digests equal to wmix_tpu's stored ones
     (tests/data/torch_parity_ref.json), every stream; meanwhile, in this
     process, the fast full chain on the card (the kernel on every steady
     package) and on the CPU: error_stats of card against CPU, and the
     packages whose VAD flag differs from wmix_tpu's stored flags and from
     the CPU's, reported; then the AEC alone (aec_only) on the card and
     on the CPU: the card within AEC_PLAIN_LSB (4) LSB and the CPU within
     parity.PLAIN_LSB (1) of wmix_tpu's plain-JAX fast path on every
     sample (the stored first second, tests/data/
     torch_aec_only_plain_1s.npz; the form tools/aec_parting.py holds the
     port to), the card against the CPU and the stored port-CPU digests
     reported; the kernel on every steady package of both (46 each)
 19. the port's measuring entry points: `wmix_tpu_torch.bench.run_point`
     in the headline shape (RecordChain(4096, 16000), three planner-only
     ticks, two warm chunks and 2 timed chunks of K = 25, in this
     process; the ladder, the stage isolation and the worker are the CPU
     tests' and the full-size run's), its kernel launches (every package
     after the first warm chunk's priming one, 50 of them timed) and its
     first 4 streams against RecordChain(4, device="cpu") driven the same
     way, within 4 LSB; `graft_entry.entry()`'s fn once, one launch,
     within 4 LSB of the same package on the CPU;
     `realtime_bench.bench_ticks(4096, 20, 4, 4)` (every tick delivered,
     20 launches); `mix_bench.bench(1024, 4, 20)` and `codec_bench`'s
     quick sizes, no launch; one line of their numbers
Every phase line ends with t_s, the seconds since the script started.
Then the kernel table as JSON, the AEC package kernel's launches summed
over phases 3, 7, 8, 9 and 11-19, each counted from 0, and the AGC
kernel's over phases 3, 4b and 7-19 and the VAD kernel's over phases 3,
4c and 7-19 (phases 3, 7, 8, 11, 12 and 13 hold each to one a package),
and, last, {"ok": true, "device": {...}}.
"""
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wmix_tpu_torch import kernels  # noqa: E402
from wmix_tpu_torch.dsp import agc  # noqa: E402
from wmix_tpu_torch.dsp import vad as vad_mod  # noqa: E402

T0 = time.perf_counter()
B_MAIN, K, CHUNKS = 4096, 25, 4
LSB = 4
REL = 1e-4


def phase(name, **kv):
    """Print a phase's line, with the seconds since the script started."""
    print(json.dumps({"phase": name, **kv,
                      "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed: {res.stderr.strip()}"


def audio(k, b, seed):
    rng = np.random.RandomState(seed)
    mic = (rng.randn(k, b, 320) * 3000).astype(np.int16)
    play = (rng.randn(k, b, 320) * 5000).astype(np.int16)
    return mic, play


def rel(x, y) -> float:
    x, y = x.double(), y.double()
    return float((x - y).abs().max() / y.abs().max().clamp_min(1.0))


# Published peaks of the H100 SXM (NVIDIA's data sheet, 700 W): device
# memory and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def package_bound(tensors_in, tensors_inout, tensors_out, batch):
    """(bound_ms, bound_by, bytes, flop) of one AEC package launch: every
    input read once, the state read and written once, the output written
    once, against the operations of the FFT form: per block 30 real
    128-point transforms (a 64-point complex FFT, 6 stages x 32
    butterflies x 10, plus 65 split or merge bins x 14) and about 25 k of
    per-bin work (FilterFar, gradient, energies, smoothing, suppression),
    5 blocks per stream."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    moved = nbytes(tensors_in) + 2 * nbytes(tensors_inout) + \
        nbytes(tensors_out)
    flop = batch * 5 * (30 * (6 * 32 * 10 + 65 * 14) + 25_000)
    by_bytes = moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flop / PEAK_F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", moved, flop)


def cuda_median_ms(fn, n=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_queued_ms(fn, n=20, reps=5) -> float:
    """Device time of one call of `fn` when its launches queue up behind
    each other: a large matrix product keeps the card busy while the host
    enqueues n calls, so the host's time per call (argument checks, ctypes)
    is not in the reading, as it would be for a kernel shorter than its
    wrapper.  Median over `reps` of (elapsed over n calls) / n."""
    blocker = torch.empty((8192, 8192), device="cuda")
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        blocker @ blocker
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def phase_stage_kernel(name, fields, kernel, plain, st, pkg) -> dict:
    """4b, 4c: a stage's kernel (csrc/<name>.cu, `kernel(st, pkg)`)
    against its plain version on the card from the state `st`, and its
    times beside its byte bound; returns the times."""
    from wmix_tpu_torch import kernels
    kernels.load(name)
    log = kernels.build_log[name]
    ptxas = [ln.strip() for ln in log["log"].splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln]
    st_k, out_k = kernel(st, pkg)
    st_p, out_p = plain(st, pkg)
    check_equal(f"{name} kernel output", out_k, out_p)
    for field, a, b in zip(fields, st_k, st_p):
        check_equal(f"{name} kernel state {field}", a, b)
    kernel_ms = cuda_queued_ms(lambda: kernel(st, pkg))
    kernel_call_ms = cuda_median_ms(lambda: kernel(st, pkg))
    plain_ms = cuda_median_ms(lambda: plain(st, pkg), n=5, warm=1)
    moved = sum(t.numel() * t.element_size()
                for t in (pkg, out_k, *st, *st_k))
    bound_ms = moved / PEAK_BYTES_PER_S * 1e3
    phase(f"{name}_kernel_vs_plain", batch=pkg.shape[0],
          built=log["built"], seconds=round(log["seconds"], 3), ptxas=ptxas,
          equal=True, kernel_ms=round(kernel_ms, 4),
          kernel_call_ms=round(kernel_call_ms, 4),
          plain_ms=round(plain_ms, 4), bound_ms=round(bound_ms, 5),
          bound_by="bytes", bytes_moved=moved)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms)


def check_equal(name, got, want) -> None:
    """Raise unless two tensors or arrays hold the same values."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
    if got.shape != want.shape or got.dtype != want.dtype or \
            not np.array_equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: not equal ({n} values differ)")


def phase_checkpoint(aec_package) -> int:
    """7. snapshot on the card, restore into a fresh chain, same outputs."""
    from wmix_tpu_torch.engine import checkpoint
    from wmix_tpu_torch.engine.chain import RecordChain
    B7, N = 256, 10
    mic, play = audio(2 * N, B7, seed=5)
    aec0 = kernels.launched("aec_package")
    agc_launched, vad_launched = (kernels.launched("agc"),
                                  kernels.launched("vad"))
    a = RecordChain(B7, 16000)
    a.run_chunk(mic[:N], play[:N])
    if not isinstance(a.state.aec, aec_package.PackageAecState):
        raise AssertionError("phase 7: not in the kernel layout")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = checkpoint.snapshot(a)
    snap_s = time.perf_counter() - t0
    want = a.run_chunk(mic[N:], play[N:])
    b = RecordChain(B7, 16000)
    t0 = time.perf_counter()
    checkpoint.restore(b, blob)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = b.run_chunk(mic[N:], play[N:])
    torch.cuda.synchronize()
    for nm, g, w in zip(("origin", "pkg8k", "vad"), got, want):
        check_equal(f"phase 7 {nm} after restore", g, w)
    if (b.tick, b.play_count) != (a.tick, a.play_count):
        raise AssertionError("phase 7: tick or play_count differ")
    launches = kernels.launched("aec_package") - aec0
    if launches != 3 * N - 4:
        raise AssertionError(f"phase 7: {launches} launches")
    agc_n = kernels.launched("agc") - agc_launched
    vad_n = kernels.launched("vad") - vad_launched
    if agc_n != 3 * N:
        raise AssertionError(f"phase 7: {agc_n} AGC kernel launches over "
                             f"{3 * N} packages")
    if vad_n != 3 * N:
        raise AssertionError(f"phase 7: {vad_n} VAD kernel launches over "
                             f"{3 * N} packages")
    phase("checkpoint", batch=B7, packages_before=N, packages_after=N,
          outputs_equal=True, snapshot_bytes=len(blob),
          bytes_per_stream=round(len(blob) / B7, 1),
          snapshot_s=round(snap_s, 4), restore_s=round(restore_s, 4),
          kernel_launches=launches)
    return launches


def phase_server(aec_package, mic, play, chain_outs) -> dict:
    """8. StreamServer at B=4096 over phase 3's audio; its blocks must
    equal phase 3's chain outputs."""
    from wmix_tpu_torch.service.stream_server import StreamServer
    from wmix_tpu_torch.utils.trace import StepTimer
    ON_TICKS, OFF_TICKS, DEPTH, OFF_DEPTH = 30, 10, 12, 3
    want = [torch.cat([o[j] for o in chain_outs]).cpu().numpy()
            for j in range(3)]
    t0 = time.perf_counter()
    srv = StreamServer(B_MAIN, 16000)
    init_s = time.perf_counter() - t0
    hs = [srv.open_stream() for _ in range(B_MAIN)]
    blocks, fed_at, latency_ms, latency_ticks = [], {}, [], []

    def collect(tick_now):
        while True:
            r = srv.read_batch(hs)
            if r is None:
                return
            k = len(blocks)
            latency_ms.append((time.perf_counter() - fed_at[k]) * 1e3)
            latency_ticks.append(tick_now - k)
            blocks.append(r)

    def run(t_from, t_to, depth, timer):
        for t in range(t_from, t_to):
            fed_at[t] = time.perf_counter()
            with timer.step():
                srv.feed_batch(hs, mic[t], play[t])
                srv.tick_pipelined(depth)
            collect(t)
        srv.flush_pipeline()
        collect(t_to - 1)

    aec0 = kernels.launched("aec_package")
    agc_launched, vad_launched = (kernels.launched("agc"),
                                  kernels.launched("vad"))
    srv.start_drain_thread()
    on = StepTimer(budget_ms=20.0)
    run(0, ON_TICKS, DEPTH, on)
    srv.stop_drain_thread()
    launches_on = kernels.launched("aec_package") - aec0
    agc_on = kernels.launched("agc") - agc_launched
    vad_on = kernels.launched("vad") - vad_launched
    n_on, lat_on = len(blocks), (list(latency_ms), list(latency_ticks))
    off = StepTimer(budget_ms=20.0)
    run(ON_TICKS, ON_TICKS + OFF_TICKS, OFF_DEPTH, off)
    torch.cuda.synchronize()
    launches_off = kernels.launched("aec_package") - aec0 - launches_on
    agc_off = kernels.launched("agc") - agc_launched - agc_on
    vad_off = kernels.launched("vad") - vad_launched - vad_on
    if n_on != ON_TICKS or len(blocks) != ON_TICKS + OFF_TICKS:
        raise AssertionError(f"phase 8: {n_on} and {len(blocks)} blocks")
    for t, blk in enumerate(blocks):
        for j, nm in enumerate(("origin", "pkg8k", "vad")):
            check_equal(f"phase 8 tick {t} {nm} vs the chain", blk[j],
                        want[j][t])
    if launches_on != ON_TICKS - 4 or launches_off != OFF_TICKS:
        raise AssertionError(f"phase 8: {launches_on} and {launches_off} "
                             "kernel launches")
    if (agc_on, agc_off) != (ON_TICKS, OFF_TICKS):
        raise AssertionError(f"phase 8: {agc_on} and {agc_off} AGC kernel "
                             f"launches over {ON_TICKS} and {OFF_TICKS} "
                             "ticks")
    if (vad_on, vad_off) != (ON_TICKS, OFF_TICKS):
        raise AssertionError(f"phase 8: {vad_on} and {vad_off} VAD kernel "
                             f"launches over {ON_TICKS} and {OFF_TICKS} "
                             "ticks")
    phase("server", batch=B_MAIN, ticks=ON_TICKS, depth=DEPTH,
          blocks_equal_to_chain=len(blocks), kernel_launches=launches_on,
          pump_drain_thread_on=on.summary(),
          pump_drain_thread_off=dict(off.summary(), ticks=OFF_TICKS,
                                     depth=OFF_DEPTH,
                                     kernel_launches=launches_off),
          steady_pump_p50_ms_on=round(float(np.median(on.samples[4:])), 3),
          output_latency_ms_on={
              "p50": round(float(np.median(lat_on[0])), 3),
              "max": round(max(lat_on[0]), 3)},
          output_latency_ticks_on={
              "p50": float(np.median(lat_on[1])), "max": max(lat_on[1])},
          bytes_per_tick_to_card=2 * mic[0].nbytes,
          bytes_per_tick_to_host=sum(b.nbytes for b in blocks[0]),
          pinned_bytes=srv.pinned_bytes, init_s=round(init_s, 3))
    return {"8": launches_on, "8_drain_off": launches_off}


def socket_dir() -> str:
    """A fresh directory for a Unix socket whose path stays under the 100
    bytes a socket address holds: the temporary directory, or, where that
    one's name is too long, one under the current directory, named
    relative to it."""
    d = tempfile.mkdtemp(prefix="wmix")
    if len(os.path.join(d, "s.sock").encode()) < 100:
        return d
    os.rmdir(d)
    return os.path.relpath(tempfile.mkdtemp(prefix="wmix", dir=os.getcwd()))


def phase_daemon(aec_package, kernels) -> int:
    """9. nine socket clients through the full chain; pass-through and
    capacity checks on a second daemon."""
    from wmix_tpu_torch.service.stream_daemon import (StreamDaemon,
                                                      StreamSocketClient)
    N_PKG, N_FIRST, WAIT = 8, 8, 120.0
    tmp = socket_dir()
    try:
        path = os.path.join(tmp, "s.sock")
        kernels.load("aec_package")     # as main() does, before clients
        aec0 = kernels.launched("aec_package")
        d = StreamDaemon(path, capacity=64, realtime=False)
        d.start()
        results, errors = {}, []
        had3 = threading.Semaphore(0)

        def client_run(seed, late):
            try:
                if late:
                    for _ in range(N_FIRST):
                        if not had3.acquire(timeout=WAIT):
                            raise TimeoutError("the others never had 3")
                c = StreamSocketClient(path)
                c.sock.settimeout(WAIT)
                c.open()
                mic, play = audio(N_PKG, 1, seed=100 + seed)
                got = []
                for i in range(N_PKG):
                    c.feed(mic[i, 0], play[i, 0])
                    r = c.read_pkg(timeout=WAIT)
                    if r is None:
                        raise TimeoutError(f"client {seed} package {i}")
                    got.append(r)
                    if i == 2 and not late:
                        had3.release()
                c.close()
                results[seed] = got
            except Exception as e:      # reported by the main thread
                errors.append((seed, repr(e)))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client_run,
                                    args=(s, s == N_FIRST))
                   for s in range(N_FIRST + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * WAIT)
        serve_s = time.perf_counter() - t0
        stats = d.stats()
        d.stop()
        torch.cuda.synchronize()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"phase 9 clients: {errors}")
        for seed in range(N_FIRST + 1):
            got = results[seed]
            if len(got) != N_PKG or any(
                    pcm.shape != (320 + 160,) or pcm.dtype != np.int16 or
                    not isinstance(vad, int) for pcm, vad in got):
                raise AssertionError(f"phase 9 client {seed}: bad packages")
        launches = kernels.launched("aec_package") - aec0
        if launches <= 0 or stats["n"] <= 0:
            raise AssertionError(f"phase 9: launches {launches}, stats "
                                 f"{stats}")

        # pass-through daemon of capacity 1: samples come back unchanged,
        # one client after the other; a second OPEN meanwhile gets ERR
        p = StreamDaemon(path, capacity=1, realtime=False,
                         ns_enable=False, aec_enable=False,
                         agc_enable=False, vad_enable=False)
        p.start()
        try:
            rejected = None
            for seed in range(3):
                c = StreamSocketClient(path)
                c.sock.settimeout(WAIT)
                deadline = time.perf_counter() + WAIT
                while True:     # the last client's slot may not be free yet
                    try:
                        c.open()
                        break
                    except RuntimeError:
                        if time.perf_counter() > deadline:
                            raise
                        time.sleep(0.01)
                if seed == 0:
                    extra = StreamSocketClient(path)
                    extra.sock.settimeout(WAIT)
                    try:
                        extra.open()
                    except RuntimeError as e:
                        rejected = str(e)
                    extra.sock.close()
                mic, _ = audio(N_PKG, 1, seed=200 + seed)
                for i in range(N_PKG):
                    c.feed(mic[i, 0])
                    r = c.read_pkg(timeout=WAIT)
                    if r is None:
                        raise TimeoutError("pass-through package")
                    check_equal(f"phase 9 pass-through client {seed}",
                                r[0][:320], mic[i, 0])
                c.close()
        finally:
            p.stop()
        if rejected != "no free stream slots":
            raise AssertionError(f"phase 9: OPEN beyond capacity gave "
                                 f"{rejected!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("daemon", capacity=64, clients=N_FIRST + 1, packages_each=N_PKG,
          serve_s=round(serve_s, 3), kernel_launches=launches,
          pump=d.timer.summary(), passthrough_unchanged=3,
          open_beyond_capacity=rejected)
    return launches


def cuda_ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def phase_mixbus() -> None:
    """10. the mix bus and G.711 on the card against the CPU."""
    from wmix_tpu_torch.config import EngineConfig
    from wmix_tpu_torch.engine.mixbus import MixBus
    from wmix_tpu_torch.ops import g711
    cfg = EngineConfig(chn=1, freq=16000)
    S, T, R = 4, cfg.frame_num, cfg.ring_frames
    rng = np.random.RandomState(10)
    waves = rng.randint(-30000, 30000, (S, B_MAIN, T, 1)).astype(np.int16)
    heads = rng.randint(R - T, R, (S, B_MAIN)).astype(np.int32)  # wraps
    lens = rng.randint(0, T + 1, (S, B_MAIN)).astype(np.int32)
    rdces = rng.randint(1, 3, (S, B_MAIN)).astype(np.int32)
    buses = {d: MixBus(B_MAIN, cfg, device=d) for d in ("cuda", "cpu")}
    got = {}
    for d, bus in buses.items():
        # the play cursor sits where the waves land, so the drains carry
        # mixed audio and wrap too
        bus.head_off[:] = (R - T // 2) * cfg.frame_size
        bus.mix_waves(heads, waves, lens, rdces)
        first = bus.drain_async(1)
        second = bus.drain_async(1)
        got[d] = dict(pcm1=np.asarray(first), pcm2=np.asarray(second),
                      ring=bus.ring.cpu().numpy(), has_data=bus.has_data(),
                      head_off=bus.head_off.copy(), tick=bus.tick.copy())
    for k, v in got["cuda"].items():
        check_equal(f"phase 10 {k}, card vs cpu", v, got["cpu"][k])
    pcm = np.concatenate([got["cuda"]["pcm1"], got["cuda"]["pcm2"]], axis=1)
    if pcm.max() != 32767 or pcm.min() != -32768 or \
            not got["cuda"]["has_data"].any():
        raise AssertionError("phase 10: the scene neither saturated nor "
                             "left data")
    bus = buses["cuda"]
    mix_ms = [cuda_ms(lambda: bus.mix_waves(heads, waves, lens, rdces))
              for _ in range(5)]
    pend = []
    drain_ms = [cuda_ms(lambda: pend.append(bus.drain_async(1)))
                for _ in range(5)]
    for x in pend:
        x.result()

    # G.711: every int16 value and every code, against the tables
    enc_a, enc_u, dec_a, dec_u = g711.tables()
    pcm_all = torch.arange(-32768, 32768, dtype=torch.int32,
                           device="cuda").to(torch.int16)
    codes = torch.arange(256, dtype=torch.int32, device="cuda").to(
        torch.uint8)
    check_equal("encode_alaw", g711.encode_alaw(pcm_all), enc_a)
    check_equal("encode_ulaw", g711.encode_ulaw(pcm_all), enc_u)
    check_equal("decode_alaw", g711.decode_alaw(codes), dec_a)
    check_equal("decode_ulaw", g711.decode_ulaw(codes), dec_u)
    phase("mixbus", batch=B_MAIN, ring_bytes=bus.ring.numel() * 2,
          waves=S, card_equals_cpu=sorted(got["cuda"]),
          mix_waves_ms=round(float(np.median(mix_ms)), 4),
          drain_async_ms=round(float(np.median(drain_ms)), 4),
          g711_equal_to_tables=True)


def run_chain_on_card(aec_package, freq, kw, n_pkgs, n_timed, seed):
    """A fresh RecordChain(B_MAIN, freq, **kw) on the card and one of 4
    streams on the CPU, built in the environment's mode, over `n_pkgs`
    packages of seeded audio (the CPU chain gets the first 4 streams).
    Returns the outputs of those 4 streams from both, both chains, the
    card's ms per package over the last `n_timed`, and the kernel
    launches (the AGC and VAD kernels' must be one a package where their
    stage is on)."""
    from wmix_tpu_torch.engine.chain import RecordChain
    n = freq // 1000 * kw.get("interval_ms", 20) * kw.get("chn", 1)
    rng = np.random.RandomState(seed)
    mic = (rng.randn(n_pkgs, B_MAIN, n) * 3000).astype(np.int16)
    play = (rng.randn(n_pkgs, B_MAIN, n) * 5000).astype(np.int16)
    mic_d = torch.from_numpy(mic).cuda()
    play_d = torch.from_numpy(play).cuda()
    aec0 = kernels.launched("aec_package")
    agc_launched, vad_launched = (kernels.launched("agc"),
                                  kernels.launched("vad"))
    card_chain = RecordChain(B_MAIN, freq, **kw)    # default: the card
    if card_chain.device.type != "cuda":
        raise AssertionError("the chain's default device is not the card")
    got = []
    for k in range(n_pkgs):
        if k == n_pkgs - n_timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        got.append([v[:4].cpu() for v in card_chain.step(mic_d[k],
                                                         play_d[k])])
    torch.cuda.synchronize()
    pkg_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    launches = kernels.launched("aec_package") - aec0
    agc_want = n_pkgs if card_chain.flags[2] else 0
    agc_n = kernels.launched("agc") - agc_launched
    if agc_n != agc_want:
        raise AssertionError(f"{agc_n} AGC kernel launches over {n_pkgs} "
                             f"packages, {agc_want} wanted")
    vad_want = n_pkgs if card_chain.flags[3] else 0
    vad_n = kernels.launched("vad") - vad_launched
    if vad_n != vad_want:
        raise AssertionError(f"{vad_n} VAD kernel launches over {n_pkgs} "
                             f"packages, {vad_want} wanted")
    if int(card_chain.aec_nonfinite):
        raise AssertionError("non-finite AEC output samples")
    cpu_chain = RecordChain(4, freq, device="cpu", **kw)
    want = [[v.clone() for v in cpu_chain.step(mic[k, :4], play[k, :4])]
            for k in range(n_pkgs)]
    n8k = 8 * kw.get("interval_ms", 20)
    for o, p8, vf in got:
        if (o.dtype, p8.dtype, tuple(o.shape), tuple(p8.shape),
                tuple(vf.shape)) != (torch.int16, torch.int16, (4, n),
                                     (4, n8k), (4,)):
            raise AssertionError("chain output shapes or types")
    return got, want, card_chain, cpu_chain, pkg_ms, launches


def compare_outputs(got, want):
    """(max LSB of origin, of pkg8k, VAD flags equal, share of equal origin
    samples) between two lists of (origin, pkg8k, vflags)."""
    d = torch.stack([(g[0].int() - w[0].int()).abs()
                     for g, w in zip(got, want)])
    d8 = torch.stack([(g[1].int() - w[1].int()).abs()
                      for g, w in zip(got, want)])
    vad = all(bool(torch.equal(g[2], w[2])) for g, w in zip(got, want))
    return int(d.max()), int(d8.max()), vad, float((d == 0).float().mean())


def phase_geometries(aec_package, main_pkg_ms, name_power) -> dict:
    """11. every other geometry at full width on the card, fast mode."""
    N, TIMED = 12, 6
    cases = [
        ("8k_mono", 8000, {}, LSB, 0),
        ("16k_stereo", 16000, dict(chn=2), LSB, N - 4),
        ("32k_mono", 32000, {}, LSB, 0),
        ("16k_10ms_no_aec", 16000, dict(interval_ms=10, aec_enable=False),
         LSB, 0),
        ("32k_mono_no_ns", 32000, dict(ns_enable=False), 0, 0),
    ]
    rows, launches_by_case = {}, {}
    for i, (name, freq, kw, lsb, want_launches) in enumerate(cases):
        got, want, card_chain, _cpu, pkg_ms, launches = run_chain_on_card(
            aec_package, freq, kw, N, TIMED, seed=20 + i)
        if not card_chain.fast:
            raise AssertionError("phase 11 runs in fast mode")
        d, d8, vad, share = compare_outputs(got, want)
        if d > lsb or d8 > lsb or not vad:
            raise AssertionError(f"phase 11 {name}: card vs cpu {d} and "
                                 f"{d8} LSB (gate {lsb}), VAD equal {vad}")
        if launches != want_launches:
            raise AssertionError(f"phase 11 {name}: {launches} kernel "
                                 f"launches, expected {want_launches}")
        kernel_layout = isinstance(card_chain.state.aec,
                                   aec_package.PackageAecState)
        if kernel_layout != (want_launches > 0):
            raise AssertionError(f"phase 11 {name}: AEC layout")
        if not any(bool(g[0].any()) for g in got):
            raise AssertionError(f"phase 11 {name}: silent output")
        launches_by_case[name] = launches
        rows[name] = dict(
            freq=freq, **kw, packages=N, max_lsb_origin=d, max_lsb_8k=d8,
            vad_flags_equal=vad, equal_share=round(share, 6), gate_lsb=lsb,
            steady_pkg_ms=round(pkg_ms, 3),
            over_16k_mono=round(pkg_ms / main_pkg_ms, 3),
            kernel_launches=launches)
    phase("geometries", batch=B_MAIN, card=name_power,
          pkg_ms_16k_mono_phase3=round(main_pkg_ms, 3), **rows)
    return launches_by_case


def transcendental_mismatches() -> dict:
    """How many of 2^20 inputs each give another float32 on the card than
    on the CPU through (float)f((double)x)."""
    from wmix_tpu_torch.dsp import floatops
    rng = np.random.RandomState(12)
    n = 1 << 20
    pos = torch.from_numpy((10.0 ** rng.uniform(-6, 9, n)).astype(np.float32))
    sym = torch.from_numpy((rng.randn(n) * 8).astype(np.float32))
    unit = torch.from_numpy(rng.uniform(0.01, 1, n).astype(np.float32))
    expo = torch.from_numpy(rng.uniform(1, 12, n).astype(np.float32))
    out = {}
    for name, args in (("flog", (pos,)), ("fexp", (sym,)), ("ftanh", (sym,)),
                       ("fcosf", (sym,)), ("fsinf", (sym,)),
                       ("fpowf", (unit, expo)),
                       ("fpow_div", (pos, pos.flip(0), unit))):
        fn = getattr(floatops, name)
        a = fn(*args)
        b = fn(*(x.cuda() for x in args)).cpu()
        out[name] = int((a != b).sum())
    return out


def phase_exact(aec_package, main_pkg_ms, name_power) -> int:
    """12. exact mode on the card against exact mode on the CPU."""
    from wmix_tpu_torch.dsp.floatops import mode_env
    from wmix_tpu_torch.engine.checkpoint import _leaves
    N, TIMED = 10, 4
    with mode_env(True):
        got, want, card_chain, cpu_chain, pkg_ms, launches = \
            run_chain_on_card(aec_package, 16000, {}, N, TIMED, seed=30)
    if card_chain.fast or cpu_chain.fast:
        raise AssertionError("phase 12: the chains are not in exact mode")
    if launches != 0 or isinstance(card_chain.state.aec,
                                   aec_package.PackageAecState):
        raise AssertionError(f"phase 12: exact mode launched the kernel "
                             f"{launches} times")
    d, d8, vad, share = compare_outputs(got, want)
    leaves = [(a[:4].cpu(), b) for a, b in
              zip(_leaves(card_chain.state), _leaves(cpu_chain.state))]
    unequal = sum(not torch.equal(a, b) for a, b in leaves)
    int_unequal = sum(not torch.equal(a, b) for a, b in leaves
                      if not a.is_floating_point())
    mism = None
    if d or d8 or not vad or unequal:
        # equal is the gate; 1 LSB only where the card's float64 library
        # functions are shown to differ from the CPU's
        mism = transcendental_mismatches()
        if not any(mism.values()) or d > 1 or d8 > 1 or not vad or \
                int_unequal:
            raise AssertionError(
                f"phase 12: card vs cpu exact chain {d} and {d8} LSB, VAD "
                f"equal {vad}, {unequal} state leaves differ "
                f"({int_unequal} integer); float64 functions differing on "
                f"2^20 inputs: {mism}")
    phase("exact_mode", batch=B_MAIN, card=name_power, packages=N,
          kernel_launches=launches, max_lsb_origin=d, max_lsb_8k=d8,
          vad_flags_equal=vad, equal_share=round(share, 6),
          state_leaves=len(leaves), state_leaves_unequal=unequal,
          gate="equal" if mism is None else "1 LSB, integer leaves equal",
          float64_function_mismatches=mism,
          pkg_ms=round(pkg_ms, 3), fast_pkg_ms_phase3=round(main_pkg_ms, 3),
          exact_over_fast=round(pkg_ms / main_pkg_ms, 3))
    return launches


def counted_step(chain, seed) -> dict:
    """The aten operations of one package of `chain` on its device."""
    n = chain.pkg_len * chain.chn
    rng = np.random.RandomState(seed)
    mic = torch.from_numpy((rng.randn(chain.batch, n) * 3000).astype(
        np.int16)).cuda()
    play = torch.from_numpy((rng.randn(chain.batch, n) * 5000).astype(
        np.int16)).cuda()
    return counted(lambda: chain.step(mic, play))


def phase_integer(aec_package, main_chain, main_pkg_ms, name_power):
    """13. the integer chain (AECM + NSX) on the card against the CPU;
    returns its kernel launches and the aten operations of one package of
    phase 3's chain."""
    from wmix_tpu_torch.engine.checkpoint import _leaves
    kw = dict(aec_backend="aecm", ns_backend="nsx")
    rows, launches = {}, 0
    for i, (name, freq, n, timed) in enumerate((("16k", 16000, 26, 6),
                                                ("8k", 8000, 12, 6))):
        got, want, card_chain, cpu_chain, pkg_ms, nl = run_chain_on_card(
            aec_package, freq, kw, n, timed, seed=40 + i)
        d, d8, vad, share = compare_outputs(got, want)
        leaves = [(a[:4].cpu(), b) for a, b in
                  zip(_leaves(card_chain.state), _leaves(cpu_chain.state))]
        unequal = sum(not torch.equal(a, b) for a, b in leaves)
        if d or d8 or not vad or unequal:
            raise AssertionError(
                f"phase 13 {name}: card vs cpu integer chain {d} and {d8} "
                f"LSB, VAD equal {vad}, {unequal} of {len(leaves)} state "
                "leaves differ")
        if nl or card_chain.aec_backend != "aecm" or \
                card_chain.ns_backend != "nsx" or \
                card_chain.planner.ec_startup:
            raise AssertionError(f"phase 13 {name}: {nl} kernel launches, "
                                 "or the AECM never left its start-up")
        if not any(bool(g[0].any()) for g in got):
            raise AssertionError(f"phase 13 {name}: silent output")
        launches += nl
        rows[name] = dict(
            freq=freq, packages=n, max_lsb_origin=d, max_lsb_8k=d8,
            vad_flags_equal=vad, state_leaves=len(leaves),
            state_leaves_unequal=unequal, kernel_launches=nl,
            pkg_ms=round(pkg_ms, 3),
            over_16k_mono_fast=round(pkg_ms / main_pkg_ms, 3),
            aten_ops_per_pkg=counted_step(card_chain, seed=50 + i))
    ops3 = counted_step(main_chain, seed=52)
    phase("integer_chain", batch=B_MAIN, card=name_power,
          pkg_ms_16k_mono_fast_phase3=round(main_pkg_ms, 3),
          aten_ops_per_pkg_phase3=ops3, **rows)
    return launches, ops3


# The device codec halves (phase 14) and the batch decoders (15); phase
# 14's CPU replay takes the first CPU_SYNTH streams and CPU_FB_SLOTS slots
# (every stream was compared in four runs before phase 16 was added)
B_SYNTH, FB_SLOTS, B_DEC = 4096, 8192, 128
CPU_SYNTH, CPU_FB_SLOTS = 512, 1024
MP3_FRAME_S, AAC_SAMPLES = 1152 / 44100, 1024
# the ten-frame window walk of tests/test_aac_batch.py: (sequence, shape)
FB_WALK = [(0, 0), (1, 0), (2, 1), (2, 1), (3, 0), (0, 0), (1, 1), (2, 0),
           (3, 1), (0, 1)]
# the mixed tick after the walk (every slot's previous shape is 1)
FB_GROUPS = [(0, 0), (2, 1), (3, 1)]


def counted(fn) -> dict:
    """The aten operations of one call of `fn` on the card, and the bytes
    they read and write (`utils.trace.OpCounter`)."""
    from wmix_tpu_torch.utils.trace import OpCounter
    torch.cuda.synchronize()
    with OpCounter() as c:
        fn()
    torch.cuda.synchronize()
    return {"ops": c.ops, "launching": c.launching, "bytes": c.bytes}


def device_busy(fn) -> dict | None:
    """The device's busy time in one call of `fn`: the summed durations of
    the device's own events (kernels, copies, fills) in a `torch.profiler`
    trace, and how many there were.  The aten operation that launched an
    event carries its duration again in its own device totals, so only the
    events that lie on the device are summed, as the profiler's own table
    sums them.  None where the trace shows no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
    if not on_device:
        return None
    us = sum(e.time_range.end - e.time_range.start for e in on_device)
    return {"busy_ms": round(us / 1e3, 3), "device_events": len(on_device)}


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits, so that equality is bitwise."""
    return t.contiguous().view(torch.int32)


def prediction(count: dict, per_op_ms: float) -> dict:
    """The larger of the host's time for the launches (phase 3's cost per
    operation) and the device's for the bytes at the memory rate."""
    host = count["launching"] * per_op_ms
    mem = count["bytes"] / PEAK_BYTES_PER_S * 1e3
    return {"host_ms": round(host, 3), "bytes_ms": round(mem, 3),
            "predicted_ms": round(max(host, mem), 3)}


def phase_codec_device(aec_package, per_op_ms, name_power) -> int:
    """14. the device codec halves at full width, card against CPU."""
    from wmix_tpu_torch.codecs.aac_batch import BatchedFilterbank
    from wmix_tpu_torch.codecs.mp3_batch import BatchedSynth
    aec0 = kernels.launched("aec_package")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(14)
    frames = [(2, 36)] * 8 + [(1, 36)] * 4
    resets = {3: np.arange(0, B_SYNTH, 7), 9: np.arange(3, B_SYNTH, 11)}
    sbs = [rng.randint(-(1 << 28), 1 << 28, size=(B_SYNTH, 2, 36, 32))
           .astype(np.int32) for _ in frames]
    specs = [(rng.randn(FB_SLOTS, 1024) * 50).astype(np.float32)
             for _ in FB_WALK]
    tick_specs = (rng.randn(FB_SLOTS, 1024) * 50).astype(np.float32)
    res, secs = {}, {}
    synth_ms, fb_ms = [], []
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        card = d == "cuda"
        ns_, nf = (B_SYNTH, FB_SLOTS) if card else (CPU_SYNTH, CPU_FB_SLOTS)
        synth = BatchedSynth(B_SYNTH) if card else \
            BatchedSynth(ns_, device="cpu")
        if synth.device.type != d:
            raise AssertionError("phase 14: BatchedSynth's default device "
                                 "is not the card")
        pcm = []
        for f, ((nch, ns), sb) in enumerate(zip(frames, sbs)):
            if f in resets:
                synth.reset(resets[f][resets[f] < ns_])
            x = torch.from_numpy(sb[:ns_]).to(synth.device)
            out = []

            def run():
                out.append(synth.frame(x, nch, ns))

            if card:
                synth_ms.append((nch, cuda_ms(run)))
            else:
                run()
            pcm.append(out[0].cpu())
        fb = BatchedFilterbank(FB_SLOTS) if card else \
            BatchedFilterbank(nf, device="cpu")
        idx = np.arange(nf)
        walk = []
        for (seq, shape), sp in zip(FB_WALK, specs):
            x = torch.from_numpy(sp[:nf]).to(fb.device)
            out = []

            def run():
                out.append(fb.frame_stacked(idx, seq, shape, x))

            if card:
                fb_ms.append((seq, cuda_ms(run)))
            else:
                run()
            walk.append(out[0].cpu())
        jobs = [(s, *FB_GROUPS[s % 3], tick_specs[s]) for s in range(nf)]
        if card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        tick = fb.frame(jobs)
        tick_ms = (time.perf_counter() - t1) * 1e3
        # the first CPU_SYNTH streams and CPU_FB_SLOTS slots of each
        res[d] = {"pcm": torch.stack(pcm[:8])[:, :CPU_SYNTH],
                  "pcm_mono": torch.stack(pcm[8:])[:, :CPU_SYNTH],
                  "hist": synth.hist.cpu()[:CPU_SYNTH],
                  "phase": synth.phase.cpu()[:CPU_SYNTH],
                  "time_out": bits(torch.stack(walk)[:, :CPU_FB_SLOTS]),
                  "tick_time_out": bits(torch.from_numpy(
                      np.stack([tick[s] for s in range(CPU_FB_SLOTS)]))),
                  "overlap": bits(fb.overlap.cpu()[:CPU_FB_SLOTS]),
                  "shape_prev": fb.shape_prev.cpu()[:CPU_FB_SLOTS]}
        if card:
            card_synth, card_fb, card_tick_ms = synth, fb, tick_ms
            card_idx, card_jobs = idx, jobs
        secs[d] = time.perf_counter() - t0
    for k, v in res["cuda"].items():
        check_equal(f"phase 14 {k}, card vs cpu", v, res["cpu"][k])
    if not res["cuda"]["pcm"].any() or not res["cuda"]["pcm_mono"].any() or \
            not bool((bits(card_fb.overlap) != 0).any()):
        raise AssertionError("phase 14: silent output")
    # one more frame of each kind, counted
    x = torch.from_numpy(sbs[0]).cuda()
    ops = {"synth_stereo": counted(lambda: card_synth.frame(x, 2, 36)),
           "synth_mono": counted(lambda: card_synth.frame(x, 1, 36))}
    x = torch.from_numpy(specs[0]).cuda()
    fresh = BatchedFilterbank(FB_SLOTS)     # every slot's previous shape 0
    for seq, name in enumerate(("long", "start", "short", "stop")):
        ops[f"fb_{name}"] = counted(lambda: fresh.frame_stacked(
            card_idx, seq, 0, x))
    ops["fb_mixed_tick"] = counted(lambda: card_fb.frame(card_jobs))
    x = torch.from_numpy(sbs[0]).cuda()
    busy = {"synth_stereo": device_busy(lambda: card_synth.frame(x, 2, 36))}
    x = torch.from_numpy(specs[0]).cuda()
    for seq, name in ((0, "long"), (2, "short")):
        busy[f"fb_{name}"] = device_busy(
            lambda: fresh.frame_stacked(card_idx, seq, 0, x))
    launches = kernels.launched("aec_package") - aec0
    if launches:
        raise AssertionError(f"phase 14: {launches} AEC kernel launches")
    stereo = [ms for nch, ms in synth_ms[1:] if nch == 2]
    mono = [ms for nch, ms in synth_ms if nch == 1]
    fb_by_seq = {seq: round(float(np.median([ms for s, ms in fb_ms
                                             if s == seq])), 3)
                 for seq in range(4)}
    fb_med = float(np.median([ms for _, ms in fb_ms[1:]]))
    st_med = float(np.median(stereo))
    # the idle share of a frame: its busy time against the median time of
    # frames of its kind
    for k, ms in (("synth_stereo", st_med), ("fb_long", fb_by_seq[0]),
                  ("fb_short", fb_by_seq[2])):
        if busy[k] is not None:
            busy[k]["idle_share"] = round(1 - busy[k]["busy_ms"] / ms, 3)
    phase("codec_device", card=name_power, synth_batch=B_SYNTH,
          fb_slots=FB_SLOTS, card_equals_cpu=sorted(res["cuda"]),
          cpu_streams_compared={"synth": CPU_SYNTH,
                                "fb_slots": CPU_FB_SLOTS},
          seconds={d: round(v, 3) for d, v in secs.items()},
          synth_stereo_ms=round(st_med, 3),
          synth_mono_ms=round(float(np.median(mono)), 3),
          synth_ms_each=[round(ms, 3) for _, ms in synth_ms],
          synth_streams=round(B_SYNTH * MP3_FRAME_S / (st_med / 1e3), 1),
          fb_ms=round(fb_med, 3), fb_ms_by_sequence=fb_by_seq,
          fb_ms_each=[round(ms, 3) for _, ms in fb_ms],
          fb_streams=round(FB_SLOTS // 2 * AAC_SAMPLES / 44100 /
                           (fb_med / 1e3), 1),
          fb_mixed_tick_ms_wall=round(card_tick_ms, 3),
          aten_ops_per_frame=ops, device_busy_per_frame=busy,
          state_bytes_per_frame={
              "synth_stereo": B_SYNTH * (2 * 36 * 32 * 4 + 2 * 2 * 2 * 16 *
                                         16 * 4 + 2 * 4 + 2 * 36 * 32 * 2),
              "fb": FB_SLOTS * 1024 * 4 * 4},
          per_op_ms_phase3=round(per_op_ms, 5),
          predicted={k: prediction(v, per_op_ms) for k, v in ops.items()},
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
          kernel_launches=launches)
    return launches


def decode_all(make, streams, starts, frame_s):
    """Tick a batch decoder until every stream has ended: stream b starts
    at tick starts[b].  Returns ({stream: [PCM of every frame]}, the ticks'
    finished lists, ms per tick, audio seconds decoded)."""
    dec = make()
    got = {b: [] for b in range(len(streams))}
    ended, dones, tick_ms = set(), [], []
    audio_s = 0.0
    t = 0
    while len(ended) < len(streams):
        for b, s in enumerate(starts):
            if t == s:
                dec.start(b, streams[b])
        t0 = time.perf_counter()
        pcms, done = dec.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if isinstance(pcms, dict):           # AAC: the emitted frames
            items = pcms.items()
        else:                                # MP3: [B, nch, n] or None
            items = [] if pcms is None else [
                (b, pcms[b]) for b in range(len(streams))
                if b not in ended and b not in done and t >= starts[b]]
        for b, pcm in items:
            got[b].append(np.asarray(pcm).copy())
            audio_s += frame_s[b]
        ended.update(done)
        dones.append(sorted(done))
        t += 1
        if t > 10_000:
            raise AssertionError("phase 15: a decoder never ended")
    return got, dones, tick_ms, audio_s


def phase_codec_decoders(aec_package, name_power) -> int:
    """15. the batch decoders end to end on the card against the CPU."""
    from wmix_tpu_torch.codecs.aac_batch import AacBatchDecoder
    from wmix_tpu_torch.codecs.mp3_batch import Mp3BatchDecoder
    data_dir = os.path.join(REPO, "tests", "data")

    def stream(name):
        with open(os.path.join(data_dir, "torch_codec_" + name), "rb") as f:
            return f.read()

    # the C front-ends must serve: a failed build would send every stream
    # to the Python front-ends without a word
    from wmix_tpu_torch.codecs import aacfe, mp3fe
    front_ends = {"mp3fe": mp3fe.available(), "aacfe": aacfe.available()}
    if not all(front_ends.values()):
        raise AssertionError(f"phase 15: C front-ends missing: {front_ends}")
    aec0 = kernels.launched("aec_package")
    aac = [stream("aac_44k_stereo.aac"), stream("aac_32k_mono.aac")]
    cases = {
        "aac": (AacBatchDecoder, B_DEC, [aac[b % 2] for b in range(B_DEC)],
                [AAC_SAMPLES / (44100, 32000)[b % 2] for b in range(B_DEC)],
                [b % 8 for b in range(B_DEC)]),
        "mp3_l3": (Mp3BatchDecoder, B_DEC, [stream("mp3_l3.mp3")] * B_DEC,
                   [MP3_FRAME_S] * B_DEC, [b % 8 for b in range(B_DEC)]),
        "mp3_l2": (Mp3BatchDecoder, 8, [stream("mp3_l2.mp3")] * 8,
                   [MP3_FRAME_S] * 8, [b % 4 for b in range(8)]),
    }
    rows = {}
    for name, (cls, B, streams, frame_s, starts) in cases.items():
        run = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            make = (lambda: cls(B)) if d == "cuda" else \
                (lambda: cls(B, device="cpu"))
            run[d] = decode_all(make, streams, starts, frame_s)
            run[d] += (time.perf_counter() - t0,)
        (got, dones, tick_ms, audio_s, secs), want = run["cuda"], run["cpu"]
        if dones != want[1]:
            raise AssertionError(f"phase 15 {name}: streams ended in "
                                 "other ticks on the card")
        frames = 0
        for b in range(B):
            if len(got[b]) != len(want[0][b]) or not got[b]:
                raise AssertionError(f"phase 15 {name} stream {b}: "
                                     f"{len(got[b])} frames on the card, "
                                     f"{len(want[0][b])} on the cpu")
            for i, (g, w) in enumerate(zip(got[b], want[0][b])):
                check_equal(f"phase 15 {name} stream {b} frame {i}", g, w)
            frames += len(got[b])
        if not any(g.any() for g in got[0]):
            raise AssertionError(f"phase 15 {name}: silent output")
        rows[name] = dict(
            batch=B, ticks=len(tick_ms), frames_equal=frames,
            tick_ms_median=round(float(np.median(tick_ms)), 3),
            tick_ms_max=round(max(tick_ms), 3),
            streams=round(audio_s / (sum(tick_ms) / 1e3), 1),
            seconds={"cuda": round(secs, 3), "cpu": round(want[4], 3)})
    launches = kernels.launched("aec_package") - aec0
    if launches:
        raise AssertionError(f"phase 15: {launches} AEC kernel launches")
    phase("codec_decoders", card=name_power, card_equals_cpu=True,
          c_front_ends=front_ends, kernel_launches=launches, **rows)
    return launches


# The daemon core (phase 16)
N_DAEMONS, BRIDGE_CAP, DAEMON_TICKS, INLINE_PKGS = 256, 4096, 20, 20
EXACT_TICKS, INLINE_EXACT_PKGS = 8, 12


def daemon_mic(seed) -> bytes:
    """Two seconds of seeded microphone noise (sigma 3000) at 16 kHz."""
    rng = np.random.RandomState(seed)
    return (rng.randn(32000) * 3000).astype(np.int16).tobytes()


def make_daemon(seed, device, bridge=None, **kw):
    """A 16 kHz mono WmixDaemon on LoopHal with NS, AEC, AGC and VAD on
    and a record task holding the record path open: its play loop, idle,
    runs one package a tick.  Returns (daemon, hal, delivered packages)."""
    from wmix_tpu_torch.config import EngineConfig
    from wmix_tpu_torch.service import core
    from wmix_tpu_torch.service.hal import LoopHal
    hal = LoopHal()
    hal.feed_mic(daemon_mic(seed))
    d = core.WmixDaemon(EngineConfig(chn=1, freq=16000), hal=hal,
                        msg_queue=kw.get("msg_queue", False),
                        shmem=kw.get("shmem", False), device=device)
    for i in (core.WR_VAD, core.WR_AEC, core.WR_NS, core.WR_AGC):
        d.webrtc_enable[i] = 1
    d.thread_record = 1
    got = []
    out = d._record_out
    d._record_out = lambda buf: (got.append(np.array(buf, np.int16)),
                                 out(buf))
    if bridge is not None:
        bridge.attach(d)
    return d, hal, got


def run_bridge(capacity, device, ticks=None):
    """N_DAEMONS daemons on one EngineBridge, `ticks` ticks; returns the
    packages each received [n, 320], ms per tick of the pumps and of
    bridge.tick, and the bridge."""
    from wmix_tpu_torch.service.engine_bridge import EngineBridge
    bridge = EngineBridge(capacity, 16000, device=device)
    ds = [make_daemon(1000 + i, device, bridge) for i in range(N_DAEMONS)]
    pump_ms, tick_ms = [], []
    for _ in range(ticks or DAEMON_TICKS):
        t0 = time.perf_counter()
        for d, _hal, _got in ds:
            d.pump(1)
        t1 = time.perf_counter()
        bridge.tick()           # blocks on its outputs
        t2 = time.perf_counter()
        pump_ms.append((t1 - t0) * 1e3)
        tick_ms.append((t2 - t1) * 1e3)
    for d, _hal, _got in ds:
        if not bridge.accepts(d):
            raise AssertionError("phase 16: a daemon left the bridge")
        bridge.detach(d)
        d.stop()
    return np.stack([np.stack(got) for _d, _h, got in ds]), pump_ms, \
        tick_ms, bridge


def lsb_stats(got, want) -> dict:
    """Card against CPU over [daemon, package, sample]: the largest
    difference, how many packages and daemons exceed 4 LSB, the share of
    equal samples."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return {"max_lsb": int(d.max()),
            "packages_over_4_lsb": int((d.max(axis=2) > LSB).sum()),
            "daemons_over_4_lsb": int((d.max(axis=(1, 2)) > LSB).sum()),
            "equal_share": round(float((d == 0).mean()), 4)}


def ms_summary(xs) -> dict:
    """Median and max past the first five (start-up) ticks (of all, in a
    shorter run), and the first."""
    steady = xs[5:] or xs
    return {"p50": round(float(np.median(steady)), 3),
            "max": round(float(max(steady)), 3),
            "first": round(xs[0], 3), "budget_ms": 20.0}


def short_dir() -> str:
    """A fresh directory whose path leaves room in a 128-byte message for
    an audio path and a task's queue path (WMIX_MSG_BUFF_SIZE)."""
    d = tempfile.mkdtemp(prefix="wm")
    if len(d) < 40:
        return d
    os.rmdir(d)
    return os.path.relpath(tempfile.mkdtemp(prefix="wm", dir=os.getcwd()))


def control_plane_run(device, wav_path):
    """A realtime daemon on `device`, its queue and rings under the
    current MSG_PATH, no DSP module on: `client.play` of the WAV, then
    `client.mem_1x8000`.  Returns (speaker samples from the first nonzero
    one to the last, the 8 kHz record read)."""
    from wmix_tpu_torch.service import client
    d, hal, _got = make_daemon(77, device, msg_queue=True, shmem=True)
    d.thread_record = 0
    d.webrtc_enable[:] = [0] * len(d.webrtc_enable)
    d.start()
    try:
        if client.play(wav_path, order=2) <= 0:
            raise AssertionError("phase 16: client.play gave no task id")
        deadline = time.perf_counter() + 60
        while True:
            time.sleep(0.05)
            if d.thread_play == 0 and not d.tick_has_data() and \
                    np.frombuffer(bytes(hal.played), np.int16).any():
                break
            if time.perf_counter() > deadline:
                raise AssertionError("phase 16: the WAV never finished")
        rec = client.mem_1x8000(800, wait=True)
    finally:
        d.stop()
    played = np.frombuffer(bytes(hal.played), np.int16)
    nz = np.nonzero(played)[0]
    if not nz.size:
        raise AssertionError("phase 16: nothing reached the speaker")
    return played[nz[0]:nz[-1] + 1], rec


def remove_rings(path) -> None:
    """Remove the shared-memory rings a daemon made under `path`."""
    import ctypes
    from wmix_tpu_torch.service import sysv
    libc = ctypes.CDLL(None)
    for ch in (sysv.MEM_AI_1X8000_CHAR, sysv.MEM_AI_ORIGIN_CHAR):
        shm_id = libc.shmget(sysv.ftok(path, ord(ch)), 0, 0)
        if shm_id != -1:
            libc.shmctl(shm_id, sysv.IPC_RMID, None)


def inline_run(device, n_pkgs, timed=False):
    """One inline daemon (make_daemon(5)): its delivered packages [n, 320],
    ms per heartbeat (`timed`, the card) and the aten operations of the
    last heartbeat (`timed`)."""
    from wmix_tpu_torch.utils.trace import OpCounter
    d, _hal, pk = make_daemon(5, device)
    d.pump(1)                       # the record path opens
    hb_ms, ops = [], None
    for k in range(n_pkgs):
        if timed and k == n_pkgs - 1:
            with OpCounter() as c:
                d.pump(1)
            ops = {"ops": c.ops, "launching": c.launching}
            continue
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.pump(1)
        hb_ms.append((time.perf_counter() - t0) * 1e3)
    aec_dev = d._webrtc[1].aec.state.near_fr.device.type
    d.stop()
    if aec_dev != torch.device(device).type:
        raise AssertionError(f"phase 16: the inline AEC ran on {aec_dev}")
    return np.stack(pk), hb_ms, ops


def phase_daemon_core(aec_package, name_power) -> int:
    """16. the daemon core on the card: N_DAEMONS daemons on an
    EngineBridge of the north-star width, one inline daemon, the control
    plane end to end."""
    from wmix_tpu_torch.codecs import wav as wavc
    from wmix_tpu_torch.dsp.floatops import mode_env
    from wmix_tpu_torch.engine.chain import RecordChain
    from wmix_tpu_torch.service import sysv

    from wmix_tpu_torch.ops import stepper
    if stepper._lib() is None:
        raise AssertionError("phase 16: the native stepper did not load")

    # the bridge at full width, fast mode: the kernel's launches, and the
    # bridged packages equal to the same chain driven directly
    aec0 = kernels.launched("aec_package")
    t0 = time.perf_counter()
    got, pump_ms, tick_ms, bridge = run_bridge(BRIDGE_CAP, None)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = kernels.launched("aec_package") - aec0
    n_pkgs = got.shape[1]
    if launches != n_pkgs - 4:
        raise AssertionError(f"phase 16: {launches} kernel launches over "
                             f"{n_pkgs} packages")
    if bridge.server.chain.device.type != "cuda" or \
            not isinstance(bridge.server.chain.state.aec,
                           aec_package.PackageAecState):
        raise AssertionError("phase 16: the bridge is not on the card in "
                             "the kernel layout")
    if not got[:, -1].any(axis=1).all():
        raise AssertionError("phase 16: a daemon received silence")
    # the k-th package fed is the microphone's (k+1)-th: the record path's
    # opening reads and drops one; the far end of an idle daemon is silent
    direct = RecordChain(BRIDGE_CAP, 16000)
    mic = np.zeros((BRIDGE_CAP, 320), np.int16)
    mics = np.stack([np.frombuffer(daemon_mic(1000 + i), np.int16)
                     for i in range(N_DAEMONS)])
    for k in range(n_pkgs):
        mic[:N_DAEMONS] = mics[:, (k + 1) * 320:(k + 2) * 320]
        origin = direct.step(mic, np.zeros_like(mic))[0]
        check_equal(f"phase 16 bridged daemons vs the chain, package {k}",
                    origin[:N_DAEMONS].cpu().numpy(), got[:, k])
    del direct
    # the same daemons through a CPU bridge, fast mode: measured
    t0 = time.perf_counter()
    want, _, cpu_tick_ms, _ = run_bridge(N_DAEMONS, "cpu")
    cpu_s = time.perf_counter() - t0
    if want.shape != got.shape:
        raise AssertionError("phase 16: the card and CPU bridges delivered "
                             "different package counts")
    fast_vs_cpu = lsb_stats(got, want)
    # ... and in exact mode, gated: every package of every daemon equal
    with mode_env(True):
        got_x, _, exact_tick_ms, bridge_x = run_bridge(
            BRIDGE_CAP, None, EXACT_TICKS)
        want_x, _, _, _ = run_bridge(N_DAEMONS, "cpu", EXACT_TICKS)
    if bridge_x.server.chain.fast or \
            bridge_x.server.chain.device.type != "cuda":
        raise AssertionError("phase 16: the exact bridge is not exact on "
                             "the card")
    check_equal("phase 16 exact bridge, card vs CPU, every daemon",
                got_x, want_x)

    # one inline daemon on the card: fast mode timed and measured against
    # the CPU, exact mode gated against the CPU
    inl, hb_ms, ops = inline_run("cuda", INLINE_PKGS, timed=True)
    inl_cpu, _, _ = inline_run("cpu", INLINE_PKGS)
    if inl.shape != (INLINE_PKGS, 320):
        raise AssertionError(f"phase 16: inline daemon delivered "
                             f"{inl.shape}")
    inline_fast = lsb_stats(inl[None], inl_cpu[None])
    if inline_fast["max_lsb"] > LSB:
        raise AssertionError(f"phase 16: inline daemon, card vs CPU "
                             f"{inline_fast['max_lsb']} LSB")
    with mode_env(True):
        inl_x, _, _ = inline_run("cuda", INLINE_EXACT_PKGS)
        inl_x_cpu, _, _ = inline_run("cpu", INLINE_EXACT_PKGS)
    check_equal("phase 16 exact inline daemon, card vs CPU", inl_x,
                inl_x_cpu)

    # the control plane, card and CPU, each under its own private MSG_PATH
    tmp = short_dir()
    saved = sysv.MSG_PATH
    try:
        wav_path = os.path.join(tmp, "t.wav")
        rng = np.random.RandomState(16)
        pcm = (rng.randn(1800) * 4000).astype(np.int16)   # 8 kHz, one chunk
        wavc.write(wav_path, pcm.tobytes(), 1, 8000)
        res = {}
        for device in ("cuda", "cpu"):
            sysv.MSG_PATH = os.path.join(tmp, device)
            try:
                res[device] = control_plane_run(device, wav_path)
            finally:
                remove_rings(sysv.MSG_PATH)
    finally:
        sysv.MSG_PATH = saved
        shutil.rmtree(tmp, ignore_errors=True)
    (play_card, rec_card), (play_cpu, _rec_cpu) = res["cuda"], res["cpu"]
    check_equal("phase 16 control plane: speaker, card vs CPU", play_card,
                play_cpu)
    if play_card.size < 3000 or rec_card.size != 800 or \
            not rec_card.any():
        raise AssertionError(f"phase 16: played {play_card.size} samples, "
                             f"record ring read {rec_card.size}")

    phase("daemon_core", card=name_power,
          bridge={"capacity": BRIDGE_CAP, "daemons": N_DAEMONS,
                  "ticks": DAEMON_TICKS, "packages_each": n_pkgs,
                  "pumps_ms_per_tick": ms_summary(pump_ms),
                  "bridge_tick_ms": ms_summary(tick_ms),
                  "kernel_launches": launches,
                  "equal_to_the_chain_driven_directly": True,
                  "card_s": round(card_s, 3),
                  "fast_vs_cpu_bridge": fast_vs_cpu,
                  "cpu_replay_s": round(cpu_s, 3),
                  "cpu_bridge_tick_ms": ms_summary(cpu_tick_ms),
                  "exact_ticks": EXACT_TICKS,
                  "exact_equal_to_cpu": True,
                  "exact_bridge_tick_ms": ms_summary(exact_tick_ms)},
          inline={"packages": INLINE_PKGS,
                  "heartbeat_ms": ms_summary(hb_ms),
                  "aten_ops_per_heartbeat": ops,
                  "fast_vs_cpu": inline_fast,
                  "exact_packages": INLINE_EXACT_PKGS,
                  "exact_equal_to_cpu": True},
          stepper_native=True,
          control_plane={"speaker_equal_to_cpu": True,
                         "samples_played": int(play_card.size),
                         "record_ring_read": int(rec_card.size),
                         "record_ring_peak": int(np.abs(
                             rec_card.astype(np.int32)).max())})
    return launches


# The stream batch over shards (phase 17)
SHARD_PKGS, SHARD_TIMED = 12, 6
B_SHARD_X, SHARD_X_PKGS = 1024, 8


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed_steps(chain, mic, play, n_pkgs, n_timed):
    """`n_pkgs` packages through `chain.step`; the outputs on the host
    and ms per package over the last `n_timed`."""
    outs = []
    for k in range(n_pkgs):
        if k == n_pkgs - n_timed:
            sync_all()
            t0 = time.perf_counter()
        outs.append(chain.step(mic[k], play[k]))
    sync_all()
    pkg_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    return [np.stack([o[j].cpu().numpy() for o in outs])
            for j in range(3)], pkg_ms


def phase_sharded(aec_package, mic_d, play_d, main_origin, main_pkg_ms,
                  name_power) -> int:
    """17. ShardedRecordChain at full width: one shard a card on every
    visible card, or two shards on cuda:0 when there is one card.
    `main_origin` is RecordChain(4096)'s origin over the same packages
    (numpy), `main_pkg_ms` its ms per package."""
    from wmix_tpu_torch.dsp.floatops import mode_env
    from wmix_tpu_torch.engine.chain import RecordChain, ShardedRecordChain
    from wmix_tpu_torch.engine.checkpoint import _leaves
    from wmix_tpu_torch.multichip import dryrun_multichip
    n_cards = torch.cuda.device_count()
    shards = n_cards if n_cards >= 2 else 2
    devices = [f"cuda:{i % n_cards}" for i in range(shards)]

    # fast mode, the kernel on every shard's device
    aec0 = kernels.launched("aec_package")
    by0 = {d: kernels.launches[("aec_package", d)] for d in devices}
    sh = ShardedRecordChain(B_MAIN, 16000, shards=shards, devices=devices)
    got, sh_ms = timed_steps(sh, mic_d, play_d, SHARD_PKGS, SHARD_TIMED)
    launches = kernels.launched("aec_package") - aec0
    by_device = {d: kernels.launches[("aec_package", d)] - by0[d]
                 for d in devices}
    want_by_device = {}
    for d in devices:
        want_by_device[d] = want_by_device.get(d, 0) + SHARD_PKGS - 4
    if by_device != want_by_device or not all(
            isinstance(st.aec, aec_package.PackageAecState)
            for st in sh.state):
        raise AssertionError(f"phase 17: kernel launches by device "
                             f"{by_device}, expected {want_by_device}")
    if not got[0][-1].any(axis=1).all():
        raise AssertionError("phase 17: a stream is silent")
    # each shard against a dedicated chain of its width on its slots
    one_ms = []
    for (_ch, lo, hi), d in zip(sh.shard_ranges(), devices):
        one = RecordChain(hi - lo, 16000, device=d)
        want, ms = timed_steps(one, mic_d[:, lo:hi], play_d[:, lo:hi],
                               SHARD_PKGS, SHARD_TIMED)
        one_ms.append(ms)
        for j, nm in enumerate(("origin", "pkg8k", "vflags")):
            check_equal(f"phase 17 shard {lo}:{hi} on {d} vs a chain of "
                        f"its width, {nm}", got[j][:, lo:hi], want[j])
        del one
    del sh
    # against phase 3's RecordChain(4096) on the same packages: reported
    d = np.abs(got[0].astype(np.int32) - main_origin.astype(np.int32))
    vs_main = {"max_lsb": int(d.max()), "equal_share": round(float(
        (d == 0).mean()), 6), "streams_over_4_lsb": int(
        (d.max(axis=(0, 2)) > LSB).sum())}

    # exact mode and the integer chain: sharded == unsharded on the card,
    # outputs and every state leaf
    exact_rows = {}
    for mode, kw in (("exact", {}),
                     ("integer", dict(aec_backend="aecm",
                                      ns_backend="nsx"))):
        with mode_env(mode == "exact"):
            sx = ShardedRecordChain(B_SHARD_X, 16000, shards=shards,
                                    devices=devices, **kw)
            ux = RecordChain(B_SHARD_X, 16000, **kw)
        if sx.chains[0].fast == (mode == "exact"):
            raise AssertionError(f"phase 17 {mode}: wrong arithmetic mode")
        n0 = kernels.launched("aec_package")
        mic_x = mic_d[:SHARD_X_PKGS, :B_SHARD_X]
        play_x = play_d[:SHARD_X_PKGS, :B_SHARD_X]
        got_x, sx_ms = timed_steps(sx, mic_x, play_x, SHARD_X_PKGS, 4)
        want_x, ux_ms = timed_steps(ux, mic_x, play_x, SHARD_X_PKGS, 4)
        if kernels.launched("aec_package") != n0:
            raise AssertionError(f"phase 17 {mode}: the kernel launched")
        for j, nm in enumerate(("origin", "pkg8k", "vflags")):
            check_equal(f"phase 17 {mode}: sharded vs unsharded, {nm}",
                        got_x[j], want_x[j])
        whole = _leaves(ux.state)
        for (_ch, lo, hi), st in zip(sx.shard_ranges(), sx.state):
            for i, (a, b) in enumerate(zip(_leaves(st), whole)):
                check_equal(f"phase 17 {mode}: shard {lo}:{hi} state leaf "
                            f"{i}", a, b[lo:hi])
        if not got_x[0][-1].any():
            raise AssertionError(f"phase 17 {mode}: silent output")
        exact_rows[mode] = {
            "batch": B_SHARD_X, "packages": SHARD_X_PKGS,
            "state_leaves": len(whole), "equal_to_unsharded": True,
            "sharded_pkg_ms": round(sx_ms, 3),
            "unsharded_pkg_ms": round(ux_ms, 3)}
        del sx, ux

    dryrun = None
    if n_cards >= 2:
        t0 = time.perf_counter()
        dryrun_multichip(n_cards)
        dryrun = {"devices": n_cards, "passed": True,
                  "seconds": round(time.perf_counter() - t0, 3)}
    phase("sharded_chain", card=name_power, cards=n_cards, shards=shards,
          devices=devices, batch=B_MAIN, packages=SHARD_PKGS,
          kernel_launches=launches, launches_by_device=by_device,
          shards_equal_to_chains_of_their_width=True,
          sharded_pkg_ms=round(sh_ms, 3),
          shard_width_chain_pkg_ms=[round(x, 3) for x in one_ms],
          pkg_ms_phase3=round(main_pkg_ms, 3),
          sharded_over_phase3=round(sh_ms / main_pkg_ms, 3),
          sharded_over_sum_of_shard_chains=round(sh_ms / sum(one_ms), 3),
          vs_phase3_chain=vs_main, dryrun_multichip=dryrun, **exact_rows)
    return launches


# Parity (phase 18): the first second of PARITY_r05's 64 scenes
B_PARITY, PARITY_S = 64, 1
# aec_only on the card against wmix_tpu's plain-JAX fast path: the fast
# chain's gate (ROADMAP), since the card's last bits are not the CPU's
AEC_PLAIN_LSB = 4


def phase_parity(aec_package, name_power) -> int:
    """18. The port on the card against wmix_tpu's stored parity digests,
    and the fast full chain against the port's CPU and wmix_tpu's stored
    VAD flags."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from wmix_tpu_torch import parity as tp
    ref = tp.load_json(tp.REF_PATH)
    t0 = time.perf_counter()
    workers = len(tp.ZERO_LSB)
    threads = max(1, (os.cpu_count() or 1) // (workers + 1))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {nm: ex.submit(tp.run_config, nm, ref["configs"][nm],
                              B_PARITY, PARITY_S, "cuda", None, threads)
                for nm in tp.ZERO_LSB}
        aec0 = kernels.launched("aec_package")
        fast = tp.run_config("full_chain", ref["configs"]["full_chain"],
                             B_PARITY, PARITY_S, "cuda")
        launches = kernels.launched("aec_package") - aec0
        aec0 = kernels.launched("aec_package")
        aec = tp.run_config("aec_only", ref["configs"]["aec_only"],
                            B_PARITY, PARITY_S, "cuda")
        aec_launches = kernels.launched("aec_package") - aec0
        zero = {nm: f.result() for nm, f in futs.items()}
    bad = {nm: e["vs_wmix_tpu"] for nm, e in zero.items()
           if not e["vs_wmix_tpu"]["equal"]}
    if bad:
        raise AssertionError(f"phase 18: the card is not bit-equal to "
                             f"wmix_tpu (stream, window): {bad}")
    if any(e["kernel_launches"] for e in zero.values()):
        raise AssertionError("phase 18: a bit-equal configuration "
                             "launched the kernel")
    steady = fast["packages"] - 4
    if launches != steady or fast["kernel_launches"] != steady:
        raise AssertionError(f"phase 18: {launches} kernel launches over "
                             f"{steady} steady packages")
    if aec_launches != steady or aec["kernel_launches"] != steady:
        raise AssertionError(f"phase 18: aec_only launched the kernel "
                             f"{aec_launches} times over {steady} steady "
                             "packages")
    card_plain = aec["vs_wmix_tpu_plain_first_second"]["max_lsb"]
    cpu_plain = aec["port_cpu_vs_wmix_tpu_plain_first_second"]["max_lsb"]
    if card_plain > AEC_PLAIN_LSB or cpu_plain > tp.PLAIN_LSB:
        raise AssertionError(
            f"phase 18: aec_only against wmix_tpu's plain-JAX fast path: "
            f"card {card_plain} LSB (gate {AEC_PLAIN_LSB}), CPU {cpu_plain} "
            f"LSB (gate {tp.PLAIN_LSB})")

    def brief(stats):
        return {k: v for k, v in stats.items() if k != "per_stream_max_lsb"}
    vs_cpu = brief(fast["vs_port_cpu"])
    phase("parity", card=name_power, batch=B_PARITY, seconds=PARITY_S,
          scenes="PARITY_r05", equal_to_wmix_tpu=sorted(zero),
          pkg_ms={nm: e["pkg_ms"] for nm, e in
                  [*zero.items(), ("full_chain", fast)]},
          full_chain_vs_port_cpu=vs_cpu,
          full_chain_streams_over_4_lsb=sum(
              x > LSB for x in fast["vs_port_cpu"]["per_stream_max_lsb"]),
          port_cpu_reproduces_stored=fast[
              "port_cpu_reproduces_stored_cpu_digests"]["equal"],
          vad_vs_wmix_tpu={k: v for k, v in fast["vad_vs_wmix_tpu"].items()
                           if k != "per_stream"},
          port_cpu_vad_vs_wmix_tpu=fast["port_cpu_vad_vs_wmix_tpu"][
              "differing_packages"],
          vad_vs_port_cpu=fast["vad_vs_port_cpu"]["differing_packages"],
          kernel_launches=launches,
          aec_only=dict(
              vs_wmix_tpu_plain=brief(aec["vs_wmix_tpu_plain_first_second"]),
              streams_over_1_lsb_vs_plain=sum(
                  x > 1 for x in aec["vs_wmix_tpu_plain_first_second"][
                      "per_stream_max_lsb"]),
              port_cpu_vs_wmix_tpu_plain=brief(
                  aec["port_cpu_vs_wmix_tpu_plain_first_second"]),
              vs_port_cpu=brief(aec["vs_port_cpu"]),
              digests_equal_to_wmix_tpu_plain=aec[
                  "digests_equal_to_wmix_tpu_plain"],
              card_equals_stored_cpu_digests=aec[
                  "device_reproduces_stored_cpu_digests"],
              port_cpu_reproduces_stored=aec[
                  "port_cpu_reproduces_stored_cpu_digests"]["equal"],
              pkg_ms=aec["pkg_ms"], kernel_launches=aec_launches),
          seconds_taken=round(time.perf_counter() - t0, 1))
    return launches + aec_launches


BENCH_CHUNKS = 2
RT_TICKS, RT_WARM, RT_DEPTH = 20, 4, 4
B_MIX, MIX_SOURCES, MIX_TICKS = 1024, 4, 20


def phase_benches(aec_package, name_power) -> int:
    """19. The port's measuring entry points (`bench`, `graft_entry`,
    `realtime_bench`, `mix_bench`, `codec_bench`) on the card."""
    from wmix_tpu_torch import (bench, codec_bench, graft_entry, mix_bench,
                                realtime_bench)
    from wmix_tpu_torch.engine.chain import RecordChain
    t0 = time.perf_counter()
    aec0 = kernels.launched("aec_package")
    point, outs, timed = bench.run_point(bench.FULL, B_MAIN, K, BENCH_CHUNKS)
    bench_launches = kernels.launched("aec_package") - aec0
    # every package after the priming one of the first warm chunk
    want = (2 + BENCH_CHUNKS) * K - 1
    if timed != BENCH_CHUNKS * K or bench_launches != want:
        raise AssertionError(f"phase 19: bench launched the kernel "
                             f"{bench_launches} times ({timed} timed), "
                             f"{want} ({BENCH_CHUNKS * K}) wanted")
    # its first 4 streams against the CPU chain driven the same way
    mic, play = (x[:, :4] for x in bench.bench_audio(B_MAIN, K))
    cpu = RecordChain(4, 16000, device="cpu")
    for _ in range(3):
        cpu._plan_tick()
    for _ in range(2 + BENCH_CHUNKS):
        want_outs = cpu.run_chunk(mic, play)
    bench_lsb = compare_outputs([tuple(o[:, :4].cpu() for o in outs)],
                                [want_outs])

    aec0 = kernels.launched("aec_package")
    fn, args = graft_entry.entry()
    _st, origin, pkg8k, vflags = fn(*args)
    torch.cuda.synchronize()
    graft_launches = kernels.launched("aec_package") - aec0
    if graft_launches != 1:
        raise AssertionError(f"phase 19: graft_entry's fn launched the "
                             f"kernel {graft_launches} times, 1 wanted")
    cfn, cargs = graft_entry.entry(device="cpu")
    graft_lsb = compare_outputs([(origin.cpu(), pkg8k.cpu(), vflags.cpu())],
                                [cfn(*cargs)[1:]])
    if max(bench_lsb[:2] + graft_lsb[:2]) > LSB:
        raise AssertionError(f"phase 19: card vs CPU beyond {LSB} LSB "
                             f"(origin, pkg8k, VAD equal, equal share): "
                             f"bench {bench_lsb}, graft_entry {graft_lsb}")

    aec0 = kernels.launched("aec_package")
    rt = realtime_bench.bench_ticks(B_MAIN, RT_TICKS, RT_WARM, RT_DEPTH)
    rt_launches = kernels.launched("aec_package") - aec0
    if rt["delivered"] != RT_TICKS or rt_launches != RT_TICKS + RT_WARM - 4:
        raise AssertionError(f"phase 19: realtime_bench delivered "
                             f"{rt['delivered']} of {RT_TICKS} ticks with "
                             f"{rt_launches} kernel launches")
    mix = mix_bench.bench(B_MIX, MIX_SOURCES, MIX_TICKS)
    codec = codec_bench.run(quick=True)
    if kernels.launched("aec_package") - aec0 != rt_launches:
        raise AssertionError("phase 19: the mix or codec bench launched "
                             "the AEC kernel")
    phase("benches", card=name_power, bench_point=point,
          bench_kernel_launches=bench_launches, bench_timed_launches=timed,
          bench_vs_cpu_4_streams=bench_lsb,
          graft_entry=dict(kernel_launches=graft_launches,
                           vs_cpu=graft_lsb),
          realtime={k: rt[k] for k in ("batch", "depth", "n",
                                       "pump_p50_ms", "pump_p95_ms",
                                       "pump_max_ms", "overruns",
                                       "delivered",
                                       "output_latency_p50_ms")},
          realtime_kernel_launches=rt_launches, mix=mix,
          codec={"device": codec["device"],
                 **{f"{c}_{k}": v["streams"]
                    for c in ("mp3", "aac") for k, v in codec[c].items()}},
          seconds_taken=round(time.perf_counter() - t0, 1))
    return bench_launches + graft_launches + rt_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from wmix_tpu_torch.engine import aec_package
    from wmix_tpu_torch.engine.aec_step import pack_dyn
    from wmix_tpu_torch.engine.chain import RecordChain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name_power = card()
    print(name_power, flush=True)
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build
    kernels.load("aec_package")
    log = kernels.build_log["aec_package"]
    ptxas = [ln.strip() for ln in log["log"].splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln]
    phase("build", source="wmix_tpu_torch/csrc/aec_package.cu",
          arch="sm_90a", built=log["built"],
          seconds=round(log["seconds"], 3), ptxas=ptxas)

    # 3. main path at full size
    mic, play = audio(K * CHUNKS, B_MAIN, seed=0)
    mic_d = torch.from_numpy(mic).to(dev)
    play_d = torch.from_numpy(play).to(dev)
    chain = RecordChain(B_MAIN, 16000)     # the default device: the card
    torch.cuda.synchronize()
    aec0, agc0, vad0 = (kernels.launched(k)
                        for k in ("aec_package", "agc", "vad"))
    chunk_ms = []
    outs = []
    for c in range(CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = chain.run_chunk(mic_d[c * K:(c + 1) * K],
                            play_d[c * K:(c + 1) * K])
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(o)
    launches = kernels.launched("aec_package") - aec0
    agc_launches = kernels.launched("agc") - agc0
    vad_launches = kernels.launched("vad") - vad0
    steady_pkgs = K * CHUNKS - 4
    if launches != steady_pkgs:
        raise AssertionError(f"kernel launches {launches} != steady "
                             f"packages {steady_pkgs}")
    agc_by_phase = {"3": agc_launches}
    vad_by_phase = {"3": vad_launches}
    if agc_launches != K * CHUNKS or vad_launches != K * CHUNKS:
        raise AssertionError(f"AGC and VAD kernel launches {agc_launches} "
                             f"and {vad_launches} != packages "
                             f"{K * CHUNKS}")
    for o, p8, vf in outs:
        if o.dtype != torch.int16 or p8.dtype != torch.int16:
            raise AssertionError("chain outputs are not int16")
        if tuple(o.shape) != (K, B_MAIN, 320) or \
                tuple(p8.shape) != (K, B_MAIN, 160) or \
                tuple(vf.shape) != (K, B_MAIN):
            raise AssertionError("chain output shapes")
    nonfinite = int(chain.aec_nonfinite)
    if nonfinite:
        raise AssertionError(f"{nonfinite} non-finite AEC output samples")
    if not isinstance(chain.state.aec, aec_package.PackageAecState):
        raise AssertionError("the chain never reached the kernel layout")
    steady_ms = chunk_ms[1:]
    audio_s = K * 0.02
    streams = [B_MAIN * audio_s / (ms / 1e3) for ms in steady_ms]
    phase("main_path", batch=B_MAIN, packages=K * CHUNKS,
          kernel_launches=launches, agc_kernel_launches=agc_launches,
          vad_kernel_launches=vad_launches,
          chunk_ms=[round(x, 3) for x in chunk_ms],
          steady_chunk_ms_median=round(float(np.median(steady_ms)), 3),
          streams_median=round(float(np.median(streams)), 1),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
          origin_rms=round(float(outs[-1][0].float().pow(2).mean().sqrt()),
                           2))

    # 4. kernel vs plain version, from the adapted state
    ast = chain.state.aec
    planner = copy.deepcopy(chain.planner)
    plan = planner.plan_pkg()
    dyn = pack_dyn(plan, chain.part_cap)
    far_pre, fp, fwp = (ast.far_pre.clone(), ast.far_parts.clone(),
                        ast.farw_parts.clone())
    far = torch.from_numpy(audio(1, B_MAIN, seed=7)[1][0]).to(dev).float()
    near = torch.from_numpy(audio(1, B_MAIN, seed=7)[0][0]).to(dev).float()
    aec_package.build_far_body(plan.signature(), chain.sub_len)(
        far_pre, fp, fwp, far, dyn)
    ins = (near.contiguous(), *aec_package._kernel_inputs(fp, fwp, dyn))
    st_k = {k: v.clone() for k, v in ast.p.items()}
    st_p = {k: v.clone() for k, v in ast.p.items()}
    st_k, out_k = aec_package.package_step(st_k, *ins)
    st_p, out_p = aec_package.package_body(st_p, *ins)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError("kernel output not finite")
    worst = {"out": rel(out_k, out_p)}
    worst.update({k: rel(st_k[k], st_p[k])
                  for k in aec_package.STATE_FIELDS
                  if k not in aec_package.SCALAR_I})
    bad = {k: v for k, v in worst.items() if not v <= REL}
    if bad:
        raise AssertionError(f"kernel vs package_body beyond rel {REL}: "
                             f"{bad}")
    unequal = {k: int((st_k[k] != st_p[k]).sum())
               for k in aec_package.SCALAR_I}
    if any(unequal.values()):
        raise AssertionError("kernel vs package_body: integer state fields "
                             f"differ on this many streams: {unequal}")
    max_abs = float((out_k - out_p).abs().max())
    scratch = {k: v.clone() for k, v in ast.p.items()}
    kernel_ms = cuda_queued_ms(
        lambda: aec_package.package_step(scratch, *ins))
    kernel_call_ms = cuda_median_ms(
        lambda: aec_package.package_step(scratch, *ins))
    plain_ms = cuda_median_ms(
        lambda: aec_package.package_body(scratch, *ins))
    bound_ms, bound_by, moved, flop = package_bound(
        ins + (aec_package._kernel_consts(str(near.device)),),
        tuple(st_k[k] for k in aec_package.STATE_FIELDS), (out_k,), B_MAIN)
    phase("kernel_vs_plain", batch=B_MAIN, max_rel=max(worst.values()),
          max_rel_at=max(worst, key=worst.get),
          int_fields_equal=sorted(unequal),
          max_abs_err_out=max_abs, kernel_ms=round(kernel_ms, 4),
          kernel_call_ms=round(kernel_call_ms, 4),
          plain_ms=round(plain_ms, 4), bound_ms=round(bound_ms, 4),
          bound_by=bound_by, bound_share=round(bound_ms / kernel_ms, 4),
          bytes_moved=moved, flop=flop)

    n0 = kernels.launched("agc")
    pkg0 = mic_d[0].to(torch.int32)
    agc_times = phase_stage_kernel(
        "agc", agc.AgcState._fields,
        lambda st, x: agc.process_pkg(st, x, 1, 16000, 5),
        lambda st, x: agc.process_pkg_body(st, x, 1, 16000, 5),
        chain.state.agc, pkg0)
    agc_by_phase["4b"] = kernels.launched("agc") - n0
    n0 = kernels.launched("vad")
    vad_times = phase_stage_kernel(
        "vad", vad_mod.VadState._fields,
        lambda st, x: vad_mod.process(st, x, 1, 16000),
        lambda st, x: vad_mod.process_body(st, x, 1, 16000),
        chain.state.vad, pkg0)
    vad_by_phase["4c"] = kernels.launched("vad") - n0

    # 5. the chain on cuda (kernel) against the chain on cpu (plain)
    mic4, play4 = audio(2 * K, 4, seed=3)
    res = {}
    small_ms = []
    for d in ("cuda", "cpu"):
        ch = RecordChain(4, 16000, device=d)
        res[d] = []
        for c in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[d].append(ch.run_chunk(mic4[c * K:(c + 1) * K],
                                       play4[c * K:(c + 1) * K]))
            torch.cuda.synchronize()
            if d == "cuda":
                small_ms.append((time.perf_counter() - t0) * 1e3 / K)
    dmax = {}
    for j, nm in ((0, "origin"), (1, "pkg8k")):
        a = torch.cat([r[j].cpu() for r in res["cuda"]]).int()
        b = torch.cat([r[j] for r in res["cpu"]]).int()
        dmax[nm] = int((a - b).abs().max())
    vad_equal = all(bool(torch.equal(x[2].cpu(), y[2]))
                    for x, y in zip(res["cuda"], res["cpu"]))
    if max(dmax.values()) > LSB:
        raise AssertionError(f"cuda vs cpu chain beyond {LSB} LSB: {dmax}")
    # does the package time depend on B at all?  (the second chunk of
    # each is steady: every package goes through the kernel)
    pkg_ms_main = float(np.median(steady_ms)) / K
    phase("cuda_vs_cpu_chain", batch=4, packages=2 * K, max_lsb=dmax,
          vad_flags_equal=vad_equal,
          steady_pkg_ms_b4=round(small_ms[1], 3),
          steady_pkg_ms_b4096=round(pkg_ms_main, 3),
          b4096_over_b4=round(pkg_ms_main / small_ms[1], 3))

    # 6. echo check on the card
    rng = np.random.RandomState(42)
    P = 10
    farx = (rng.randn(P, B_MAIN, 320) * 4000).astype(np.float32)
    nearx = (np.roll(farx, 2, axis=0) * 0.3 +
             rng.randn(P, B_MAIN, 320) * 800).astype(np.float32)
    eb = aec_package.AecBatchPackage(B_MAIN, 16000)
    for p in range(P):
        out = eb.step(torch.from_numpy(farx[p]).to(dev),
                      torch.from_numpy(nearx[p]).to(dev))
    near_e = float((nearx[P - 1].astype(np.float64) ** 2).mean())
    out_e = float(out.double().pow(2).mean())
    if not out_e < near_e:
        raise AssertionError(f"echo not cancelled: out {out_e} >= near "
                             f"{near_e}")
    phase("echo", batch=B_MAIN, near_energy=near_e, out_energy=out_e,
          erle_db=round(10 * np.log10(near_e / out_e), 3))

    def counted(key, fn, *args):
        """fn(*args), its AGC and VAD kernel launches kept under key."""
        n0, v0 = kernels.launched("agc"), kernels.launched("vad")
        got = fn(*args)
        agc_by_phase[key] = kernels.launched("agc") - n0
        vad_by_phase[key] = kernels.launched("vad") - v0
        return got

    by_phase = {"3": launches}
    by_phase["7"] = counted("7", phase_checkpoint, aec_package)
    by_phase.update(counted("8", phase_server, aec_package, mic, play, outs))
    by_phase["9"] = counted("9", phase_daemon, aec_package, kernels)
    counted("10", phase_mixbus)
    for case, n in counted("11", phase_geometries, aec_package, pkg_ms_main,
                           name_power).items():
        by_phase[f"11_{case}"] = n
    by_phase["12"] = counted("12", phase_exact, aec_package, pkg_ms_main,
                             name_power)
    by_phase["13"], ops3 = counted("13", phase_integer, aec_package, chain,
                                   pkg_ms_main, name_power)
    # the host's cost of one launching operation, from phase 3's package
    per_op_ms = pkg_ms_main / ops3["launching"]
    by_phase["14"] = counted("14", phase_codec_device, aec_package,
                             per_op_ms, name_power)
    by_phase["15"] = counted("15", phase_codec_decoders, aec_package,
                             name_power)
    by_phase["16"] = counted("16", phase_daemon_core, aec_package,
                             name_power)
    by_phase["17"] = counted(
        "17", phase_sharded, aec_package, mic_d, play_d,
        outs[0][0][:SHARD_PKGS].cpu().numpy(), pkg_ms_main, name_power)
    by_phase["18"] = counted("18", phase_parity, aec_package, name_power)
    by_phase["19"] = counted("19", phase_benches, aec_package, name_power)
    launches = sum(by_phase.values())

    print(json.dumps({"kernels": [{
        "name": "aec_package",
        "route": "cuda",
        "source": "wmix_tpu_torch/csrc/aec_package.cu",
        "replaces": "wmix_tpu/engine/aec_pallas.py:587",
        "launches": launches,
        "launches_by_phase": by_phase,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes an AEC package
        "library_ms": None}, {
        "name": "agc",
        "route": "cuda",
        "source": "wmix_tpu_torch/csrc/agc.cu",
        # wmix_tpu's AGC is plain jnp: no TPU kernel
        "replaces": None,
        "launches": sum(agc_by_phase.values()),
        "launches_by_phase": agc_by_phase,
        "max_abs_err": 0,
        **agc_times,
        "bound_by": "bytes",
        "library_ms": None}, {
        "name": "vad",
        "route": "cuda",
        "source": "wmix_tpu_torch/csrc/vad.cu",
        # wmix_tpu's VAD is plain jnp: no TPU kernel
        "replaces": None,
        "launches": sum(vad_by_phase.values()),
        "launches_by_phase": vad_by_phase,
        "max_abs_err": 0,
        **vad_times,
        "bound_by": "bytes",
        "library_ms": None}]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
