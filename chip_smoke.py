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
     packages (96); outputs int16, AEC output finite; steady chunk time
     and streams = B * audio_s / wall
  4. kernel vs package_body at B=4096 from the adapted state: rel <= 1e-4
     on the output and every float state field, equality on every integer
     state field; CUDA-event times beside the least time the card could
     take for the same bytes and operations: kernel_ms with 20 launches
     queued behind one another (device time alone), kernel_call_ms and
     plain_ms one call at a time (median of 20, the host's share of a
     call included)
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
Then the kernel table as JSON (launches summed over phases 3, 7, 8 and 9,
each counted from 0) and, last, {"ok": true, "device": {...}}.
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

B_MAIN, K, CHUNKS = 4096, 25, 4
LSB = 4
REL = 1e-4


def phase(name, **kv):
    print(json.dumps({"phase": name, **kv}), flush=True)


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
    aec_package.package_step.launches = 0
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
    launches = aec_package.package_step.launches
    if launches != 3 * N - 4:
        raise AssertionError(f"phase 7: {launches} launches")
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

    aec_package.package_step.launches = 0
    srv.start_drain_thread()
    on = StepTimer(budget_ms=20.0)
    run(0, ON_TICKS, DEPTH, on)
    srv.stop_drain_thread()
    launches_on = aec_package.package_step.launches
    n_on, lat_on = len(blocks), (list(latency_ms), list(latency_ticks))
    off = StepTimer(budget_ms=20.0)
    run(ON_TICKS, ON_TICKS + OFF_TICKS, OFF_DEPTH, off)
    torch.cuda.synchronize()
    launches_off = aec_package.package_step.launches - launches_on
    if n_on != ON_TICKS or len(blocks) != ON_TICKS + OFF_TICKS:
        raise AssertionError(f"phase 8: {n_on} and {len(blocks)} blocks")
    for t, blk in enumerate(blocks):
        for j, nm in enumerate(("origin", "pkg8k", "vad")):
            check_equal(f"phase 8 tick {t} {nm} vs the chain", blk[j],
                        want[j][t])
    if launches_on != ON_TICKS - 4 or launches_off != OFF_TICKS:
        raise AssertionError(f"phase 8: {launches_on} and {launches_off} "
                             "kernel launches")
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
        aec_package.package_step.launches = 0
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
        launches = aec_package.package_step.launches
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from wmix_tpu_torch import kernels
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
    aec_package.package_step.launches = 0
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
    launches = aec_package.package_step.launches
    steady_pkgs = K * CHUNKS - 4
    if launches != steady_pkgs:
        raise AssertionError(f"kernel launches {launches} != steady "
                             f"packages {steady_pkgs}")
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
          kernel_launches=launches, chunk_ms=[round(x, 3) for x in chunk_ms],
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

    by_phase = {"3": launches}
    by_phase["7"] = phase_checkpoint(aec_package)
    by_phase.update(phase_server(aec_package, mic, play, outs))
    by_phase["9"] = phase_daemon(aec_package, kernels)
    phase_mixbus()
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
        "library_ms": None}]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
