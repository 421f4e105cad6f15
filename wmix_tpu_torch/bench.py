"""Headline benchmark of the port: concurrent real-time 16 kHz
NS+AEC+AGC+VAD streams per card.  The counterpart of `bench.py`.

    python -m wmix_tpu_torch.bench [--device cpu] [--batch 4096,2048,1024,8192]
        [--k 25] [--chunks 8] [--wall 540] [--no-stages]

Runs the batched record chain (`engine/chain.py` `RecordChain`) in its
production shape, `run_chunk` over K packages of 20 ms, and reports
streams = B * audio_seconds / wall_seconds: a throughput, not a count of
streams that run in real time (`chunk_ms` against `budget_ms` says that).

Prints exactly ONE JSON line, with bench.py's fields:
  {"metric": ..., "value": N, "unit": "streams", "vs_baseline": N/4096,
   "batch": B, "backend": "cuda", "device": "<name>, <power limit>",
   "ladder": [per-batch points], "stages_chunk_ms": {...}, "wall_s": s}

The design is bench.py's: ONE worker subprocess measures the ladder's
points in order, the headline batch first, and streams each result as a
flushed JSON line the moment it lands; the stage isolation (`ns`, `aec`,
`agc_vad` by the enable flags, beside `full` and `host_plan`) runs right
after the headline point; the parent enforces a TOTAL wall budget and,
when it expires, kills the worker and builds the line from the points
that came out, and the worker skips the points it could not finish as
{"error": "budget"}.  The parent imports neither torch nor jax.

Left out of bench.py's line, and why:
  * `mfu_f32` and `pallas_tflops` divide a FLOP model of the Pallas
    kernel by a TPU v5e's float32 peak (bench.py:44-64, :306-308); they
    say nothing of this card.  The CUDA kernel's share of its byte bound
    is `chip_smoke.py` phase 4's.
  * the last-good replay (bench.py:331-340) would print a TPU record
    (`bench_lastgood.json`, "backend": "tpu") as this run's result.  A run
    that measured no point prints `value: 0` with `degraded: true`.
  * `ShardedRecordChain` above `BENCH_SHARD_W`: a workaround of the TPU
    compiler; one `RecordChain` serves every batch here.
The ladder starts at the headline, 4096, then 2048, 1024 and 8192:
bench.py's order served the TPU's reuse of compiled programs, and the
port compiles nothing.

The card is the default (`device=None`); without one the worker raises
and the parent exits non-zero: nothing falls back to the CPU unless
`--device cpu` asks for it.
"""
from __future__ import annotations

import argparse
import json
import os
import selectors
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "concurrent_16k_ns_aec_agc_vad_streams_per_chip"
LADDER = (4096, 2048, 1024, 8192)
FREQ = 16000
PKG = FREQ // 1000 * 20
FULL = dict(ns_enable=True, aec_enable=True, agc_enable=True,
            vad_enable=True)
# the stage isolation of bench.py:181-191.  "aec" keeps the AGC on, as
# there: the AEC-only chain's int16 recast matches either way
STAGES = {
    "ns": dict(ns_enable=True, aec_enable=False, agc_enable=False,
               vad_enable=False),
    "aec": dict(ns_enable=False, aec_enable=True, agc_enable=True,
                vad_enable=False),
    "agc_vad": dict(ns_enable=False, aec_enable=False, agc_enable=True,
                    vad_enable=True),
}


# ----------------------------------------------------------------- worker

def _emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def bench_audio(batch: int, k_pkgs: int):
    """The seeded chunk of bench.py:99-105: (mic, play) int16 [K, B, 320],
    Gaussian noise of sigma 3000 and 5000."""
    import numpy as np
    rng = np.random.RandomState(0)
    mic = (rng.randn(k_pkgs, batch, PKG) * 3000).astype(np.int16)
    play = (rng.randn(k_pkgs, batch, PKG) * 5000).astype(np.int16)
    return mic, play


def run_point(chain_kw: dict, batch: int, k_pkgs: int, n_chunks: int,
              device=None):
    """One timed measurement (bench.py `_measure`, :75-141).  Returns
    (bench.py's fields, the last timed chunk's outputs as tensors on the
    chain's device, the AEC kernel's launches over the timed chunks).

    The planner advances past the AEC's three start-up packages without
    device work, as bench.py:100-102 does; the first chunk's first package
    (the out ring's priming one) runs in the exact ring layout from the
    fresh state, and the next converts the state to the kernel layout.  On
    the card a chain in that layout must then have launched the kernel once
    for every timed package (on the CPU its plain version runs and nothing
    launches): anything else raises."""
    import torch
    from wmix_tpu_torch import kernels
    from wmix_tpu_torch.engine import aec_package
    from wmix_tpu_torch.engine.chain import RecordChain

    chain = RecordChain(batch, FREQ, **chain_kw, device=device)
    dev = chain.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if chain.planner is not None:
        for _ in range(3):
            chain._plan_tick()
    # the audio is on the device before the timed region: the metric is
    # DSP streams per card
    mic, play = (torch.from_numpy(x).to(dev)
                 for x in bench_audio(batch, k_pkgs))
    # two warm chunks: start-up and the layout conversion, then steady
    for _ in range(2):
        chain.run_chunk(mic, play)
    sync()
    launched = kernels.launched("aec_package")
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        outs = chain.run_chunk(mic, play)
    sync()
    dt = time.perf_counter() - t0
    launches = kernels.launched("aec_package") - launched
    kernel = dev.type == "cuda" and \
        aec_package.is_kernel_layout(chain.state.aec)
    want = n_chunks * k_pkgs if kernel else 0
    if launches != want:
        raise RuntimeError(f"bench: {launches} AEC kernel launches over "
                           f"{n_chunks * k_pkgs} timed packages, {want} "
                           "wanted")

    audio_s = n_chunks * k_pkgs * 0.02
    point = {"batch": batch, "streams": round(batch * audio_s / dt, 1),
             "chunk_ms": round(dt / n_chunks * 1000, 2),
             "budget_ms": k_pkgs * 20}
    # host planning cost (the per-chunk _plan_tick loop)
    if chain.planner is not None:
        t0 = time.perf_counter()
        for _ in range(k_pkgs):
            chain._plan_tick()
        point["plan_ms_per_chunk"] = round(
            (time.perf_counter() - t0) * 1000, 2)
    return point, outs, launches


def measure(chain_kw: dict, batch: int, k_pkgs: int, n_chunks: int,
            device=None) -> dict:
    """bench.py's `_measure` on the port: the point's fields (`batch`,
    `streams`, `chunk_ms`, `budget_ms`, and `plan_ms_per_chunk` where the
    AEC plans), from `run_point`."""
    return run_point(chain_kw, batch, k_pkgs, n_chunks, device)[0]


def _worker(batches, k_pkgs: int, n_chunks: int, stages: bool,
            deadline: float, device=None) -> None:
    """Runs inside the subprocess; STREAMS one JSON line per result."""
    from wmix_tpu_torch.device import describe, resolve_device
    dev = resolve_device(device)      # raises without a card
    _emit({"event": "backend", "backend": dev.type,
           "device": describe(dev)})
    first_done = False
    for b in batches:
        if first_done and time.time() > deadline - 30:
            _emit({"event": "point", "batch": b, "error": "budget"})
            continue
        try:
            pt = measure(FULL, b, k_pkgs, n_chunks, device)
            _emit({"event": "point", **pt})
            print(f"  B={b}: {pt['streams']} streams", file=sys.stderr)
        except Exception as e:  # out of memory etc.: record and go on
            _emit({"event": "point", "batch": b, "error": str(e)[:300]})
            print(f"  B={b}: FAILED {e}", file=sys.stderr)
            continue
        if not first_done and stages:
            # the stage isolation right after the headline point, so that
            # it survives a budget kill during the larger batches
            stages_ms = {"full": pt["chunk_ms"],
                         "host_plan": pt.get("plan_ms_per_chunk", 0.0)}
            for name, kw in STAGES.items():
                if time.time() > deadline - 60:
                    stages_ms[name] = "skipped: budget"
                    continue
                try:
                    stages_ms[name] = measure(
                        kw, pt["batch"], k_pkgs, max(2, n_chunks // 2),
                        device)["chunk_ms"]
                except Exception as e:
                    stages_ms[name] = f"failed: {str(e)[:100]}"
            _emit({"event": "stages", "stages_ms": stages_ms})
        first_done = True


# ----------------------------------------------------------------- parent

def _run_streaming(batches, k_pkgs: int, n_chunks: int, deadline: float,
                   stages: bool, device):
    """Launch the worker, collect its streamed events until the deadline.
    Returns (events, the worker's exit code or None if it was killed)."""
    cmd = [sys.executable, "-m", "wmix_tpu_torch.bench", "--worker",
           ",".join(str(b) for b in batches), str(k_pkgs), str(n_chunks),
           "1" if stages else "0", str(deadline), device or "card"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=sys.stderr, start_new_session=True)
    events = []
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    buf = ""
    try:
        while True:
            left = deadline - time.time()
            if left <= 0:
                print("bench: wall budget exhausted, stopping worker",
                      file=sys.stderr)
                break
            if not sel.select(timeout=min(left, 5.0)):
                if proc.poll() is not None:
                    break
                continue
            # unbuffered: a line left in a reader's buffer would wait for
            # the worker's next write
            chunk = os.read(proc.stdout.fileno(), 65536)
            if not chunk:
                break
            buf += chunk.decode()
            while "\n" in buf:
                line, buf = buf.split("\n", 1)
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if isinstance(d, dict) and "event" in d:
                    events.append(d)
    finally:
        sel.close()
        if proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        proc.stdout.close()
    return events, proc.returncode


def result_line(events, ladder, wall_s: float) -> dict:
    """bench.py's line (:283-340) from the worker's events; a ladder point
    that never came out reads {"error": "budget"}."""
    points = [e for e in events if e.get("event") == "point"]
    ladder_out = [{k: v for k, v in e.items() if k != "event"}
                  for e in points]
    seen = {e.get("batch") for e in points}
    ladder_out += [{"batch": b, "error": "budget"} for b in ladder
                   if b not in seen]
    backend = next((e for e in events if e.get("event") == "backend"), {})
    stages_ms = next((e["stages_ms"] for e in events
                      if e.get("event") == "stages"), {})
    ok = [d for d in ladder_out if "streams" in d]
    result = {"metric": METRIC, "value": 0.0, "unit": "streams",
              "vs_baseline": 0.0}
    if ok:
        best = max(ok, key=lambda d: d["streams"])
        result.update(value=best["streams"],
                      vs_baseline=round(best["streams"] / 4096.0, 4),
                      batch=best["batch"])
    result.update(backend=backend.get("backend", "unknown"),
                  device=backend.get("device", "unknown"),
                  ladder=ladder_out, stages_chunk_ms=stages_ms,
                  wall_s=round(wall_s, 1))
    if not ok:
        result["degraded"] = True
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    ap.add_argument("--batch", default=",".join(str(b) for b in LADDER),
                    help="the ladder, headline first")
    ap.add_argument("--k", type=int, default=25,
                    help="packages per chunk (0.5 s of audio at 25)")
    ap.add_argument("--chunks", type=int, default=8,
                    help="timed chunks per point")
    ap.add_argument("--wall", type=float, default=540,
                    help="TOTAL wall budget in seconds, all points")
    ap.add_argument("--no-stages", action="store_true",
                    help="skip the stage isolation")
    args = ap.parse_args(argv)
    t_start = time.time()
    ladder = [int(b) for b in args.batch.split(",")]
    events, rc = _run_streaming(ladder, args.k, args.chunks,
                                t_start + args.wall, not args.no_stages,
                                args.device)
    if not any(e.get("event") == "backend" for e in events) and rc:
        # the worker died before measuring: no card, or a broken install
        print(f"bench: the worker exited with code {rc} before it "
              "measured anything", file=sys.stderr)
        return rc
    print(json.dumps(result_line(events, ladder, time.time() - t_start)))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker([int(b) for b in sys.argv[2].split(",")],
                int(sys.argv[3]), int(sys.argv[4]), sys.argv[5] == "1",
                float(sys.argv[6]),
                None if sys.argv[7] == "card" else sys.argv[7])
    else:
        sys.exit(main())
