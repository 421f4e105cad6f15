"""Real-time-mode evidence of the port: the per-tick pump cost of the
multi-stream server against the daemon's 20 ms heartbeat
(src/wmixConf.h:112, src/wmix.c:1336-1345), and the end-to-end output
latency.  The counterpart of `realtime_bench.py`.

    python -m wmix_tpu_torch.realtime_bench [--batches 256,1024,4096]
        [--ticks 300] [--warmup 30] [--depth 12] [--drain thread|inline]
        [--device cpu] [--out PATH]

The serving shape measured is `service.stream_server.StreamServer
.tick_pipelined()`: the pump issues one 20 ms package of work per
heartbeat (gather, the chain's launches, the start of the copies to the
host, the delivery of completed ticks) and delivers outputs `depth` ticks
later.  What the 20 ms budget governs is the PUMP work: the reference
daemon likewise runs behind its DMA ring and 400 ms AEC far-end FIFO
(platform/alsa/plat.h:19), so a bounded, recorded output latency is the
real-time metric, not a blocking device round trip per tick.

The pump is PACED: each tick waits for its 20 ms boundary, then does its
work; an overrun is pump work past the 20 ms slot.  Output latency is the
wall time from feed(tick j) to read_batch(tick j), per delivered tick.

Writes the artifact point by point (by default `REALTIME_torch_h100.json`
at the repo root, `REALTIME_torch_cpu.json` with `--device cpu`), with
`backend` and `device` (the card's name and power limit), and prints one
JSON summary line.  The card is the default; without one it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from wmix_tpu_torch.device import describe, resolve_device
from wmix_tpu_torch.service.stream_server import StreamServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICK_S = 0.02


def pct(v, q):
    """realtime_bench.py's percentile: the sorted sample at int(n * q)."""
    s = sorted(v)
    return round(s[min(len(s) - 1, int(len(s) * q))], 3)


def bench_ticks(batch: int, n_ticks: int, warmup: int, depth: int,
                drain: str = "thread", device=None) -> dict:
    """realtime_bench.py `bench_ticks` (:41-128) over the port's server:
    every slot open, seeded audio (8 ticks of it, cycled), `warmup` ticks
    flushed and read, then `n_ticks` paced ticks of feed_batch +
    tick_pipelined(depth) + read_batch, and the tail drained."""
    freq = 16000
    pkg = freq // 1000 * 20
    srv = StreamServer(batch, freq, max_depth=max(depth, 12), device=device)
    if drain == "thread":
        srv.start_drain_thread()
    try:
        handles = [srv.open_stream() for _ in range(batch)]
        rng = np.random.RandomState(0)
        mics = (rng.randn(8, batch, pkg) * 3000).astype(np.int16)
        plays = (rng.randn(8, batch, pkg) * 5000).astype(np.int16)

        t0 = time.time()
        for i in range(warmup):
            srv.feed_batch(handles, mics[i % 8], plays[i % 8])
            srv.tick_pipelined(depth)
        srv.flush_pipeline()
        while srv.read_batch(handles) is not None:
            pass
        warm_s = time.time() - t0

        pump_ms, out_lat_ms = [], []
        feed_t = []          # feed wall time per issued tick
        delivered = 0
        overruns = 0
        next_t = time.perf_counter() + TICK_S
        for i in range(n_ticks):
            # paced heartbeat: wait for the tick boundary
            now = time.perf_counter()
            if now < next_t:
                time.sleep(next_t - now)
            next_t += TICK_S

            feed_t.append(time.perf_counter())
            srv.feed_batch(handles, mics[i % 8], plays[i % 8])
            srv.tick_pipelined(depth)
            got = srv.read_batch(handles)
            t2 = time.perf_counter()
            work = (t2 - feed_t[-1]) * 1e3
            pump_ms.append(work)
            if work > TICK_S * 1e3:
                overruns += 1
            if got is not None:
                out_lat_ms.append((t2 - feed_t[delivered]) * 1e3)
                delivered += 1
        # drain the tail so every issued tick is accounted for
        srv.flush_pipeline()
        while delivered < n_ticks:
            got = srv.read_batch(handles)
            if got is None:
                break
            out_lat_ms.append((time.perf_counter() -
                               feed_t[delivered]) * 1e3)
            delivered += 1
    finally:
        srv.stop_drain_thread()

    return {
        "batch": batch,
        "depth": depth,
        "n": n_ticks,
        "budget_ms": TICK_S * 1e3,
        "pump_p50_ms": pct(pump_ms, 0.5),
        "pump_p95_ms": pct(pump_ms, 0.95),
        "pump_max_ms": round(max(pump_ms), 3),
        "overruns": overruns,
        "delivered": delivered,
        "output_latency_p50_ms": pct(out_lat_ms, 0.5) if out_lat_ms
        else None,
        "output_latency_p95_ms": pct(out_lat_ms, 0.95) if out_lat_ms
        else None,
        "output_latency_max_ms": round(max(out_lat_ms), 3)
        if out_lat_ms else None,
        "warmup_ticks": warmup,
        "warmup_s": round(warm_s, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="256,1024,4096")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--drain", default="thread",
                    choices=("thread", "inline"))
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    out = args.out or os.path.join(
        REPO, "REALTIME_torch_h100.json" if dev.type == "cuda"
        else f"REALTIME_torch_{dev.type}.json")
    points = []
    result = {
        "metric": "stream_server_pump_latency_vs_20ms_budget",
        "mode": "tick_pipelined",
        "drain": args.drain,
        "backend": dev.type,
        "device": describe(dev),
        "freq": 16000,
        "points": points,
    }

    def save() -> None:
        # the artifact point by point, so that a kill keeps the batches
        # that completed
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1)
        os.replace(tmp, out)

    for b in (int(x) for x in args.batches.split(",")):
        print(f"[realtime] batch {b}...", file=sys.stderr)
        points.append(bench_ticks(b, args.ticks, args.warmup, args.depth,
                                  args.drain, args.device))
        save()
    print(json.dumps({"points": [
        {k: p[k] for k in ("batch", "pump_p50_ms", "pump_p95_ms",
                           "pump_max_ms", "overruns",
                           "output_latency_p50_ms")} for p in points],
        "device": result["device"], "out": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
