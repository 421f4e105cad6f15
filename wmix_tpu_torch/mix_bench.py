"""Batched play/mix engine bench of the port: concurrent mixed play streams
per card through the device mix bus (`engine/mixbus.py`).  The
counterpart of `mix_bench.py`.

    python -m wmix_tpu_torch.mix_bench [--batches 256,1024] [--sources 4]
        [--ticks 100] [--depth 8] [--device cpu] [--out PATH]

The reference's hot loop is `wmix_load_data` + `wmix_play_thread`
(src/wmix.c:1639-1957, 1304-1516): one engine, a handful of play tasks,
20 ms packages.  Here B engines x S sources per tick mix into [B, R, chn]
device rings in S waves, then one drain pulls the tick's package of every
engine, its copy to the host collected `depth` ticks later.

streams = B * S * audio_seconds / wall_seconds (real-time capacity).

Writes `MIX_torch_h100.json` at the repo root by default
(`MIX_torch_cpu.json` with `--device cpu`), with `backend` and `device`
(the card's name and power limit), and prints one JSON line.  The card is
the default; without one it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque

import numpy as np

from wmix_tpu_torch.config import EngineConfig
from wmix_tpu_torch.device import describe, resolve_device
from wmix_tpu_torch.engine.mixbus import DRAIN_SLOTS, MixBus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench(batch: int, sources: int, n_ticks: int, warmup: int = 4,
          depth: int = 8, device=None, drained=None) -> dict:
    """mix_bench.py `bench` (:29-90) over the port's MixBus: seeded dense
    waves [S, B, T, chn], every engine's j-th source in wave j, divisors
    1-3 by engine; per tick one `mix_waves` and one `drain_async(1)`.
    `drained`, a list, receives every drained package [B, T, chn] in
    order, warm-up ticks first."""
    if not 1 <= depth <= DRAIN_SLOTS:
        raise ValueError(f"depth {depth} outside 1..{DRAIN_SLOTS}, the "
                         "drains a MixBus keeps in flight")
    cfg = EngineConfig(chn=1, freq=16000)
    bus = MixBus(batch, cfg, device=device)
    rng = np.random.RandomState(0)

    # the per-source package contributions, built once (the host's
    # conversion does not depend on the data; the bench measures the
    # device bus)
    pkg = cfg.frame_num
    waves = rng.randint(-8000, 8000,
                        (sources, batch, pkg, cfg.chn)).astype(np.int16)
    lens = np.full((sources, batch), pkg, np.int32)
    rdces = np.tile(1 + (np.arange(batch, dtype=np.int32) % 3),
                    (sources, 1))

    heads = np.zeros(batch, np.int64)
    pending: deque = deque()

    def collect():
        pcm = np.asarray(pending.popleft())
        if drained is not None:
            drained.append(pcm)

    def tick(i):
        # one mix call + one drain per tick; the drain's copy to the host
        # completes while later ticks run (the real-time pump pattern).
        # The drain of `depth` ticks ago is collected before this tick's
        # starts, which keeps at most `depth` copies in the bus's
        # DRAIN_SLOTS pinned buffers (mix_bench.py collects it just after)
        base = (i * pkg) % cfg.ring_frames
        hf = np.tile((heads + base) % cfg.ring_frames, (sources, 1))
        bus.mix_waves(hf, waves, lens, rdces)
        if len(pending) == depth:
            collect()
        pending.append(bus.drain_async(1))

    for i in range(warmup):
        tick(i)
    while pending:
        collect()

    t0 = time.perf_counter()
    for i in range(n_ticks):
        tick(warmup + i)
    while pending:
        collect()
    dt = time.perf_counter() - t0

    audio_s = n_ticks * 0.02
    return {
        "batch": batch,
        "depth": depth,
        "sources": sources,
        "ticks": n_ticks,
        "wall_s": round(dt, 3),
        "tick_ms": round(dt / n_ticks * 1e3, 3),
        "mixed_streams": round(batch * sources * audio_s / dt, 1),
        "engines_realtime": round(batch * audio_s / dt, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="256,1024")
    ap.add_argument("--sources", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    points = []
    for b in (int(x) for x in args.batches.split(",")):
        print(f"[mix] batch {b}...", file=sys.stderr)
        points.append(bench(b, args.sources, args.ticks, depth=args.depth,
                            device=args.device))
    result = {
        "metric": "mixed_play_streams_per_chip",
        "backend": dev.type,
        "device": describe(dev),
        "points": points,
    }
    out = args.out or os.path.join(
        REPO, "MIX_torch_h100.json" if dev.type == "cuda"
        else f"MIX_torch_{dev.type}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"points": points, "device": result["device"],
                      "out": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
