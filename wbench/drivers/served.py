"""served: the record chain served tick by tick through
`service/stream_server.py` `StreamServer`, in a closed loop.

Set-up: the traffic is made on the card and copied once to pageable host
memory (a front door hands the server host blocks); the server is built
with the configuration's chain, the drain thread started and every slot
opened with `open_stream`; `warm_ticks` ticks run the chain's start-up
packages, the priming package, the AEC's layout conversion and a few
steady packages, and are drained and read.

Window: each tick is `feed_batch` of the next package of every slot,
`tick_pipelined(depth)` and `read_batch` until nothing more is ready,
and the next tick is fed as soon as that returns (closed loop: a pump
paced to 20 ms would overrun on every tick today, so pacing would only
add a wait).  After `--seconds` the pipeline is flushed and the tail
read.  Every tick fed in the window is counted:

  streams         B x seconds of audio fed / wall seconds from the first
                  feed to the read of the last tick
  latency_p95_ms  the 95th percentile over the window's ticks of the
                  wall time from `feed_batch(tick j)` to the return of
                  the `read_batch` that delivered tick j

With tracing on, `profile_ticks` more ticks are profiled after the
window, the same way.
"""
from __future__ import annotations

import time

from wbench.harness import pct, streams_rate


def window_metrics(batch: int, feed_t, read_t, t0: float, t_end: float):
    """(streams, latency_p95_ms) of a window: every tick fed (`feed_t`,
    the clock before each `feed_batch`) counts, and tick j's latency ends
    at `read_t[j]`, the return of the `read_batch` that delivered it."""
    lat_ms = [1e3 * (r - f) for f, r in zip(feed_t, read_t)]
    return streams_rate(batch, len(feed_t), t_end - t0), pct(lat_ms, 0.95)


def run(ctx) -> dict:
    from wmix_tpu_torch.service.stream_server import StreamServer
    a = ctx.args
    depth = a["depth"]
    mic_d, play_d = ctx.make_traffic()
    mic, play = mic_d.cpu().numpy(), play_d.cpu().numpy()
    del mic_d, play_d
    ctx.reset_peak()
    T = mic.shape[0]
    srv = StreamServer(ctx.batch, ctx.freq, max_depth=depth,
                       device=ctx.device, **ctx.chain_kw)
    try:
        if a["drain_thread"]:
            srv.start_drain_thread()
        handles = [srv.open_stream() for _ in range(ctx.batch)]
        fed = 0
        read_t = []

        def feed():
            nonlocal fed
            with ctx.span("server.feed"):
                srv.feed_batch(handles, mic[fed % T], play[fed % T])
            srv.tick_pipelined(depth)
            fed += 1

        def read_ready():
            while True:
                with ctx.span("server.read"):
                    got = srv.read_batch(handles)
                if got is None:
                    return
                read_t.append(time.perf_counter())
                ctx.outputs.add(*got)

        def ticks(n):
            for _ in range(n):
                feed()
                read_ready()
            srv.flush_pipeline()
            read_ready()

        ticks(a["warm_ticks"])
        warm = fed
        feed_t = []
        t0 = ctx.begin_window()
        while True:
            feed_t.append(time.perf_counter())
            feed()
            read_ready()
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        srv.flush_pipeline()
        read_ready()
        t_end = time.perf_counter()
        n = fed - warm
        h = n // 2
        ctx.end_window(n, t_end - t0, (
            streams_rate(ctx.batch, h, read_t[warm + h - 1] - t0),
            streams_rate(ctx.batch, n - h,
                         t_end - read_t[warm + h - 1])) if h else None)
        streams, p95 = window_metrics(ctx.batch, feed_t,
                                      read_t[warm:warm + n], t0, t_end)
        ctx.profiled(lambda: ticks(a["profile_ticks"]), a["profile_ticks"])
        delivered = len(read_t)
        return {"e2e": {"streams": streams, "latency_p95_ms": p95},
                "attempted": n * ctx.batch,
                "failed": (fed - delivered) * ctx.batch,
                "fed_pkgs": fed, "window_s": t_end - t0}
    finally:
        srv.stop_drain_thread()
