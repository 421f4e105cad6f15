"""chunk: the record chain driven by `RecordChain.run_chunk`, K packages a
dispatch, its inputs already on the card.

Set-up: the traffic is made on the card (it stays there, as a deployment
that captures on the device would have it), the chain is built with the
configuration's keywords, and one `run_chunk` of `warm_pkgs` packages
runs the chain's start-up packages, the priming package and a few steady
ones.

Window: whole chunks of `k` packages of every slot, the traffic cycled,
until `--seconds` have passed; each chunk's sampled outputs are copied
to the host as it ends, which waits for the device.

  streams   B x seconds of audio of the window's chunks / wall seconds
            from the first dispatch to the copy after the last chunk

With tracing on, `profile_chunks` more chunks are profiled after the
window, the same way.
"""
from __future__ import annotations

import time

from wbench.harness import streams_rate


def run(ctx) -> dict:
    import torch
    from wmix_tpu_torch.engine.chain import RecordChain
    a = ctx.args
    k = a["k"]
    mic, play = ctx.make_traffic()
    T = mic.shape[0]
    chain = RecordChain(ctx.batch, ctx.freq, device=ctx.device,
                        **ctx.chain_kw)
    sample = torch.tensor(ctx.sample, device=mic.device)
    done = 0
    ends = []

    def chunk(n):
        nonlocal done
        idx = torch.arange(done, done + n, device=mic.device) % T
        origin, pkg8k, vad = chain.run_chunk(mic.index_select(0, idx),
                                             play.index_select(0, idx))
        ctx.outputs.add_chunk(*(x.index_select(1, sample).cpu().numpy()
                                for x in (origin, pkg8k, vad)))
        done += n
        ends.append((done, time.perf_counter()))

    chunk(a["warm_pkgs"])
    warm = done
    t0 = ctx.begin_window()
    while True:
        chunk(k)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    t_end = time.perf_counter()
    n = done - warm
    # the chunk that ends nearest the window's middle splits it in two
    mid_done, mid_t = min(ends[1:], key=lambda e: abs(e[1] - t0 -
                                                      (t_end - t0) / 2))
    ctx.end_window(n, t_end - t0, (
        streams_rate(ctx.batch, mid_done - warm, mid_t - t0),
        streams_rate(ctx.batch, done - mid_done, t_end - mid_t))
        if mid_done < done else None)
    ctx.profiled(lambda: [chunk(k) for _ in range(a["profile_chunks"])],
                 k * a["profile_chunks"])
    return {"e2e": {"streams": streams_rate(ctx.batch, n, t_end - t0)},
            "attempted": n * ctx.batch, "failed": 0, "fed_pkgs": done,
            "window_s": t_end - t0}
