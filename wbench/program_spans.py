"""The program's own spans (`wmix_tpu_torch/utils/trace.py`), for the
per-layer metrics that read them.

The harness loads a cell's layer files only for a traced run, and before
the cell's `run(ctx)` starts.  A layer file that reads the program's spans
calls `switch_on()` as it is loaded.  In the process of the benchmark's
command (`python3 -m wbench.run`) that turns the program's tracer on, and
it stays on, recording, to the end of the process; anywhere else (a test
that loads the layer files) `switch_on()` does nothing.  `window(ctx)`
keeps the spans that ended inside the window (the `window_s` seconds up
to `window_end_epoch`), so set-up's and the profiled stretch's are left
out.  A program without the tracer (no `trace.enable`) records nothing,
and every reader returns None.

This stands in for what `run.py` should do itself: turn the tracer on
with `--trace 1`, reset it as the window begins and take its snapshot as
the window ends, with no side effect of loading a layer file.
"""
from __future__ import annotations

import sys
from collections import defaultdict

COMMAND_MODULE = "wbench.run"       # the benchmark's command, run with -m


def _trace():
    from wmix_tpu_torch.utils import trace
    return trace if hasattr(trace, "enable") else None


def switch_on() -> None:
    """Turn the program's tracer on, in the benchmark's own process only."""
    main = getattr(sys.modules.get("__main__"), "__spec__", None)
    if getattr(main, "name", None) != COMMAND_MODULE:
        return
    trace = _trace()
    if trace is not None:
        trace.enable()


def window(ctx) -> list:
    """The program's spans (`trace.Interval`) that ended in the window."""
    trace = _trace()
    if trace is None or ctx.window_end_epoch is None or not ctx.window_s:
        return []
    hi = int(ctx.window_end_epoch * 1e9)
    lo = hi - int(ctx.window_s * 1e9)
    return [iv for iv in trace.snapshot()["intervals"]
            if lo < iv.end_ns <= hi]


def _ms(iv) -> float:
    return (iv.end_ns - iv.start_ns) / 1e6


def ms_per_pkg(ctx, name: str):
    """Host time of the spans `name` in the window, ms per package."""
    ivs = [iv for iv in window(ctx) if iv.name == name]
    if not ivs or not ctx.window_pkgs:
        return None
    return sum(map(_ms, ivs)) / ctx.window_pkgs


def spans_per_pkg(ctx, name: str):
    n = sum(iv.name == name for iv in window(ctx))
    return n / ctx.window_pkgs if n and ctx.window_pkgs else None


def self_ms_per_pkg(ctx, name: str):
    """The spans `name`, less the part of each that its child spans
    cover, ms per package."""
    ivs = window(ctx)
    children = defaultdict(list)
    for iv in ivs:
        if iv.parent == name:
            children[iv.thread, iv.req].append((iv.start_ns, iv.end_ns))
    total, n = 0, 0
    for iv in ivs:
        if iv.name != name:
            continue
        n += 1
        covered, reach = 0, iv.start_ns
        for s, e in sorted(children[iv.thread, iv.req]):
            s, e = max(s, reach, iv.start_ns), min(e, iv.end_ns)
            if e > s:
                covered += e - s
                reach = e
        total += iv.end_ns - iv.start_ns - covered
    if not n or not ctx.window_pkgs:
        return None
    return total / 1e6 / ctx.window_pkgs


def tick_stamps(ctx) -> dict:
    """{tick: {span name: Interval}} of the stream server's spans in the
    window, for the ticks fed in it."""
    by_tick = defaultdict(dict)
    for iv in window(ctx):
        if iv.name.startswith("stream_server.") and iv.req is not None:
            by_tick[iv.req][iv.name] = iv
    return {t: s for t, s in by_tick.items() if "stream_server.feed" in s}


def mean_gap_ms(ctx, after: str, before: str):
    """The mean over the window's ticks of the end of span `before` less
    the end of span `after`, in ms."""
    gaps = [(s[before].end_ns - s[after].end_ns) / 1e6
            for s in tick_stamps(ctx).values() if after in s and before in s]
    return sum(gaps) / len(gaps) if gaps else None
