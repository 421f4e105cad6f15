"""The profiled stretch of a traced run: `torch.profiler` with the CUDA
activity only, over a few steady packages, reduced to what the per-layer
metrics and the breakdown read.

  busy_s        the union of the device's own events (kernels, copies,
                fills) inside the stretch
  window_s      the stretch's wall time
  kernels       device kernels launched, by name: (count, seconds)
  ops           all device events by name: (count, seconds)
  idle_by_span  idle device time by the innermost host span
                (`harness.Spans`) open at the time

The CPU activity is left off: recording every aten operation slowed a
tick of the served cell on the card from 0.21 s to 1-2 s, against 0.75 s
with the CUDA activity alone, so the host's spans are taken on the wall
clock (`time.time_ns`), which the trace's timestamps share.  The raw
events are read from the profiler's results
(`profiler.kineto_results.events()`), which is far cheaper than building
its function-event tree.  Nothing is written to disk.
"""
from __future__ import annotations

import time
from collections import defaultdict

OUTSIDE = "outside spans"
_NOT_KERNELS = ("Memcpy", "Memset")


def _union(intervals):
    """Merged [(start, end)] of the intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _labelled_segments(spans, lo, hi):
    """Disjoint [(start, end, name)] covering [lo, hi): the innermost span
    open in each, or OUTSIDE.  Spans nest: they are opened and closed on
    one thread."""
    bounds = []
    for name, s, e in spans:
        bounds.append((s, 1, name))
        bounds.append((e, 0, name))
    bounds.sort(key=lambda b: (b[0], b[1]))
    stack, segs, cur = [], [], lo
    for t, is_start, name in bounds:
        t = min(max(t, lo), hi)
        if t > cur:
            segs.append((cur, t, stack[-1] if stack else OUTSIDE))
            cur = t
        if is_start:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if cur < hi:
        segs.append((cur, hi, stack[-1] if stack else OUTSIDE))
    return segs


def reduce_events(device_events, spans, lo: int, hi: int) -> dict:
    """The stretch [lo, hi) (ns) from the device's events, each a tuple
    (name, start_ns, end_ns), and the host spans (name, start_ns,
    end_ns)."""
    device = []
    kernels = defaultdict(lambda: [0, 0.0])
    ops = defaultdict(lambda: [0, 0.0])
    for name, s, e in device_events:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        device.append((s, e))
        ops[name][0] += 1
        ops[name][1] += (e - s) / 1e9
        if not name.startswith(_NOT_KERNELS):
            kernels[name][0] += 1
            kernels[name][1] += (e - s) / 1e9
    busy = _union(device)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < hi:
        gaps.append((prev, hi))
    segs = _labelled_segments(spans, lo, hi)
    idle = defaultdict(float)
    i = 0
    for gs, ge in gaps:        # both lists sorted and disjoint
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < ge:
            ss, se, name = segs[j]
            idle[name] += (min(ge, se) - max(gs, ss)) / 1e9
            j += 1
    return {"window_s": (hi - lo) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "ops": {k: tuple(v) for k, v in ops.items()},
            "idle_by_span": dict(idle)}


def profile_stretch(fn, spans, sync) -> dict:
    """Run `fn` under the profiler (CUDA activity), the host spans
    recorded on the wall clock, and reduce the trace (`reduce_events`);
    adds `reduce_s`, the seconds the reduction took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    spans.intervals = recorded = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lo = time.time_ns()
            fn()
            sync()
            hi = time.time_ns()
    finally:
        spans.intervals = None
    t0 = time.perf_counter()
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA
              and not ev.is_user_annotation()]
    del prof
    out = reduce_events(events, recorded, lo, hi)
    out["reduce_s"] = time.perf_counter() - t0
    return out
