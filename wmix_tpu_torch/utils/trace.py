"""Tracing / profiling instrumentation.

Port of `wmix_tpu/utils/trace.py`.  The reference's observability is
printf-level (wmix debug flag); here it is structured:

- `span(name, req=None)`: the program's own spans, placed where the work
  happens (the chain's stages, the AGC limiter's passes and kernel
  launch, the exact-layout AEC's blocks, the NS's transforms, window
  check and feature extraction, the device reads of `utils/turns.py`,
  each served tick's feed, pump, delivery and read).  Off by default
  (`enable()`, `disable()`): then a span is one check of a module flag
  and a shared no-op context manager.  On, a span
  records its name, its start and end on `time.time_ns()`, its thread
  (`threading.get_ident()`, whose low 32 bits the profiler's runtime
  events carry), the span it is nested in on that thread, and the
  request it serves (`req`: a chain's tick, a server's tick sequence
  number; a span without one takes its parent's), and opens a
  `torch.profiler.record_function` of its name, so a profiler running
  at the time shows it.  Spans are kept in memory: `snapshot()` gives
  totals and intervals, `reset()` clears them.  A span neither
  launches a kernel, reads the device nor synchronizes.
- `profile(logdir)`: a context manager around `torch.profiler.profile`
  (host and, where there is a card, CUDA activities) with the spans on
  for as long as it runs; on exit it writes a Chrome trace,
  `<logdir>/trace.json`, of everything run inside it, the program's
  spans included, and yields the profiler, so `key_averages()` can be
  read afterwards.
- `StepTimer`: cheap per-step wall-time accounting for a real-time loop:
  records step latencies and summarizes p50/p95/max against the budget.
  The stream daemon's pump runs under one.
- `OpCounter`: counts the aten operations run inside it (a
  `TorchDispatchMode`), all of them and those that are not views; on the
  card an operation that is not a view is about one kernel launch, so the
  count says what an eager package costs the host.  It also sums the
  bytes those operations read and write (each tensor argument and result
  once), what the same eager run moves through device memory.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional


class Interval(NamedTuple):
    """One finished span."""
    name: str
    start_ns: int           # time.time_ns()
    end_ns: int
    thread: int             # threading.get_ident()
    parent: Optional[str]   # the span it was nested in on its thread
    req: Optional[int]      # the request it served


_on = False                 # process-wide switch of span()
_intervals: List[Interval] = []
_local = threading.local()  # .stack: the open spans of this thread
_record_function = None     # torch.profiler.record_function, once on
_NO_SPAN = contextlib.nullcontext()     # what `span` returns while off


class _Span:
    __slots__ = ("name", "req", "parent", "rf", "t0")

    def __init__(self, name: str, req):
        self.name, self.req = name, req

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        if self.req is None and self.parent is not None:
            self.req = self.parent.req
        stack.append(self)
        self.rf = _record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        _intervals.append(Interval(
            self.name, self.t0, t1, threading.get_ident(),
            None if self.parent is None else self.parent.name, self.req))
        return False


def span(name: str, req: Optional[int] = None):
    """`with span(name) as sp:` records the block as a span while the
    spans are on (module docstring); `req` names the request it serves.
    A block that learns its request only inside sets `sp.req` (`sp` is
    None while the spans are off).  A keyword and not `**attrs`, so that
    a call with the spans off allocates nothing."""
    if not _on:
        return _NO_SPAN
    return _Span(name, req)


def enable() -> None:
    """Turn the spans on, for every thread of the process."""
    global _on, _record_function
    from torch.profiler import record_function
    _record_function = record_function
    _on = True


def disable() -> None:
    global _on
    _on = False


def snapshot() -> dict:
    """What was recorded since the last `reset()`: `intervals` (every
    finished span, in the order they ended) and `totals` ({name:
    (seconds, spans)})."""
    intervals = list(_intervals)
    totals: dict = {}
    for iv in intervals:
        s, n = totals.get(iv.name, (0.0, 0))
        totals[iv.name] = (s + (iv.end_ns - iv.start_ns) / 1e9, n + 1)
    return {"intervals": intervals, "totals": totals}


def reset() -> None:
    _intervals.clear()


class OpCounter:
    """Counts the aten operations dispatched inside `with OpCounter() as
    c:`; `c.ops` all of them, `c.launching` those that are not views, and
    `c.bytes` the bytes of the tensor arguments and results of the latter."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        counter = self
        self.ops = self.launching = self.bytes = 0

        def nbytes(tree) -> int:
            return sum(t.numel() * t.element_size()
                       for t in tree_leaves(tree)
                       if isinstance(t, torch.Tensor))

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                counter.ops += 1
                out = func(*args, **kwargs)
                if not getattr(func, "is_view", False):
                    counter.launching += 1
                    counter.bytes += nbytes((args, kwargs)) + nbytes(out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a torch.profiler trace into `logdir`/trace.json (open it
    in chrome://tracing or Perfetto), the program's spans on for as long
    as it runs."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class StepTimer:
    """Wall-time accounting for a real-time step loop.

    >>> t = StepTimer(budget_ms=20.0)
    >>> with t.step():         # per tick
    ...     tick(...)
    >>> t.summary()            # {'n': ..., 'p50_ms': ..., ...}
    """
    budget_ms: Optional[float] = None
    samples: List[float] = field(default_factory=list)
    overruns: int = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.samples.append(dt)
            if self.budget_ms is not None and dt > self.budget_ms:
                self.overruns += 1

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0}
        s = sorted(self.samples)
        n = len(s)
        out = {
            "n": n,
            "p50_ms": round(s[n // 2], 3),
            "p95_ms": round(s[min(n - 1, int(n * 0.95))], 3),
            "max_ms": round(s[-1], 3),
            "mean_ms": round(sum(s) / n, 3),
        }
        if self.budget_ms is not None:
            out["budget_ms"] = self.budget_ms
            out["overruns"] = self.overruns
        return out

    def reset(self):
        self.samples.clear()
        self.overruns = 0
