"""Tracing / profiling instrumentation.

Port of `wmix_tpu/utils/trace.py`.  The reference's observability is
printf-level (wmix debug flag); here it is structured:

- `profile(logdir)`: a context manager around `torch.profiler.profile`
  (host and, where there is a card, CUDA activities); on exit it writes a
  Chrome trace, `<logdir>/trace.json`, of everything run inside it and
  yields the profiler, so `key_averages()` can be read afterwards.
- `annotate(name)`: a `torch.profiler.record_function` span, so host
  phases (planning, staging, socket IO) show up by name inside the trace.
- `StepTimer`: cheap per-step wall-time accounting for a real-time loop:
  records step latencies and summarizes p50/p95/max against the budget.
  The stream daemon's pump runs under one.
- `OpCounter`: counts the aten operations run inside it (a
  `TorchDispatchMode`), all of them and those that are not views; on the
  card an operation that is not a view is about one kernel launch, so the
  count says what an eager package costs the host.  It also sums the
  bytes those operations read and write (each tensor argument and result
  once), what the same eager run moves through device memory.

Env var:
  WMIX_TRACE_STEPS=1     `steps_enabled()`: step accounting asked for
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional


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


def steps_enabled() -> bool:
    return os.environ.get("WMIX_TRACE_STEPS", "") not in ("", "0")


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a torch.profiler trace into `logdir`/trace.json (open it
    in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside the trace; next to no cost when no trace is
    being captured."""
    from torch.profiler import record_function
    with record_function(name):
        yield


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
