"""What every cell of the benchmark shares: finding a cell's files by name,
the arithmetic of its end-to-end metrics, host spans, the outputs kept
for the check, and the result line.

A cell (an entry of `workloads` in `BENCHMARK.json`) names a
configuration and a traffic mix.  Each is a file of its own, found by
name, as is each driver and each per-layer metric:

  wbench/configs/<config>.json    the deployment: chain keywords, batch,
                                  source, guarantees, the check's limits
  wbench/traffic/<mix>.json       the traffic: its generator module (under
                                  wbench/traffic/), the generator's
                                  parameters, the driver and its parameters
  wbench/drivers/<driver>.py      `run(ctx)`: set-up, window, profiled
                                  stretch over one program entry
  wbench/layers/<metric>.py       `SPANS` (what to wrap) and `read(ctx)`

So a new cell is one entry in `BENCHMARK.json` plus any new files, and no
file of the harness changes.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict

WBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(WBENCH)
BENCHMARK_JSON = os.path.join(ROOT, "BENCHMARK.json")

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "wmix_tpu")

PKG_S = 0.02            # a package is 20 ms of audio in every cell


# --------------------------------------------------------- files by name

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_spec(path: str = BENCHMARK_JSON) -> dict:
    return load_json(path)


def find(spec: dict, key: str, name: str) -> dict:
    """The entry of `spec[key]` called `name`."""
    for entry in spec[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(WBENCH, "configs", name + ".json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(WBENCH, "traffic", name + ".json"))


def load_module(kind: str, name: str):
    """wbench/<kind>/<name>.py as a module (a name may hold dots)."""
    path = os.path.join(WBENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"wbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str):
    """(end_to_end, per_layer) entries that the cell reports: those with
    no `workloads` key, and those that list the cell."""
    def mine(m):
        return cell in m.get("workloads", [cell])
    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


# ------------------------------------------------------------ arithmetic

def pct(values, q: float) -> float:
    """The sorted sample at int(n * q) (realtime_bench.py's percentile)."""
    s = sorted(values)
    return s[min(len(s) - 1, int(len(s) * q))]


def streams_rate(slots: int, packages: int, wall_s: float) -> float:
    """Open slots x seconds of audio completed / wall seconds."""
    return slots * packages * PKG_S / wall_s


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in FORBIDDEN, compared
    whole (`wmix_tpu_torch` is not `wmix_tpu`)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_start_time() -> float:
    """This process's start, in `time.time()` seconds: /proc's start
    tick against the boot time; the time of this call where /proc has
    neither."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


# ------------------------------------------------------------ host spans

class Spans:
    """Host time of named spans, placed at run time by wrapping the
    program's functions from the benchmark's own files.  A span's time is
    host time: it holds whatever the device makes the host wait for
    inside it.  While `intervals` is a list, each span also appends
    (name, start, end) on the wall clock in ns (`time.time_ns`, the clock
    the profiler's trace is stamped with), so a profiled stretch can tell
    what the host was doing in each idle gap of the device."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.intervals = None
        self._undo = []

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        w = time.time_ns() if self.intervals is not None else 0
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t
            self.count[name] += 1
            if self.intervals is not None:
                self.intervals.append((name, w, time.time_ns()))

    def wrap(self, name: str, fn):
        def wrapped(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return wrapped

    def install(self, name: str, module: str, attr: str,
                kind: str = "call") -> None:
        """Wrap `module.attr` (a dotted attribute such as
        "RecordChain.step"): `kind` "call" times each call; "returned"
        times each call of the function that a call returns (a maker
        of package bodies)."""
        obj = importlib.import_module(module)
        *outer, last = attr.split(".")
        for part in outer:
            obj = getattr(obj, part)
        orig = getattr(obj, last)
        if kind == "call":
            new = self.wrap(name, orig)
        elif kind == "returned":
            def new(*args, **kw):
                return self.wrap(name, orig(*args, **kw))
        else:
            raise ValueError(f"span kind {kind!r}")
        setattr(obj, last, new)
        self._undo.append((obj, last, orig))

    def uninstall(self) -> None:
        while self._undo:
            obj, last, orig = self._undo.pop()
            setattr(obj, last, orig)

    def snapshot(self) -> dict:
        """{span: (seconds, calls)} so far."""
        return {k: (self.total[k], self.count[k]) for k in self.total}

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()


# ------------------------------------------------- outputs for the check

class Outputs:
    """The sampled slots' outputs, package by package from the first, as
    the timed path delivered them (numpy)."""

    def __init__(self, sample):
        self.sample = list(sample)
        self.origin, self.pkg8k, self.vad = [], [], []

    def add(self, origin, pkg8k, vad) -> None:
        """One package of every slot: [B, pkg], [B, n8k], [B]."""
        self.origin.append(origin[self.sample])
        self.pkg8k.append(pkg8k[self.sample])
        self.vad.append(vad[self.sample])

    def add_chunk(self, origin, pkg8k, vad) -> None:
        """K packages of the sampled slots already: [K, S, ...]."""
        for k in range(origin.shape[0]):
            self.origin.append(origin[k])
            self.pkg8k.append(pkg8k[k])
            self.vad.append(vad[k])

    def __len__(self) -> int:
        return len(self.origin)


# --------------------------------------------------------- the run's line

def result_line(correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, compared: dict,
                breakdown: dict | None = None) -> str:
    """The contract's last line: `metrics` {name: (value, unit)},
    `compared` {name: (value, limit)} under its own key, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    return json.dumps(out)
