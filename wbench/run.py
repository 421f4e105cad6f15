"""Run one cell of the benchmark and print its result line.

    python3 -m wbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration, traffic mix, driver and per-layer
metrics are files found by name (`wbench/harness.py`).  A run makes its
inputs on the card from the seed, sets up the program and warms every
shape its traffic uses, measures for `--seconds`, and then checks the
sampled outputs against the plain reference (`wbench/check.py`).  With
`--trace 0` the line carries the cell's end-to-end metrics; with
`--trace 1` host spans are placed around the program's layers for the
window and a short stretch after it is profiled, and the line carries the
per-layer metrics, the device's busy time and a breakdown.

It exits non-zero and prints no result without as many CUDA devices as
the cell asks for, or when `jax`, `jaxlib`, `flax` or `wmix_tpu` is
loaded once the window has closed.  Build caches stay inside the
checkout (`build/`).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import os
import sys
import time

from wbench import check, harness, profiling
from wbench.harness import Outputs, Spans

TOP = 10                 # entries of each breakdown list
NAME_CHARS = 160         # of a device operation's name in the breakdown


class Run:
    """What a driver and the per-layer readers see of one run."""

    def __init__(self, cell: str, cfg: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, start: float):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.start = device, start
        self.batch, self.freq = cfg["batch"], cfg["freq"]
        self.chain_kw = dict(cfg["chain"])
        self.args = traffic["driver_args"]
        self.sample = check.sample_slots(
            self.batch, min(cfg["check"]["streams"], self.batch), seed)
        self.outputs = Outputs(self.sample)
        self.spans = Spans() if trace else None
        self.inputs = None
        self.setup_s = None
        self.window_pkgs = 0
        self.window_s = None
        self.window_spans = {}
        self.profile = None
        self.profile_pkgs = 0
        self.window_end_epoch = None
        self.halves = None

    # -- for drivers ----------------------------------------------------

    def make_traffic(self):
        """(mic, play) int16 [audio_pkgs, B, pkg] on the device, from the
        seed; the sampled slots' copy is kept on the host for the check."""
        import torch
        gen = harness.load_module("traffic", self.traffic["generator"])
        mic, play = gen.generate(self.batch, self.traffic["audio_pkgs"],
                                 self.freq, self.seed,
                                 self.traffic["params"], self.device)
        idx = torch.tensor(self.sample, device=mic.device)
        self.inputs = tuple(x.index_select(1, idx).cpu().numpy()
                            for x in (mic, play))
        self.reset_peak()
        return mic, play

    def reset_peak(self) -> None:
        """Start the device's memory peak afresh, so that the peak the line
        reports leaves out the generator's temporaries (and, called again
        once a driver has freed them, the harness's own buffers)."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def span(self, name: str):
        """A harness span (for the breakdown) when tracing, else nothing."""
        return self.spans.span(name) if self.spans else \
            contextlib.nullcontext()

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin_window(self) -> float:
        """End of set-up: the device drained, set-up's garbage collected
        and frozen, the spans cleared.  Returns the window's start
        (`time.perf_counter`)."""
        self.sync()
        gc.collect()
        gc.freeze()
        if self.spans:
            self.spans.reset()
        self.setup_s = time.time() - self.start
        return time.perf_counter()

    def end_window(self, packages: int, wall_s: float,
                   halves: tuple | None = None) -> None:
        """`halves`: the streams rate of the window's first and second
        half (for the notes, to tell drift within a run from noise
        between runs)."""
        self.window_pkgs = packages
        self.window_s = wall_s
        self.window_end_epoch = time.time()
        self.halves = halves
        if self.spans:
            self.window_spans = self.spans.snapshot()

    def profiled(self, fn, packages: int) -> None:
        """With tracing on, run `fn` (`packages` more packages of the
        timed path) under the profiler; a CPU run has no device to trace."""
        if self.trace and self.device.type == "cuda":
            self.profile = profiling.profile_stretch(fn, self.spans,
                                                     self.sync)
            self.profile_pkgs = packages

    # -- for per-layer readers --------------------------------------------

    def span_ms_per_pkg(self, name: str):
        s, n = self.window_spans.get(name, (0.0, 0))
        return 1e3 * s / self.window_pkgs if n and self.window_pkgs \
            else None

    def span_ms_per_call(self, name: str):
        s, n = self.window_spans.get(name, (0.0, 0))
        return 1e3 * s / n if n else None


def _device_info(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type,
                "count": chips, "memory_peak_bytes": 0}
    from wmix_tpu_torch.device import describe
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "card": describe(device)}


def _override(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _override(out[k], v)
        else:
            out[k] = v
    return out


def run_cell(spec: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, start: float, overrides: dict | None = None):
    """One run of `cell`.  Returns (result line, lines for stderr, the
    Run).  `overrides` ({"config": {...}, "traffic": {...}}, merged into
    the files' contents) is for tests at small sizes."""
    import torch
    wl = harness.find(spec, "workloads", cell)
    over = overrides or {}
    cfg = _override(harness.config(wl["config"]), over.get("config"))
    traffic = _override(harness.traffic(wl["traffic"]), over.get("traffic"))
    e2e, per_layer = harness.cell_metrics(spec, cell)
    layers = {m["name"]: harness.load_module("layers", m["name"])
              for m in per_layer} if trace else {}
    run = Run(cell, cfg, traffic, seed, seconds, trace, device, start)
    with check.mode(cfg):
        if trace:
            seen = set()
            for mod in layers.values():
                for target in mod.SPANS:
                    if target not in seen:
                        seen.add(target)
                        run.spans.install(*target)
        try:
            driver = harness.load_module("drivers", traffic["driver"])
            out = driver.run(run)
        finally:
            if run.spans:
                run.spans.uninstall()
            gc.unfreeze()
        dev = _device_info(device, wl["chips"])
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)    # the reference is many small CPU ops
        try:
            ok, compared, n_cmp = check.judge(cfg, run.outputs, *run.inputs,
                                              out["fed_pkgs"])
        finally:
            torch.set_num_threads(threads)
    correct = ok and out["failed"] == 0
    metrics = {}
    breakdown = None
    if trace:
        for m in per_layer:
            value = layers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        if run.profile:
            dev["busy_s"] = run.profile["busy_s"]
            dev["window_s"] = run.profile["window_s"]
            ops = sorted(run.profile["ops"].items(),
                         key=lambda kv: -kv[1][1])[:TOP]
            gaps = sorted(run.profile["idle_by_span"].items(),
                          key=lambda kv: -kv[1])[:TOP]
            breakdown = {"device_ops": [[k[:NAME_CHARS], s]
                                        for k, (_, s) in ops],
                         "idle_gaps": [[k, s] for k, s in gaps]}
    else:
        for m in e2e:
            value = run.setup_s if m["name"] == "setup_s" else \
                out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
    line = harness.result_line(correct, out["attempted"], out["failed"],
                               metrics, dev, compared, breakdown)
    notes = [f"cell {cell} seed {seed}: window {out['window_s']:.3f} s, "
             f"{run.window_pkgs} packages; {n_cmp} packages of "
             f"{len(run.sample)} slots compared"]
    if run.window_end_epoch is not None:
        notes.append(f"window on the wall clock: "
                     f"{run.window_end_epoch - out['window_s']:.3f} to "
                     f"{run.window_end_epoch:.3f}; streams by half: "
                     f"{run.halves}")
    if run.profile:
        notes.append(f"profiled {run.profile_pkgs} packages: "
                     f"{len(run.profile['ops'])} device op names, "
                     f"reduced in {run.profile['reduce_s']:.2f} s")
    notes += [f"{k} {v} limit {lim}" for k, (v, lim) in compared.items()]
    return line, notes, run


def main(argv=None) -> int:
    start = harness.process_start_time()
    p = argparse.ArgumentParser(prog="python3 -m wbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    build = os.path.join(harness.ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    spec = harness.bench_spec()
    wl = harness.find(spec, "workloads", args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"wbench: cell {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, notes, _ = run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda"), start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"wbench: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(notes) + "\n")
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
