"""The cells `x16k.served` (the exact-mode chain served) and `f16k.chunk`
(the fast chain by `run_chunk`, 25 packages a dispatch): whole runs on the
CPU at a tiny size through `run.run_cell`, as `test_wbench_run.py` runs
the first two cells.  A sound run is correct; one altered sample makes the
exact cell's comparison fail; the per-layer metrics of the exact path read
the program's spans, and nothing where the program has none."""
import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from wbench import harness, program_spans, run

ROOT = harness.ROOT
CELLS = ("x16k.served", "f16k.chunk")
EXACT_METRICS = ("aec.block_ms", "aec.blocks_per_pkg", "ns.rdft_ms",
                 "ns.window_read_ms")
SMALL = {"config": {"batch": 8, "check": {"streams": 8}},
         "traffic": {"audio_pkgs": 40,
                     "driver_args": {"warm_ticks": 6, "profile_ticks": 2,
                                     "warm_pkgs": 5, "k": 3,
                                     "profile_chunks": 1}}}
SEED = 2 ** 31 + 1234567


def _run(cell, trace=False, seconds=0.6):
    line, _, r = run.run_cell(harness.bench_spec(), cell, SEED, seconds,
                              trace, torch.device("cpu"), time.time(),
                              SMALL)
    return json.loads(line), r


@pytest.fixture
def program_tracer():
    """The program's spans on, as a traced run of the benchmark's command
    has them (`program_spans.switch_on` does nothing in a test)."""
    from wmix_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, r = _run(cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {"setup_s", "streams"} <= set(out["metrics"])
    warm = SMALL["traffic"]["driver_args"][
        "warm_ticks" if cell == "x16k.served" else "warm_pkgs"]
    assert len(r.outputs) == r.window_pkgs + warm
    held = set(harness.config(r.cfg["name"])["check"]["limits"])
    assert held <= set(out["compared"])
    if cell == "x16k.served":
        assert r.cfg["mode"] == "exact"
        assert out["compared"]["mismatches"]["value"] == 0


def test_traced_exact_run_reads_the_exact_paths_spans(program_tracer):
    out, _ = _run("x16k.served", trace=True)
    assert out["correct"], out["compared"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == set(EXACT_METRICS)
    assert got["aec.blocks_per_pkg"] == 5.0
    assert got["aec.block_ms"] > 0 and got["ns.rdft_ms"] > 0
    assert got["ns.window_read_ms"] > 0


def test_traced_chunk_run_reads_the_transforms(program_tracer):
    out, _ = _run("f16k.chunk", trace=True)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"ns.rdft_ms"}
    assert out["metrics"]["ns.rdft_ms"]["value"] > 0


def test_a_program_without_the_spans_reads_nothing():
    """A parent without the exact path's spans (or a run with the tracer
    off) gives no value, and no error."""
    ctx = run.Run("x16k.served", harness.config("record.x16k"),
                  harness.traffic("conversation.served"), SEED, 1.0, True,
                  torch.device("cpu"), time.time())
    ctx.window_pkgs, ctx.window_s = 10, 1.0
    ctx.window_end_epoch = time.time()
    assert program_spans.window(ctx) == []
    for name in EXACT_METRICS:
        assert harness.load_module("layers", name).read(ctx) is None, name


def test_one_altered_sample_fails_the_exact_served_cell(monkeypatch):
    from wmix_tpu_torch.engine.chain import RecordChain
    step = RecordChain.step
    calls = {"n": 0}

    def one_sample_off(self, mic, play):
        origin, pkg8k, vad = step(self, mic, play)
        calls["n"] += 1
        if calls["n"] == 4:
            origin = origin.clone()
            origin[:, 100] = torch.where(origin[:, 100] > 0, -3000, 3000)
        return origin, pkg8k, vad
    monkeypatch.setattr(RecordChain, "step", one_sample_off)
    out, _ = _run("x16k.served")
    assert not out["correct"], out["compared"]
    assert out["compared"]["mismatches"]["value"] >= 1


def test_set_up_loads_no_jax_or_wmix_tpu():
    code = textwrap.dedent(f"""
        import json, sys, time, torch
        from wbench import harness, run
        for cell, trace in (("x16k.served", True), ("f16k.chunk", False)):
            run.run_cell(harness.bench_spec(), cell, 3, 0.3, trace,
                         torch.device("cpu"), time.time(), {SMALL!r})
        print(json.dumps(harness.forbidden_modules()))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.splitlines()[-1]) == []
