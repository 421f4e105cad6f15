"""Whole runs on the CPU at a tiny size: the harness's look for a chip is
skipped (`run.run_cell` with the CPU), the rest of a run is driven, and
the outcome read.  A sound run comes out correct; a run with the timed
path broken underneath comes out not correct.  Runs in subprocesses show
what a run's process loads and that a new cell needs no edit to the
harness."""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from wbench import harness, run

ROOT = harness.ROOT
CELLS = ("f16k.served", "i16k.chunk")
SMALL = {"config": {"batch": 8, "check": {"streams": 8}},
         "traffic": {"audio_pkgs": 40,
                     "driver_args": {"warm_ticks": 6, "profile_ticks": 2,
                                     "warm_pkgs": 5, "k": 3,
                                     "profile_chunks": 1}}}
SEED = 2 ** 31 + 99


def _run(cell, trace=False, seconds=0.6):
    line, notes, r = run.run_cell(harness.bench_spec(), cell, SEED, seconds,
                                  trace, torch.device("cpu"), time.time(),
                                  SMALL)
    return json.loads(line), r


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, r = _run(cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {"setup_s", "streams"} <= set(out["metrics"])
    assert len(r.outputs) == r.window_pkgs + SMALL["traffic"][
        "driver_args"]["warm_ticks" if cell == "f16k.served" else
                       "warm_pkgs"]


def test_traced_run_reports_the_cells_span_metrics():
    out, _ = _run("i16k.chunk", trace=True)
    assert out["correct"]
    spans = {"chain.enqueue_ms", "plan.ms", "nsx.ms", "aecm.ms", "agc.ms",
             "vad.ms"}
    assert spans <= set(out["metrics"])
    # no device on the CPU: the trace's metrics are left out, not zero
    assert "device.idle" not in out["metrics"]
    assert "streams" not in out["metrics"]


def _clone_state(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    return type(tree)(*(_clone_state(v) for v in tree))


def _fault_state_unchanged(step):
    def faulty(self, mic, play):
        saved = _clone_state(self.state)
        outs = step(self, mic, play)
        self.state = saved
        return outs
    return faulty


def _fault_half_batch(step):
    def faulty(self, mic, play):
        origin, pkg8k, vad = step(self, mic, play)
        half = origin.shape[0] // 2
        origin, pkg8k, vad = origin.clone(), pkg8k.clone(), vad.clone()
        origin[half:], pkg8k[half:], vad[half:] = 0, 0, 0
        return origin, pkg8k, vad
    return faulty


def _fault_answer_altered(step):
    """Every origin package 8 LSB off where the chain produces it: more
    than the float cell's 4 LSB tolerance, on every sample.  A single
    altered sample hides inside that tolerance; the integer cell's exact
    comparison sees one too (`test_one_altered_sample_fails_the_exact_cell`)."""
    def faulty(self, mic, play):
        origin, pkg8k, vad = step(self, mic, play)
        return (origin.to(torch.int32) + 8).clamp(-32768, 32767).to(
            torch.int16), pkg8k, vad
    return faulty


def _fault_one_sample(step):
    calls = {"n": 0}

    def faulty(self, mic, play):
        origin, pkg8k, vad = step(self, mic, play)
        calls["n"] += 1
        if calls["n"] == 4:
            origin = origin.clone()
            origin[0, 100] = torch.where(origin[0, 100] > 0, -3000, 3000)
        return origin, pkg8k, vad
    return faulty


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch_left_out": _fault_half_batch,
          "answer_altered": _fault_answer_altered}
# the exchange between chips: both cells run on one chip, with no exchange


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from wmix_tpu_torch.engine.chain import RecordChain
    monkeypatch.setattr(RecordChain, "step",
                        FAULTS[fault](RecordChain.step))
    out, _ = _run(cell)
    assert not out["correct"], out["compared"]


def test_one_altered_sample_fails_the_exact_cell(monkeypatch):
    from wmix_tpu_torch.engine.chain import RecordChain
    monkeypatch.setattr(RecordChain, "step",
                        _fault_one_sample(RecordChain.step))
    out, _ = _run("i16k.chunk")
    assert not out["correct"], out["compared"]
    assert out["compared"]["mismatches"]["value"] >= 1


def _script(body: str) -> str:
    return textwrap.dedent(body)


def test_set_up_loads_no_jax_or_wmix_tpu():
    code = _script(f"""
        import json, sys, time, torch
        from wbench import harness, run
        run.run_cell(harness.bench_spec(), "f16k.served", 3, 0.3, True,
                     torch.device("cpu"), time.time(), {SMALL!r})
        run.run_cell(harness.bench_spec(), "i16k.chunk", 3, 0.3, False,
                     torch.device("cpu"), time.time(), {SMALL!r})
        print(json.dumps(harness.forbidden_modules()))
        print(json.dumps(sorted(m for m in sys.modules
                                if m.startswith("wmix_tpu_torch."))))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    bad, port = (json.loads(x) for x in res.stdout.splitlines()[-2:])
    assert bad == []
    assert "wmix_tpu_torch.engine.chain" in port
    measuring = {"wmix_tpu_torch.bench", "wmix_tpu_torch.realtime_bench",
                 "wmix_tpu_torch.mix_bench", "wmix_tpu_torch.codec_bench",
                 "wmix_tpu_torch.graft_entry", "wmix_tpu_torch.parity"}
    assert not measuring & set(port)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "wmix_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_without_a_card_the_run_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "wbench.run", "--workload", "f16k.served",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_new_cell_and_metric_need_no_edit(tmp_path):
    """A configuration, a mix and a per-layer metric dropped in as files,
    with one entry each in BENCHMARK.json, are found by name: the
    harness's files are left as they are."""
    shutil.copytree(os.path.join(ROOT, "wbench"), tmp_path / "wbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (tmp_path / "wbench" / p).read_bytes()
              for p in ("run.py", "harness.py", "check.py",
                        "drivers/chunk.py")}
    spec = harness.bench_spec()
    cfg = harness.config("record.i16k")
    cfg.update(name="record.i8k", freq=8000, batch=4)
    (tmp_path / "wbench/configs/record.i8k.json").write_text(
        json.dumps(cfg))
    tr = harness.traffic("conversation.chunk")
    tr["audio_pkgs"] = 20
    tr["driver_args"].update(k=2, warm_pkgs=3, profile_chunks=1)
    (tmp_path / "wbench/traffic/conversation.short.json").write_text(
        json.dumps(tr))
    (tmp_path / "wbench/layers/agc.calls.py").write_text(_script("""
        SOURCE = "program_span"
        SPANS = [("agc", "wmix_tpu_torch.dsp.agc", "process_pkg", "call")]


        def read(ctx):
            return float(ctx.window_spans["agc"][1])
    """))
    spec["configs"].append(dict(name="record.i8k", source=cfg["source"],
                                file="wbench/configs/record.i8k.json",
                                reduced=[], why="8 kHz integer chain"))
    spec["workloads"].append(dict(name="i8k.short", config="record.i8k",
                                  traffic="conversation.short", chips=1,
                                  why="a test cell"))
    spec["per_layer"].append(dict(name="agc.calls", unit="calls",
                                  better="lower", source="program_span",
                                  layer="AGC", moves="streams",
                                  workloads=["i8k.short"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = _script("""
        import json, time, torch
        from wbench import harness, run
        line, _, _ = run.run_cell(harness.bench_spec(), "i8k.short", 4, 0.3,
                                  True, torch.device("cpu"), time.time())
        print(line)
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["correct"], out
    assert out["metrics"]["agc.calls"]["value"] >= 1
    assert "nsx.ms" not in out["metrics"]      # not listed for the cell
    for p, body in before.items():
        assert (tmp_path / "wbench" / p).read_bytes() == body


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """One short run of the cell through its command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    res = subprocess.run(
        [sys.executable, "-m", "wbench.run", "--workload", cell, "--seed",
         str(SEED), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"
