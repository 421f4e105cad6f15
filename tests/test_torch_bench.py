"""The port's measuring entry points on the CPU: `wmix_tpu_torch.bench`
(bench.py's chain ladder), `graft_entry` (`__graft_entry__.entry()`),
`realtime_bench`, `mix_bench` and `codec_bench`.

* bench: `run_point` at B = 2, K = 3, one timed chunk returns bench.py's
  fields, and its chain outputs equal, bit for bit, those of a
  `RecordChain(2, device="cpu")` driven by hand the same way (three
  planner ticks, two warm chunks, one timed); the worker streams its
  events with the stage isolation after the headline point; the parent's
  line is bench.py's, degraded when no point came out; the command line
  prints exactly one JSON line, and without a card exits non-zero and
  prints none.
* graft_entry: its package against `__graft_entry__`'s body run by
  `wmix_tpu` on the CPU in fast mode, WMIX_FAST=1 WMIX_PALLAS=0 (the
  plain-JAX fast path that the port's fast AEC is held to), stored in
  tests/data/torch_graft_entry_fast.npz by `python
  tools/gen_torch_graft_ref.py` (JAX reads its mode when it traces and
  keeps its first trace, so the reference is made in a process of its
  own; the test marked `slow` does it again): `entry()` itself (three
  planner ticks, the priming package) and `entry()`'s package one tick
  later (the port's `entry()`, the kernel's first package).  Gate: origin
  and 8 kHz package within 4 LSB, VAD flags equal
  (tests/test_aec_pallas.py:90's tolerance).
* realtime_bench, mix_bench, codec_bench at B = 2 return their fields;
  every tick is delivered; the mix bench's drained packages equal
  `wmix_tpu`'s MixBus over the same waves and ticks.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tools import gen_torch_graft_ref as graft_gen  # noqa: E402
from wmix_tpu_torch import bench  # noqa: E402

REPO = graft_gen.REPO
LSB = 4
POINT_KEYS = {"batch", "streams", "chunk_ms", "budget_ms",
              "plan_ms_per_chunk"}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "backend",
             "device", "ladder", "stages_chunk_ms", "wall_s"}


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


# ------------------------------------------------------------------ bench

def test_point_equals_a_chain_driven_by_hand():
    from wmix_tpu_torch.engine.aec_package import PackageAecState
    from wmix_tpu_torch.engine.chain import RecordChain
    point, outs, launches = bench.run_point(bench.FULL, 2, 3, 1, "cpu")
    assert set(point) == POINT_KEYS
    assert point["batch"] == 2 and point["budget_ms"] == 60
    assert point["chunk_ms"] > 0 and point["streams"] >= 0
    assert launches == 0          # the plain version runs on the CPU

    rng = np.random.RandomState(0)
    mic = torch.from_numpy((rng.randn(3, 2, 320) * 3000).astype(np.int16))
    play = torch.from_numpy((rng.randn(3, 2, 320) * 5000).astype(np.int16))
    ch = RecordChain(2, 16000, device="cpu")
    for _ in range(3):
        ch._plan_tick()
    for _ in range(3):
        want = ch.run_chunk(mic, play)
    # the start-up packages never ran, and the state still took the kernel
    # layout at the first steady package
    assert isinstance(ch.state.aec, PackageAecState)
    for got, w in zip(outs, want):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), w.numpy())
    assert bool(want[0].abs().any())
    assert set(bench.measure(bench.STAGES["ns"], 2, 3, 1, "cpu")) == \
        POINT_KEYS - {"plan_ms_per_chunk"}


def test_worker_streams_points_and_stages(capsys):
    bench._worker([2, 4], 3, 1, True, time.time() + 600, "cpu")
    events = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [e["event"] for e in events] == \
        ["backend", "point", "stages", "point"]
    assert events[0] == {"event": "backend", "backend": "cpu",
                         "device": "cpu"}
    assert [e["batch"] for e in events if e["event"] == "point"] == [2, 4]
    stages = events[2]["stages_ms"]
    assert set(stages) == {"full", "host_plan", "ns", "aec", "agc_vad"}
    assert all(isinstance(v, float) and v > 0 for v in stages.values())

    line = bench.result_line(events, [2, 4, 8], 12.34)
    assert set(line) == LINE_KEYS
    best = max((e for e in events if e["event"] == "point"),
               key=lambda e: e["streams"])
    assert line["value"] == best["streams"] and \
        line["batch"] == best["batch"]
    assert line["vs_baseline"] == round(best["streams"] / 4096, 4)
    assert line["ladder"][-1] == {"batch": 8, "error": "budget"}
    assert line["stages_chunk_ms"] == stages and line["wall_s"] == 12.3


def test_degraded_line_without_a_point():
    line = bench.result_line([{"event": "point", "batch": 4096,
                               "error": "out of memory"}], [4096, 8192], 1)
    assert line["value"] == 0.0 and line["degraded"] is True
    assert line["ladder"] == [{"batch": 4096, "error": "out of memory"},
                              {"batch": 8192, "error": "budget"}]
    assert "batch" not in line


def test_cli_prints_one_json_line():
    res = subprocess.run(
        [sys.executable, "-m", "wmix_tpu_torch.bench", "--device", "cpu",
         "--batch", "2", "--k", "3", "--chunks", "1", "--no-stages"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line["metric"] == "concurrent_16k_ns_aec_agc_vad_streams_per_chip"
    assert line["unit"] == "streams" and line["backend"] == "cpu"
    assert line["device"] == "cpu" and line["batch"] == 2
    assert [set(p) for p in line["ladder"]] == [POINT_KEYS]
    assert line["value"] == line["ladder"][0]["streams"]
    assert line["ladder"][0]["chunk_ms"] > 0
    assert line["stages_chunk_ms"] == {}


def test_cli_without_a_card_fails_and_prints_nothing():
    """With no CUDA device visible, the worker raises, the parent exits
    non-zero with no line, and neither imports jax; the parent no torch."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['bench', '--batch', '2', "
         "'--k', '3', '--chunks', '1', '--no-stages']\n"
         "try:\n"
         "    runpy.run_module('wmix_tpu_torch.bench', run_name='__main__')\n"
         "finally:\n"
         "    assert 'torch' not in sys.modules and 'jax' not in "
         "sys.modules, sorted(sys.modules)\n"],
        cwd=REPO, env=dict(_env(), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr
    assert "AssertionError" not in res.stderr, res.stderr


# ------------------------------------------------------------ graft_entry

@pytest.fixture(scope="module")
def graft_ref():
    return graft_gen.load()


@pytest.mark.parametrize("ticks", [3, 4])
def test_graft_entry_within_4_lsb_of_wmix_tpu(graft_ref, ticks,
                                              monkeypatch):
    from wmix_tpu_torch import graft_entry
    from wmix_tpu_torch.engine import aec_package
    calls = []
    step = aec_package.package_step

    def counted(*a, **kw):
        calls.append(1)
        return step(*a, **kw)
    monkeypatch.setattr(aec_package, "package_step", counted)
    fn, args = graft_entry.entry(device="cpu") if ticks == 4 else \
        graft_entry._build(8, ticks=ticks, device="cpu")
    mic = args[1]
    assert mic.shape == (8, 320) and mic.dtype == torch.int16
    _state, origin, pkg8k, vflags = fn(*args)
    # entry()'s package is the kernel's; the reference's priming one is not
    assert len(calls) == (1 if ticks == 4 else 0)
    assert isinstance(_state.aec, aec_package.PackageAecState) == \
        (ticks == 4)
    for got, name in ((origin, "origin"), (pkg8k, "pkg8k")):
        want = graft_ref[f"{name}{ticks}"]
        assert got.dtype == torch.int16 and got.shape == want.shape
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert int(d.max()) <= LSB, (name, int(d.max()))
    np.testing.assert_array_equal(vflags.numpy(), graft_ref[f"vflags{ticks}"])
    assert np.abs(graft_ref[f"origin{ticks}"]).max() > 100


def test_graft_entry_mirrors_the_root_file():
    from wmix_tpu_torch import graft_entry, multichip
    assert graft_entry.dryrun_multichip is multichip.dryrun_multichip


@pytest.mark.slow
def test_stored_graft_reference_is_what_wmix_tpu_gives(tmp_path):
    out = tmp_path / "fresh.npz"
    code = ("import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
            "from tools import gen_torch_graft_ref as g; "
            "np.savez(sys.argv[2], **g.reference_run())")
    subprocess.run([sys.executable, "-c", code, REPO, str(out)],
                   check=True, env=_env(), timeout=900)
    with np.load(graft_gen.PATH) as z, np.load(out) as f:
        assert sorted(z.files) == sorted(f.files)
        for k in z.files:
            np.testing.assert_array_equal(z[k], f[k], err_msg=k)


# ------------------------------------------- realtime, mix and codec benches

@pytest.mark.parametrize("drain", ["thread", "inline"])
def test_realtime_bench_ticks(drain):
    import threading
    from wmix_tpu_torch import realtime_bench
    got = realtime_bench.bench_ticks(2, 10, 4, 4, drain, device="cpu")
    assert set(got) == {
        "batch", "depth", "n", "budget_ms", "pump_p50_ms", "pump_p95_ms",
        "pump_max_ms", "overruns", "delivered", "output_latency_p50_ms",
        "output_latency_p95_ms", "output_latency_max_ms", "warmup_ticks",
        "warmup_s"}
    assert got["delivered"] == got["n"] == 10
    assert got["budget_ms"] == 20.0 and got["depth"] == 4
    assert 0 < got["pump_p50_ms"] <= got["pump_p95_ms"] <= \
        got["pump_max_ms"]
    assert got["output_latency_p50_ms"] > 0
    assert not [t for t in threading.enumerate() if t.name == "wmix-drain"]


def test_realtime_percentile_rule():
    from wmix_tpu_torch.realtime_bench import pct
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert (pct(v, 0.5), pct(v, 0.95), pct([7.0], 0.95)) == (3.0, 5.0, 7.0)


def test_mix_bench_drains_what_wmix_tpu_drains():
    from wmix_tpu.config import EngineConfig as JCfg
    from wmix_tpu.engine.mixbus import MixBus as JBus
    from wmix_tpu_torch import mix_bench
    batch, sources, ticks, warmup, depth = 2, 4, 10, 4, 3
    drained = []
    got = mix_bench.bench(batch, sources, ticks, warmup, depth,
                          device="cpu", drained=drained)
    assert set(got) == {"batch", "depth", "sources", "ticks", "wall_s",
                        "tick_ms", "mixed_streams", "engines_realtime"}
    assert got["ticks"] == ticks and got["tick_ms"] > 0
    assert len(drained) == warmup + ticks

    # mix_bench.py's waves and ticks through wmix_tpu's bus
    cfg = JCfg(chn=1, freq=16000)
    bus = JBus(batch, cfg)
    rng = np.random.RandomState(0)
    pkg = cfg.frame_num
    waves = rng.randint(-8000, 8000,
                        (sources, batch, pkg, cfg.chn)).astype(np.int16)
    lens = np.full((sources, batch), pkg, np.int32)
    rdces = np.broadcast_to(1 + (np.arange(batch, dtype=np.int32) % 3),
                            (sources, batch))
    heads = np.zeros(batch, np.int64)
    for i, pcm in enumerate(drained):
        base = (i * pkg) % cfg.ring_frames
        bus.mix_waves(np.broadcast_to((heads + base) % cfg.ring_frames,
                                      (sources, batch)), waves, lens, rdces)
        want = np.asarray(bus.drain_async(1))
        assert pcm.shape == want.shape == (batch, pkg, 1)
        np.testing.assert_array_equal(pcm, want, err_msg=f"tick {i}")
    assert np.abs(drained[-1]).max() > 0
    with pytest.raises(ValueError, match="depth"):
        mix_bench.bench(batch, sources, 1, depth=9, device="cpu")


def test_codec_bench_fields_at_b2():
    from wmix_tpu_torch import codec_bench as cb
    fields = {"batch", "frames", "wall_s", "streams"}
    for fn, files in ((cb.bench_synth, None), (cb.bench_e2e, cb.MP3_FIXTURE),
                      (cb.bench_aac_fb, None),
                      (cb.bench_aac_e2e, cb.AAC_FIXTURE)):
        got = fn(2, 3, device="cpu")
        assert set(got) == fields | ({"file"} if files else set()), fn
        assert got["batch"] == 2 and got["frames"] == 3 and \
            got["wall_s"] >= 0 and got["streams"] >= 0, fn
        if files:
            assert got["file"] == files


def test_codec_bench_quick_cli(tmp_path):
    from wmix_tpu_torch import codec_bench as cb
    out = tmp_path / "codec.json"
    assert cb.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["backend"] == "cpu" and doc["device"] == "cpu"
    sb, sf, eb, ef = cb.QUICK
    assert doc["mp3"]["synth_device"]["batch"] == sb
    assert doc["mp3"]["synth_device"]["frames"] == sf
    # the stored streams end before a quick run's ticks do: 80 Layer III
    # frames (8 warm), 61 AAC ticks (30 warm)
    assert doc["mp3"]["e2e_host_plus_device"]["frames"] == ef
    assert doc["aac"]["e2e_host_plus_device"]["frames"] == 31
    assert doc["aac"]["filterbank_device"]["batch"] == sb
    assert doc["aac"]["e2e_host_plus_device"]["batch"] == eb
