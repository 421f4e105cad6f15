"""BENCHMARK.json against the benchmark's contract, and the result line's
keys."""
import json
import os
import re

from wbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "compared"}


def _spec():
    return harness.bench_spec()


def test_top_level_and_entry_keys():
    spec = _spec()
    assert set(spec) == TOP_KEYS
    assert os.path.getsize(harness.BENCHMARK_JSON) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_names_units_and_files():
    spec = _spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"] == f"wbench/configs/{c['name']}.json"
        body = harness.config(c["name"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert w["config"] in configs
        tr = harness.traffic(w["traffic"])
        harness.load_module("drivers", tr["driver"])
        harness.load_module("traffic", tr["generator"])
        mine_e2e, mine_layer = harness.cell_metrics(spec, w["name"])
        assert {"setup_s"} < {m["name"] for m in mine_e2e}
        assert mine_layer
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        mod = harness.load_module("layers", m["name"])
        assert mod.SOURCE == m["source"] and callable(mod.read)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_paths_and_command():
    spec = _spec()
    assert spec["paths"] == ["wbench"]
    assert spec["command"][:3] == ["python3", "-m", "wbench.run"]
    for word in spec["command"]:
        assert not word.startswith("/") and ".." not in word


def test_result_line_has_the_contract_keys():
    line = harness.result_line(
        True, 10, 0, {"streams": (1.5, "streams")},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 1}, {"mismatches": (0, 0)})
    out = json.loads(line)
    assert set(out) == LINE_KEYS
    assert list(out)[-1] == "compared"
    assert out["metrics"]["streams"] == {"value": 1.5, "unit": "streams"}
    traced = json.loads(harness.result_line(
        True, 1, 0, {}, {}, {}, {"device_ops": [], "idle_gaps": []}))
    assert set(traced) == LINE_KEYS | {"breakdown"}
