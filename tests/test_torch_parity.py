"""wmix_tpu_torch.parity: the copies of parity.py's scene and statistics
code, the stored reference of tools/gen_torch_parity_ref.py, and the port
on the CPU against `wmix_tpu`'s stored digests.

The reference's own side is the repo's `parity.py`, whose scene and
statistics functions are numpy only; `wmix_tpu` itself is not run here
(the stored file holds its outputs' digests)."""
import json
import os

import numpy as np
import pytest
import torch

import parity as ref_parity
from wmix_tpu_torch import parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCENES = 8


@pytest.fixture(scope="module")
def ref():
    with open(tp.REF_PATH) as f:
        return json.load(f)


# ------------------------------------------------------------- the copies

@pytest.mark.parametrize("kind", ["echo", "fartalk", "noecho", "silence"])
@pytest.mark.parametrize("seed,gain", [(0, 0.3), (5, 0.7), (42, 0.9)])
def test_make_scene_equals_parity_py(kind, seed, gain):
    for n in (1000, 16000):
        want = ref_parity.make_scene(n, 16000, kind, seed, gain)
        got = tp.make_scene(n, 16000, kind, seed, gain)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int16
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tp.make_scene(100, 16000, "music", 0, 0.5)


def test_build_streams_equals_parity_py():
    want = ref_parity.build_streams(20, 3200, 16000)
    got = tp.build_streams(20, 3200, 16000)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_scenes_are_prefix_stable():
    """A scene's first second does not depend on its length, which is what
    lets a shorter run compare its first second with a stored one."""
    long_ = tp.build_streams(4, 5 * 16000, 16000)
    short = tp.build_streams(4, 16000, 16000)
    for a, b in zip(long_[:2], short[:2]):
        np.testing.assert_array_equal(a[:, :16000], b)


def _stat_cases():
    rng = np.random.RandomState(7)
    w = (rng.randn(6, 5000) * 3000).astype(np.int16)
    noisy = np.clip(w + rng.randint(-3, 4, w.shape), -32768, 32767)
    outlier = w.copy()
    outlier[3, 4321] += 1234
    return {"noisy": (noisy.astype(np.int16), w), "all_equal": (w, w),
            "one_outlier": (outlier, w),
            "silent": (np.zeros_like(w), np.zeros_like(w))}


@pytest.mark.parametrize("case", ["noisy", "all_equal", "one_outlier",
                                  "silent"])
def test_error_stats_equals_parity_py(case):
    got, want = _stat_cases()[case]
    assert tp.error_stats(got, want, 16000) == \
        ref_parity.error_stats(got, want, 16000)


def test_flag_sets_equal_parity_py():
    assert tp.FULL == ref_parity.FULL
    assert tp.STAGES == ref_parity.STAGES
    assert set(tp.CONFIGS) == {"full_chain", "int_chain_nsx_aecm",
                               "full_chain_exact", *ref_parity.STAGES}


# ------------------------------------------------------- digests and flags

def test_digest_windows_and_mismatches():
    out = np.arange(4 * 32000, dtype=np.int64).reshape(4, 32000) \
        .astype(np.int16)
    d = tp.digest(out)
    assert len(d) == 4 and all(len(row) == 11 for row in d)
    assert all(len(h) == 16 for row in d for h in row)
    bumped = out.copy()
    bumped[2, 3200 * 5 + 5] += 1     # window 5 of 10, past the first second
    d2 = tp.digest(bumped)
    assert tp.digest_mismatches(d2, d, windows=True) == [[2, 5]]
    assert tp.digest_mismatches(d2, d, windows=False) == []
    bumped[1, 7] += 1
    assert tp.digest_mismatches(tp.digest(bumped), d, windows=True) == \
        [[1, "first_second"], [1, 0], [2, 5]]


def test_flags_round_trip_and_diffs():
    rng = np.random.RandomState(3)
    flags = rng.randint(0, 5, (5, 77)).astype(np.int32)
    back = tp.unpack_flags(tp.pack_flags(flags), 5, 77)
    assert back.dtype == np.int32
    np.testing.assert_array_equal(back, flags)
    other = flags.copy()
    other[1, 10:13] = (other[1, 10:13] + 1) % 5
    other[4, 76] = (other[4, 76] + 1) % 5
    d = tp.vad_flag_diffs(other, flags)
    assert d["differing_packages"] == 4 and d["episodes"] == 2
    assert d["per_stream"] == [0, 3, 0, 0, 1]
    assert d["streams_with_any"] == 2
    hours = 5 * 77 * 0.02 / 3600
    assert d["differing_per_stream_hour"] == round(4 / hours, 3)


# ------------------------------------------------------- the stored file

def test_stored_scenes_equal_parity_r05(ref):
    with open(os.path.join(REPO, "PARITY_r05.json")) as f:
        r05 = json.load(f)
    assert ref["scenes"] == r05["scenes"]
    assert ref["scenes"] == tp.build_streams(64, 1, 16000)[2]
    assert set(ref["configs"]) == set(tp.CONFIGS)
    for nm, e in ref["configs"].items():
        key = "wmix_tpu_digest" if tp.CONFIGS[nm][4] else "port_cpu_digest"
        assert len(e[key]) == 64 and all(len(r) == 11 for r in e[key])
    assert os.path.getsize(tp.REF_PATH) < 200_000


@pytest.mark.parametrize("name", tp.ZERO_LSB)
def test_port_cpu_equals_wmix_tpu_first_second(ref, name):
    """The port on the CPU over the first second of the first 8 scenes
    reproduces `wmix_tpu`'s stored first-second digests.  These
    configurations are batch-independent (exact mode folds in a fixed
    order; the rest is integer arithmetic), so 8 streams give what the
    same 8 streams of the stored 64-stream run gave."""
    plays, mics, _ = tp.build_streams(N_SCENES, 16000, 16000)
    got, vflags = tp.config_outputs(name, plays, mics, device="cpu")
    assert got.dtype == np.int16 and got.shape == (N_SCENES, 16000)
    assert vflags.shape == (N_SCENES, 50)
    want = ref["configs"][name]["wmix_tpu_digest"][:N_SCENES]
    assert tp.digest_mismatches(tp.digest(got), want, windows=False) == []
    assert got.any()


# ---------------------------------------- a fault the card half found

def _sqrt_inputs():
    rng = np.random.RandomState(5)
    x = (10.0 ** rng.uniform(-45, 38.5, 1 << 20)).astype(np.float32)
    squares = np.arange(0, 70000, dtype=np.float32) ** 2
    edge = np.array([1e-45, 1.1754942e-38, 3.4028235e38, np.inf,
                     67574.4453125], np.float32)
    return np.concatenate([x, squares, edge])


def test_fsqrtf_is_correctly_rounded():
    """`floatops.fsqrtf` is C's sqrtf: correctly rounded in float32, as
    numpy's float32 sqrt is.  torch's float32 `sqrt` is not on a large CPU
    tensor (about 1 % of these inputs an ulp off), which moved the port's
    exact chain off `wmix_tpu`'s on 31 of the 64 parity scenes at B = 64
    (from package 22 on), while the chain tests at B = 2 stayed on the
    short-tensor path that is exact."""
    from wmix_tpu_torch.dsp.floatops import fsqrtf
    x = _sqrt_inputs()
    np.testing.assert_array_equal(fsqrtf(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's own rounding")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fsqrtf_on_the_card_equals_the_cpu(cuda_device):
    from wmix_tpu_torch.dsp.floatops import fsqrtf
    x = torch.from_numpy(_sqrt_inputs())
    assert torch.equal(fsqrtf(x.to(cuda_device)).cpu(), fsqrtf(x))


# ------------------------------------------------------------------ CLI

PARITY_PY_KEYS = {"metric", "freq", "backend", "fast_mode", "pallas",
                  "batch", "seconds", "complete", "expected_configs",
                  "configs", "scenes"}


def test_cli_quick_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "parity.json"
    rc = tp.main(["--device", "cpu", "--quick", "--configs",
                  "vad_only,full_chain", "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert PARITY_PY_KEYS <= set(doc)
    assert doc["backend"] == "cpu" and doc["complete"]
    assert doc["batch"] == 8 and doc["seconds"] == 1
    assert doc["scenes"] == tp.build_streams(8, 1, 16000)[2]
    assert doc["reduced"]
    vad = doc["configs"]["vad_only"]
    assert vad["vs_wmix_tpu"] == {"equal": True, "mismatches": 0,
                                  "first_mismatches": []}
    assert not vad["windows_compared"]
    fc = doc["configs"]["full_chain"]
    assert fc["vs_port_cpu"]["max_lsb"] == 0
    # reported, not gated: torch's CPU kernels may differ by ISA
    assert isinstance(fc["port_cpu_reproduces_stored_cpu_digests"]["equal"],
                      bool)
    assert fc["vad_vs_wmix_tpu"]["packages"] == 8 * 50
    assert fc["vad_vs_port_cpu"]["differing_packages"] == 0
    assert "cpu_half_port_cpu_vs_wmix_tpu" in fc
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "out"] == str(out)


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.main(["--quick", "--out", str(tmp_path / "x.json")])
    with pytest.raises(ValueError, match="stored for"):
        tp.run(["agc_only"], seconds=3600, device="cpu")
