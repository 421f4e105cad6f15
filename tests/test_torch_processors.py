"""The daemon's single-stream record processors in wmix_tpu_torch against
wmix_tpu's, one stream each on the CPU, over a few packages at 8 and
16 kHz, mono and stereo.

* The float and JAX-jitted ones (`service.core._NsProc`, `_AgcProc`,
  `_VadProc`, `dsp.aec.AecProcessor`), in exact mode (WMIX_EXACT=1 on the
  port; wmix_tpu under x64 is exact), bit-equal to the outputs of
  wmix_tpu's processors stored in tests/data/torch_daemon_ref.npz by
  `tools/gen_torch_daemon_ref.py` (a live reference costs an XLA compile
  per processor and geometry and about a second an AEC package); the
  test marked `slow` makes the file again from wmix_tpu and compares.
* The integer ones (`dsp.nsx.NsxProcessor`, `dsp.aecm.AecmProcessor`)
  bit-equal to wmix_tpu's numpy processors, live.

Each port processor runs its module at B = 1 on the device it is given,
on tensors [1, frames * chn] of int16 values.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import gen_torch_daemon_ref as ref  # noqa: E402

CASES = [f"{f}_{c}" for f, c in ref.PROC_CASES]


@pytest.fixture(scope="module")
def stored():
    with np.load(ref.PATH) as z:
        return dict(z)


@pytest.fixture(autouse=True)
def exact_mode(monkeypatch):
    monkeypatch.setenv("WMIX_EXACT", "1")
    monkeypatch.delenv("WMIX_FAST", raising=False)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int16)[None]).to(torch.int32)


def _n(t):
    return t[0].to(torch.int16).numpy()


def _make(name, freq, chn):
    from wmix_tpu_torch.service import core
    return {"ns": lambda: core._NsProc(chn, freq, "cpu"),
            "agc": lambda: core._AgcProc(chn, freq, ref.AGC_GAIN, "cpu"),
            "vad": lambda: core._VadProc(chn, freq, 20, "cpu")}[name]()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["ns", "agc", "vad"])
def test_ns_agc_vad_equal_stored(stored, name, case):
    freq, chn = map(int, case.split("_"))
    mic, _far = ref.proc_inputs(freq, chn)
    p = _make(name, freq, chn)
    got = np.stack([_n(p.process(_t(m))) for m in mic[:ref.N_PROC]])
    np.testing.assert_array_equal(got, stored[f"{name}_{case}"])


@pytest.mark.parametrize("case", CASES)
def test_aec_processor_equal_stored(stored, case):
    from wmix_tpu_torch.dsp.aec import AecProcessor
    freq, chn = map(int, case.split("_"))
    mic, far = ref.proc_inputs(freq, chn)
    p = AecProcessor(chn, freq, 20, device="cpu")
    assert p.aec.exact
    got = np.stack([_n(p.process2(_t(f), _t(m), 0))
                    for f, m in zip(far, mic)])
    want = stored[f"aec_{case}"]
    np.testing.assert_array_equal(got, want)
    # past its start-up the AEC changed the microphone
    assert (got[4:] != mic[4:]).any()


@pytest.mark.parametrize("freq", [f for f, _ in ref.AEC10_CASES])
def test_aec_processor_10ms_packages_equal_stored(stored, freq):
    """10 ms packages: at 8 kHz the wrapper's subpackage is 10 ms, not
    the record chain's 20 (the planner plans the processor's own)."""
    from wmix_tpu_torch.dsp.aec import AecProcessor
    mic, far = ref.proc_inputs(freq, 1, 10)
    p = AecProcessor(1, freq, 10, device="cpu")
    assert p.pkg_frame == freq // 100
    got = np.stack([_n(p.process2(_t(f), _t(m))) for f, m in zip(far, mic)])
    np.testing.assert_array_equal(got, stored[f"aec10_{freq}_1"])


@pytest.mark.parametrize("freq,chn", [(8000, 1), (16000, 2), (32000, 1),
                                      (32000, 2)])
def test_nsx_processor_equal(freq, chn):
    from wmix_tpu.dsp.nsx import NsxProcessor as J
    from wmix_tpu_torch.dsp.nsx import NsxProcessor as T
    rng = np.random.RandomState(freq + chn)
    n = freq // 1000 * 20 * chn
    mic = (rng.randn(5, n) * 4000 + 300).astype(np.int16)
    a, b = J(chn, freq, 2), T(chn, freq, 2, device="cpu")
    for k in range(5):
        np.testing.assert_array_equal(_n(b.process(_t(mic[k]))),
                                      a.process(mic[k]), err_msg=f"pkg {k}")


@pytest.mark.parametrize("freq,chn,interval", [(8000, 1, 20), (8000, 2, 20),
                                               (16000, 1, 20),
                                               (16000, 2, 20),
                                               (8000, 1, 10)])
def test_aecm_processor_equal(freq, chn, interval):
    from wmix_tpu.dsp.aecm import AecmProcessor as J
    from wmix_tpu_torch.dsp.aecm import AecmProcessor as T
    mic, far = ref.proc_inputs(freq, chn, interval)
    a, b = J(chn, freq, interval), T(chn, freq, interval, device="cpu")
    for k in range(ref.N_AEC):
        np.testing.assert_array_equal(
            _n(b.process2(_t(far[k]), _t(mic[k]), 0)),
            a.process2(far[k], mic[k], 0), err_msg=f"pkg {k}")


@pytest.mark.parametrize("module,cls,args", [
    ("dsp.aec", "AecProcessor", (1, 16000)),
    ("dsp.aecm", "AecmProcessor", (1, 16000, 20)),
    ("dsp.nsx", "NsxProcessor", (1, 16000)),
    ("service.core", "_NsProc", (1, 16000)),
    ("service.core", "_AgcProc", (1, 16000, 5)),
    ("service.core", "_VadProc", (1, 16000, 20)),
])
def test_processors_default_to_the_card(module, cls, args):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    make = getattr(importlib.import_module(f"wmix_tpu_torch.{module}"), cls)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(*args)


@pytest.mark.slow
def test_stored_reference_regenerates(stored):
    """tools/gen_torch_daemon_ref.py makes the stored file again from
    wmix_tpu, array for array."""
    fresh = ref.reference_outputs()
    assert sorted(fresh) == sorted(stored)
    for k in fresh:
        np.testing.assert_array_equal(fresh[k], stored[k], err_msg=k)
