"""The one launch path of the port's CUDA kernels (`kernels.launch`), on the
CPU with the library faked: what each stage's wrapper passes to its entry
point, the one launch counter, and the arguments refused before anything
is built."""
import collections
from types import SimpleNamespace

import pytest
import torch

from wmix_tpu_torch import kernels
from wmix_tpu_torch.dsp import agc, vad
from wmix_tpu_torch.engine import aec_package

I32, F32 = torch.int32, torch.float32


def _agc():
    st, out = agc._kernel_pkg(agc.init_state(3, "cpu"),
                              torch.zeros((3, 640), dtype=I32), 2, 16000, 5)
    assert type(st) is agc.AgcState and out.shape == (3, 640)


def _vad():
    st, out = vad._kernel_process(vad.init_state(3, "cpu"),
                                  torch.zeros((3, 1280), dtype=I32), 2,
                                  32000, 20)
    assert type(st) is vad.VadState and out.shape == (3, 1280)


def _aec_package():
    state = aec_package.init_package_state(3, "cpu")
    spectra = torch.zeros((3, aec_package.BLOCKS_PER_PKG, 65))
    st, out = aec_package._kernel_step(
        state, torch.zeros((3, 320)), spectra, spectra, spectra, spectra,
        torch.zeros((5, 65), dtype=I32), torch.zeros((5, 3), dtype=I32),
        2, 2)
    assert st is state and out.shape == (3, 320) and out.dtype == F32


# kernel: (its stage's module and the function a benchmark wraps there,
# the wrapper's call, pointers, integer arguments)
CASES = {
    "agc": (agc, "process_pkg", _agc, 18, (3, 320, 2, 160)),
    "vad": (vad, "process", _vad, 18, (3, 640, 2, 32000, 320)),
    "aec_package": (aec_package, "build_chain_aec_body", _aec_package, 31,
                    (3, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_launch_counted_behind_a_wrapper(name, monkeypatch):
    """The kernel's wrapper, with the launch itself faked, passes its
    pointers, its integer arguments, the device index and the stream to
    `wmix_<name>_launch`, and the launch is counted once in the one
    counter, under the kernel and the device, even while a wrapper (a
    benchmark's timing span) replaces the stage's function."""
    module, stage, run, n_ptrs, ints = CASES[name]
    calls = []

    class FakeLib:
        def __getattr__(self, symbol):
            def launch(ptrs, n, *args):
                calls.append((symbol, n, args[:-1], args[-1].value))
                return 0
            return launch
    monkeypatch.setattr(kernels, "load", lambda nm: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(kernels, "launches", collections.Counter())
    orig = getattr(module, stage)
    monkeypatch.setattr(module, stage, lambda *a, **k: orig(*a, **k))
    run()
    assert calls == [(f"wmix_{name}_launch", n_ptrs, (*ints, None), 7)]
    assert kernels.launches == {(name, "cpu"): 1}
    assert kernels.launched(name) == 1


@pytest.mark.parametrize("fault", ["not_contiguous", "two_devices", "shape",
                                   "dtype"])
def test_launch_refuses_before_loading(fault, monkeypatch):
    """A tensor that is not contiguous, on another device than the first,
    or of another shape or dtype than its kernel expects is refused with a
    ValueError naming the kernel and the argument, before the library is
    loaded (and so built), and nothing is counted."""
    def load(name):
        raise AssertionError("loaded")
    monkeypatch.setattr(kernels, "load", load)
    before = dict(kernels.launches)
    bad = {"not_contiguous": torch.zeros((6, 4), dtype=I32).t(),
           "two_devices": torch.zeros((4, 6), dtype=I32, device="meta"),
           "shape": torch.zeros((4, 5), dtype=I32),
           "dtype": torch.zeros((4, 6))}[fault]
    with pytest.raises(ValueError, match="agc kernel: out "):
        kernels.launch("agc", dict(pkg=(torch.zeros((4, 6), dtype=I32),
                                        (4, 6), I32),
                                   out=(bad, (4, 6), I32)), (4,))
    assert dict(kernels.launches) == before
