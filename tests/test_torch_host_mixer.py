"""The host mixer of wmix_tpu_torch against wmix_tpu's: the stepper's
float32 pacing patterns (through the port's own build of the C helper),
the standalone resampler (`pcm_zoom`, `len_of_out`, `len_of_in`) and
`load_data` (numpy, and `use_device=True` on the CPU), over the
geometries of tests/test_mixer.py and tests/test_resample.py, equal value
for value.  Those tests hold `wmix_tpu` to the C reference; here the
reference is `wmix_tpu`, so no oracle is needed.

`wmix_tpu`'s stepper runs on its pure-Python float32 simulation here
(`reference_stepper_in_python`): its ctypes calls leave the arguments
untyped, and `load_insert_events`' 8th argument, an int64 passed in a
stack slot, then has an undefined upper half, so that call may return no
events at all (seen once in a run of the suite).  The port types every
argument (`test_native_stepper_arguments_typed`).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from wmix_tpu.config import EngineConfig as JCfg  # noqa: E402
from wmix_tpu.ops import mixer as jmixer  # noqa: E402
from wmix_tpu.ops import resample as jres  # noqa: E402
from wmix_tpu.ops import stepper as jstep  # noqa: E402
from wmix_tpu_torch.config import EngineConfig as TCfg  # noqa: E402
from wmix_tpu_torch.ops import mixer as tmixer  # noqa: E402
from wmix_tpu_torch.ops import resample as tres  # noqa: E402
from wmix_tpu_torch.ops import stepper as tstep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = [8000, 16000, 32000, 44100, 22050, 11025, 48000]
GEOMS = [(1, 8000), (1, 16000), (2, 16000), (1, 32000)]


PATTERNS = ("zoom_src_index_cached", "zoom_up_flags", "zoom_down_flags",
            "load_insert_pattern", "load_skip_pattern")


def python_stepper(monkeypatch, mod):
    """Run `mod`'s stepper on its pure-Python simulation, caches cleared
    now and when the test ends."""
    def clear():
        for name in PATTERNS:
            getattr(mod, name).cache_clear()
    clear()
    monkeypatch.setattr(mod, "_lib", lambda: None)
    monkeypatch.setattr(mod, "_native", lambda: None)
    return clear


@pytest.fixture(autouse=True)
def reference_stepper_in_python(monkeypatch):
    clear = python_stepper(monkeypatch, jstep)
    yield
    clear()


def _sig(n, chn, seed=0, amp=32768):
    r = np.random.RandomState(seed)
    return r.randint(-amp, amp, n * chn).astype(np.int16).tobytes()


def test_native_stepper_loaded():
    """The port builds and loads its own copy of the C stepper (the
    pure-Python fallback is there for a box without a compiler)."""
    lib = tstep._lib()
    assert lib is not None
    assert os.path.dirname(lib._name) == os.path.join(
        REPO, "build", "wmix_tpu_torch", "native")


def test_native_stepper_arguments_typed():
    import ctypes as C
    lib = tstep._lib()
    assert lib.load_insert_events.argtypes[7] is C.c_int64
    assert lib.load_insert_events.argtypes[2] is C.c_int64
    for fn in ("zoom_up_indices", "zoom_up_flags", "zoom_down_flags",
               "load_skip_flags"):
        assert getattr(lib, fn).argtypes[:3] == [C.c_int32, C.c_int32,
                                                 C.c_int64], fn


@pytest.mark.parametrize("a", RATES)
@pytest.mark.parametrize("b", RATES)
def test_stepper_patterns_equal(a, b):
    n = 2000
    np.testing.assert_array_equal(tstep.zoom_up_flags(a, b, n),
                                  jstep.zoom_up_flags(a, b, n))
    np.testing.assert_array_equal(tstep.zoom_down_flags(a, b, n),
                                  jstep.zoom_down_flags(a, b, n))
    np.testing.assert_array_equal(tstep.zoom_src_index(a, b, n),
                                  jstep.zoom_src_index(a, b, n))
    if a < b:
        for x, y in zip(tstep.load_insert_pattern(a, b, n),
                        jstep.load_insert_pattern(a, b, n)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    elif a > b:
        np.testing.assert_array_equal(tstep.load_skip_pattern(a, b, n),
                                      jstep.load_skip_pattern(a, b, n))


@pytest.mark.parametrize("in_freq", RATES)
@pytest.mark.parametrize("out_freq", [8000, 16000, 44100])
def test_pcm_zoom_mono_equal(in_freq, out_freq):
    data = _sig(4096, 1)
    assert tres.pcm_zoom(1, in_freq, data, 1, out_freq) == \
        jres.pcm_zoom(1, in_freq, data, 1, out_freq)


@pytest.mark.parametrize("in_chn,out_chn", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("in_freq,out_freq", [(16000, 8000), (8000, 16000),
                                              (44100, 16000), (16000, 16000)])
def test_pcm_zoom_channels_equal(in_chn, out_chn, in_freq, out_freq):
    data = _sig(2048, in_chn)
    assert tres.pcm_zoom(in_chn, in_freq, data, out_chn, out_freq) == \
        jres.pcm_zoom(in_chn, in_freq, data, out_chn, out_freq)


@pytest.mark.parametrize("in_freq", RATES)
def test_len_functions_equal(in_freq):
    for out_freq in RATES:
        for in_chn, out_chn in [(1, 1), (1, 2), (2, 1), (2, 2)]:
            for n in [320, 642, 4096]:
                args = (in_chn, in_freq, n, out_chn, out_freq)
                assert tres.len_of_out(*args) == jres.len_of_out(*args), args
                args = (in_chn, in_freq, out_chn, out_freq, n)
                assert tres.len_of_in(*args) == jres.len_of_in(*args), args


def _load_both(geo_chn, geo_freq, src, freq, chn, *, reduce=0,
               reduce_mode=1, head_off=-1, wmix_head_off=0, wmix_tick=0,
               tick=0, ring_fill=None, use_device=False):
    """wmix_tpu's load_data (numpy) and the port's on rings of the same
    content; returns ((head, tick, ring) of the reference, of the port)."""
    out = []
    for mod, cfg_cls, kw in ((jmixer, JCfg, {}),
                             (tmixer, TCfg, dict(use_device=use_device,
                                                 device="cpu"))):
        cfg = cfg_cls(chn=geo_chn, freq=geo_freq)
        ring = np.zeros((cfg.ring_frames, cfg.chn), np.int16)
        if ring_fill is not None:
            ring[...] = ring_fill.reshape(ring.shape)
        head, t = mod.load_data(cfg, ring, head_off, wmix_head_off,
                                wmix_tick, reduce_mode, src, freq, chn, 16,
                                reduce, tick, **kw)
        out.append((head, t, ring))
    return out


def _assert_same(want, got):
    assert (got[0], got[1]) == (want[0], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("use_device", [False, True])
@pytest.mark.parametrize("geo_chn,geo_freq", GEOMS)
def test_fast_path_equal(geo_chn, geo_freq, use_device):
    _assert_same(*_load_both(geo_chn, geo_freq, _sig(320, geo_chn, 1),
                             geo_freq, geo_chn, use_device=use_device))


@pytest.mark.parametrize("geo_chn,geo_freq", [(1, 16000), (2, 16000)])
@pytest.mark.parametrize("src_freq,src_chn", [
    (8000, 1), (8000, 2), (44100, 1), (44100, 2), (32000, 1), (11025, 1),
    (22050, 2), (48000, 1)])
def test_rate_conversion_equal(geo_chn, geo_freq, src_freq, src_chn):
    _assert_same(*_load_both(geo_chn, geo_freq, _sig(1024, src_chn, 2),
                             src_freq, src_chn))


def test_reduce_modes_equal():
    src = _sig(640, 1, 3)
    for reduce_mode in [1, 2, 4, 15]:
        for reduce in [0, 1, 2, 4]:
            _assert_same(*_load_both(1, 8000, src, 8000, 1, reduce=reduce,
                                     reduce_mode=reduce_mode))


@pytest.mark.parametrize("use_device", [False, True])
def test_saturation_overlay_and_wrap_equal(use_device):
    """A stream mixed onto existing ring content saturates; a head near
    the ring's end wraps; a stale tick repositions the head; a load of
    2.5 s wraps a 1 s ring twice."""
    fill = np.frombuffer(_sig(8000, 1, 4), np.int16)
    _assert_same(*_load_both(1, 8000, _sig(2000, 1, 5), 8000, 1,
                             ring_fill=fill, head_off=200, tick=200,
                             use_device=use_device))
    head = (8000 - 500) * 2
    _assert_same(*_load_both(1, 8000, _sig(3000, 1, 6), 8000, 1,
                             head_off=head, tick=head,
                             use_device=use_device))
    _assert_same(*_load_both(1, 8000, _sig(320, 1, 7), 8000, 1,
                             head_off=64, wmix_head_off=5000,
                             wmix_tick=90000, tick=100,
                             use_device=use_device))
    _assert_same(*_load_both(1, 8000, _sig(20000, 1, 9), 8000, 1,
                             use_device=use_device))


def test_device_mix_through_rate_conversion_equal():
    """use_device=True through the insert path (8 kHz into 16 kHz)."""
    _assert_same(*_load_both(1, 16000, _sig(1024, 1, 8), 8000, 1,
                             use_device=True))


def test_use_device_defaults_to_the_card():
    """With use_device=True and no device, the card is asked for: where
    there is none, that raises rather than mixing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TCfg(chn=1, freq=8000)
    ring = np.zeros((cfg.ring_frames, 1), np.int16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmixer.load_data(cfg, ring, -1, 0, 0, 1, _sig(320, 1), 8000, 1,
                         use_device=True)
