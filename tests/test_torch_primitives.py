"""wmix_tpu_torch primitives against their wmix_tpu originals: the
fixed-point helpers (bit-equal), the fast rdft packing, the tables and
host helpers copied into the port (equal), and the port's jax-free import.

Inputs are seeded numpy arrays handed to both packages; the JAX side runs
on the CPU under x64, as conftest sets it up.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

I32_EDGES = np.array([0, 1, -1, 2, -2, 32767, -32768, 32768, -32769, 65535,
                      65536, 0x7FFFFFFF, -0x80000000, 0x7FFFFFFE,
                      -0x7FFFFFFF], np.int64).astype(np.int32)


def _int32_inputs(n=4000, seed=0):
    rng = np.random.RandomState(seed)
    parts = [I32_EDGES,
             rng.randint(-2**31, 2**31, size=n, dtype=np.int64),
             rng.randint(-70000, 70000, size=n),
             rng.randint(-40, 40, size=n)]
    return np.concatenate(parts).astype(np.int32)


def _pairs(seed=1):
    """Seeded (a, b) int32 pairs including every pair of edge values."""
    a = _int32_inputs(seed=seed)
    b = np.roll(_int32_inputs(seed=seed + 1), 7)
    ea, eb = np.meshgrid(I32_EDGES, I32_EDGES)
    return (np.concatenate([a, ea.ravel()]).astype(np.int32),
            np.concatenate([b, eb.ravel()]).astype(np.int32))


def _eq(port_out, jax_out):
    np.testing.assert_array_equal(np.asarray(port_out.numpy(), np.int64),
                                  np.asarray(jax_out, np.int64))


# ------------------------------------------------------------- intops

UNARY = ["wrap16", "norm_w32", "sat_w16", "sqrt_floor"]


@pytest.mark.parametrize("name", UNARY)
def test_intops_unary_bit_equal(name):
    from wmix_tpu.dsp import intops as J
    from wmix_tpu_torch.dsp import intops as T
    x = _int32_inputs()
    _eq(getattr(T, name)(torch.from_numpy(x)), getattr(J, name)(jnp.asarray(x)))


def test_intops_norm_u32_bit_equal():
    from wmix_tpu.dsp import intops as J
    from wmix_tpu_torch.dsp import intops as T
    x = _int32_inputs()
    u = x.view(np.uint32)
    _eq(T.norm_u32(torch.from_numpy(u.astype(np.int64))),
        J.norm_u32(jnp.asarray(u)))


BINARY = ["add_sat_w16", "add_sat_w32", "div_w32_w16"]


@pytest.mark.parametrize("name", BINARY)
def test_intops_binary_bit_equal(name):
    from wmix_tpu.dsp import intops as J
    from wmix_tpu_torch.dsp import intops as T
    a, b = _pairs()
    if name == "add_sat_w16":
        a, b = (np.clip(v, -32768, 32767).astype(np.int32) for v in (a, b))
    _eq(getattr(T, name)(torch.from_numpy(a), torch.from_numpy(b)),
        getattr(J, name)(jnp.asarray(a), jnp.asarray(b)))


def test_intops_div_u32_u16_bit_equal():
    """div_u32_u16 on uint32 values (int64-held in the port)."""
    from wmix_tpu.dsp import intops as J
    from wmix_tpu_torch.dsp import intops as T
    a, b = _pairs(seed=3)
    ua, ub = a.view(np.uint32), b.view(np.uint32)
    _eq(T.div_u32_u16(torch.from_numpy(ua.astype(np.int64)),
                      torch.from_numpy(ub.astype(np.int64))),
        np.asarray(J.div_u32_u16(jnp.asarray(ua), jnp.asarray(ub))))


def test_div_trunc_matches_agc_division():
    """The port's C division against the exact division the AGC calls."""
    from wmix_tpu.dsp.agc import _div_trunc
    from wmix_tpu_torch.dsp import intops as T
    a, b = _pairs(seed=5)
    keep = b != 0
    a, b = a[keep], b[keep]
    _eq(T.div_trunc(torch.from_numpy(a), torch.from_numpy(b)),
        _div_trunc(jnp.asarray(a), jnp.asarray(b)))


def test_cast_out_int16_equal():
    """The AEC output's (int16_t) cast over its clipped range, NaN and the
    fractions either side of zero."""
    from wmix_tpu.engine.aec_step import cast_out_int16 as J
    from wmix_tpu_torch.engine.aec_step import cast_out_int16 as T
    rng = np.random.RandomState(9)
    x = np.concatenate([
        np.array([np.nan, 0.0, -0.0, 0.5, -0.5, 0.999, -0.999, 1.5, -1.5,
                  32767.0, -32768.0, 32766.9, -32767.9], np.float32),
        rng.uniform(-32768, 32767, 4000).astype(np.float32)])
    got = T(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), J(x).astype(np.int32))


# --------------------------------------------------------------- rdft

@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_fast_rdft_matches(n, inverse):
    """torch.fft and XLA's FFT round differently: float32 tolerance."""
    from wmix_tpu.ops.rdft import _fast_rdft
    from wmix_tpu_torch.ops.rdft import fast_rdft
    x = (np.random.RandomState(n).randn(6, n) * 3000).astype(np.float32)
    want = np.asarray(_fast_rdft(jnp.asarray(x), inverse))
    got = fast_rdft(torch.from_numpy(x), inverse).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------- tables and host helpers

def test_zoom_index_equal():
    from wmix_tpu.ops import stepper as J
    from wmix_tpu_torch.ops import stepper as T
    for frames in (160, 320, 640):
        np.testing.assert_array_equal(T.zoom_src_index(16000, 8000, frames),
                                      J.zoom_src_index(16000, 8000, frames))


@pytest.mark.parametrize("gain_db", [0, 3, 5, 9, 15, 30])
def test_gain_table_equal(gain_db):
    from wmix_tpu.dsp.agc import gain_table as J
    from wmix_tpu_torch.dsp.agc import gain_table as T
    np.testing.assert_array_equal(T(gain_db), J(gain_db))


def test_dft_mats_equal():
    from wmix_tpu.engine.aec_pallas import _dft_mats as J
    from wmix_tpu_torch.engine.aec_package import _dft_mats as T
    want, got = J(), T()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [777, 1, 123456789, 0x7FFFFFFF])
def test_rand_u_array_equal(seed):
    from wmix_tpu.dsp.aec import _rand_u_array as J
    from wmix_tpu_torch.dsp.aec import _rand_u_array as T
    got, s1 = T(seed, 64)
    want, s2 = J(seed, 64)
    np.testing.assert_array_equal(got, want)
    assert s1 == s2


def test_copied_curves_and_windows_equal():
    from wmix_tpu.dsp import aec as JA, ns as JN
    from wmix_tpu_torch.dsp import aec as TA, ns as TN
    for f in ("_sqrt_hanning", "_weight_curve", "_overdrive_curve"):
        np.testing.assert_array_equal(getattr(TA, f)(), getattr(JA, f)())
    np.testing.assert_array_equal(TN._window(256), JN._window(256))
    for a, b in zip(TN._startup_log_consts(129), JN._startup_log_consts(129)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------- jax-free import

def test_import_is_jax_free():
    """Every module of the port, imported in a fresh interpreter, brings
    in neither jax nor anything of wmix_tpu."""
    code = ("import importlib, pkgutil, sys, wmix_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "wmix_tpu_torch.__path__, 'wmix_tpu_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "want = ['engine.chain', 'engine.checkpoint', 'engine.mixbus', "
            "'kernels', 'staging', 'config', 'ops.g711', 'ops.mixer', "
            "'service.stream_server', 'service.stream_daemon', "
            "'utils.trace']\n"
            "missing = [w for w in want "
            "if 'wmix_tpu_torch.' + w not in sys.modules]\n"
            "assert not missing, missing\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'wmix_tpu.')) or m == 'wmix_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ------------------------------------------------------- default device

DEVICE_ENTRY_POINTS = [
    ("engine.chain", "RecordChain"),
    ("engine.chain", "state_from_numpy"),
    ("engine.aec_package", "init_package_state"),
    ("engine.aec_package", "init_chain_aec"),
    ("engine.aec_package", "AecBatchPackage"),
    ("engine.aec_step", "init_eng_state"),
    ("engine.aec_step", "AecBatch"),
    ("dsp.ns", "init_state"),
    ("dsp.agc", "init_state"),
    ("dsp.vad", "init_state"),
    ("dsp.aec", "init_dev"),
    ("engine.mixbus", "MixBus"),
    ("staging", "PinnedRing"),
]


@pytest.mark.parametrize("module,name", DEVICE_ENTRY_POINTS,
                         ids=[f"{m}.{n}" for m, n in DEVICE_ENTRY_POINTS])
def test_device_defaults_to_the_card(module, name):
    """Every entry point that takes `device` defaults to None, which means
    the card: the CPU is used only when the caller asks for it."""
    import importlib
    import inspect
    fn = getattr(importlib.import_module(f"wmix_tpu_torch.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default is None


def test_default_device_raises_without_a_card(monkeypatch):
    from wmix_tpu_torch.device import resolve_device
    from wmix_tpu_torch.dsp import agc, vad
    from wmix_tpu_torch.engine.aec_package import AecBatchPackage
    from wmix_tpu_torch.engine.chain import RecordChain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: RecordChain(2, 16000),
                  lambda: RecordChain(2, 16000, device="cuda"),
                  lambda: AecBatchPackage(2, 16000),
                  lambda: agc.init_state(2), lambda: vad.init_state(2),
                  resolve_device):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_cpu_when_asked_for():
    from wmix_tpu_torch.device import resolve_device
    from wmix_tpu_torch.engine.chain import RecordChain
    ch = RecordChain(2, 16000, device="cpu")
    assert ch.device == torch.device("cpu")
    assert ch.state.play_fifo.device.type == "cpu"
    assert ch.state.aec.dev.d_buf.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
