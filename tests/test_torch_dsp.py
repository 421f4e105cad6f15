"""wmix_tpu_torch NS, AGC and VAD against wmix_tpu, package by package.

The same seeded int16 packages (B = 3 streams x 30 packages of 320 samples
at 16 kHz, amplitudes switching between silence, speech level and near
full scale so the VAD flips and the AGC limiter engages) go through the
vmapped JAX `process_pkg` / `process` and through the port.  AGC and VAD
are integer code: outputs and every state leaf bit-equal.  NS runs in
fast mode (float32, torch.fft vs XLA's FFT): max 4 LSB on the int16
outputs, with the bit-equal share reported.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

B, P, FREQ = 3, 30, 16000


def _packages(seed=11):
    rng = np.random.RandomState(seed)
    amp = rng.choice([0.0, 30.0, 300.0, 3000.0, 12000.0, 30000.0],
                     size=(P, B, 1))
    t = np.arange(320) / FREQ
    tone = np.sin(2 * np.pi * rng.uniform(150, 3000, size=(P, B, 1)) * t)
    x = amp * (0.6 * tone + 0.4 * rng.randn(P, B, 320))
    return np.clip(np.round(x), -32768, 32767).astype(np.int32)


def _assert_state_equal(port_st, jax_st):
    for f in type(port_st)._fields:
        np.testing.assert_array_equal(
            getattr(port_st, f).numpy(), np.asarray(getattr(jax_st, f)),
            err_msg=f)


def _batched(init):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), init)


def _run_jax(step, st):
    fn = jax.jit(jax.vmap(step))
    outs = []
    for p, pkg in enumerate(_packages()):
        st, y = fn(st, jnp.asarray(pkg))
        outs.append(np.asarray(y))
    return st, np.stack(outs)


def _run_port(step, st):
    outs = []
    for pkg in _packages():
        st, y = step(st, torch.from_numpy(pkg))
        outs.append(y.numpy())
    return st, np.stack(outs)


def test_agc_bit_equal():
    from wmix_tpu.dsp import agc as J
    from wmix_tpu_torch.dsp import agc as T
    jst, jout = _run_jax(
        lambda s, x: J.process_pkg(s, x, 1, FREQ, 5), _batched(J.init_state()))
    tst, tout = _run_port(
        lambda s, x: T.process_pkg(s, x, 1, FREQ, 5), T.init_state(B, device="cpu"))
    np.testing.assert_array_equal(tout, jout)
    _assert_state_equal(tst, jst)
    assert np.abs(tout).max() > 20000     # the loud packages reached AGC


def test_vad_bit_equal():
    from wmix_tpu.dsp import vad as J
    from wmix_tpu_torch.dsp import vad as T
    jst, jout = _run_jax(lambda s, x: J.process(s, x, 1, FREQ),
                         _batched(J.init_state()))
    tst, tout = _run_port(lambda s, x: T.process(s, x, 1, FREQ),
                          T.init_state(B, device="cpu"))
    np.testing.assert_array_equal(tout, jout)
    _assert_state_equal(tst, jst)


def test_ns_fast_within_4_lsb(monkeypatch):
    monkeypatch.setenv("WMIX_FAST", "1")
    from wmix_tpu.dsp import ns as J
    from wmix_tpu_torch.dsp import ns as T
    _jst, jout = _run_jax(lambda s, x: J.process_pkg(s, x, 1, FREQ),
                          _batched(J.init_state(FREQ)))
    _tst, tout = _run_port(lambda s, x: T.process_pkg(s, x, 1, FREQ),
                           T.init_state(B, FREQ, device="cpu"))
    d = np.abs(tout.astype(np.int64) - jout.astype(np.int64))
    print(f"NS port vs wmix_tpu (fast): max {d.max()} LSB, bit-equal "
          f"{(d == 0).mean():.4%} of {d.size} samples")
    assert int(d.max()) <= 4, int(d.max())
    assert np.abs(jout).max() > 1000       # NS passed speech through
