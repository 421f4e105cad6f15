"""wmix_tpu_torch floatops: the mode switch and the sequential folds.

`seq_sum` / `seq_sum_multi` in exact mode are held bit-equal to
`wmix_tpu.dsp.floatops` under x64 with WMIX_EXACT=1 (a `lax.scan` left
fold) on seeded float32 terms of the lengths the NS and AEC use; the fold
is also held against a numpy float32 loop, and shown to differ from
`torch.sum` on the same terms (else the test could not tell them apart).
`cdiv` is held against numpy's correctly rounded float32 division, next to
the `c / tensor` form it replaces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wmix_tpu_torch.dsp import floatops as T  # noqa: E402


def _terms(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 10.0 ** rng.uniform(-3, 6, size=shape)
            ).astype(np.float32)


def test_fast_mode_reads_the_environment(monkeypatch):
    monkeypatch.delenv("WMIX_EXACT", raising=False)
    monkeypatch.delenv("WMIX_FAST", raising=False)
    assert T.fast_mode() and not T.is_exact()      # the port's default
    monkeypatch.setenv("WMIX_EXACT", "0")
    assert T.fast_mode()
    monkeypatch.setenv("WMIX_EXACT", "1")
    assert not T.fast_mode() and T.is_exact()
    monkeypatch.setenv("WMIX_FAST", "1")           # EXACT wins, as in JAX
    assert not T.fast_mode()
    assert T.is_exact(False) is False and T.is_exact(True) is True


def test_exact_env_no_longer_raises(monkeypatch):
    monkeypatch.setenv("WMIX_EXACT", "1")
    from wmix_tpu_torch.engine.chain import RecordChain
    ch = RecordChain(1, 16000, device="cpu")
    assert ch.fast is False


@pytest.mark.parametrize("shape,axis", [((3, 129), -1), ((3, 65), -1),
                                        ((2, 12, 65), 1), ((1, 1000), -1)])
def test_seq_sum_bit_equal(shape, axis, monkeypatch):
    monkeypatch.setenv("WMIX_EXACT", "1")
    from wmix_tpu.dsp import floatops as J
    x = _terms(shape, 3)
    want = np.asarray(jax.jit(lambda v: J.seq_sum(v, axis))(jnp.asarray(x)))
    got = T.seq_sum(torch.from_numpy(x), axis).numpy()
    np.testing.assert_array_equal(got, want)
    # and it is the C loop
    acc = np.zeros_like(np.take(x, 0, axis))
    for i in range(x.shape[axis]):
        acc = (acc + np.take(x, i, axis)).astype(np.float32)
    np.testing.assert_array_equal(got, acc)
    assert got.dtype == np.float32


def test_seq_sum_differs_from_torch_sum_and_fast_mode_is_torch_sum():
    x = torch.from_numpy(_terms((4, 1000), 5))
    fold = T.seq_sum(x, exact=True)
    assert not torch.equal(fold, x.sum(dim=-1))
    assert torch.equal(T.seq_sum(x, exact=False), x.sum(dim=-1))


def test_seq_sum_multi_bit_equal(monkeypatch):
    monkeypatch.setenv("WMIX_EXACT", "1")
    from wmix_tpu.dsp import floatops as J
    a, b, c = (_terms((3, 129), s) for s in (7, 8, 9))
    want = jax.jit(lambda *t: J.seq_sum_multi(*t))(*map(jnp.asarray, (a, b, c)))
    got = T.seq_sum_multi(*(torch.from_numpy(v) for v in (a, b, c)))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cdiv_is_one_rounding():
    x = torch.from_numpy(np.abs(_terms((4096,), 11)) + np.float32(1e-3))
    for c in (1.0, 40.0, float(np.float32(-18.4))):
        want = (np.float32(c) / x.numpy()).astype(np.float32)
        np.testing.assert_array_equal(T.cdiv(c, x).numpy(), want)
    # the form it replaces is reciprocal-then-multiply: two roundings
    assert not np.array_equal((40.0 / x).numpy(),
                              (np.float32(40.0) / x.numpy()))


def test_double_rounded_transcendentals_match_wmix_tpu(monkeypatch):
    """(float)f((double)x) for log, exp, tanh, pow: the port's float64
    torch ops against XLA:CPU's under x64, on the ranges the NS and AEC
    feed them."""
    monkeypatch.setenv("WMIX_EXACT", "1")
    from wmix_tpu.dsp import floatops as J
    rng = np.random.RandomState(2)
    pos = (10.0 ** rng.uniform(-6, 9, size=20000)).astype(np.float32)
    sym = (rng.randn(20000) * 8).astype(np.float32)
    # results stay in the normal float32 range: XLA:CPU flushes denormal
    # results to zero, the port (like the C reference) keeps them
    unit = rng.uniform(0.05, 1, size=20000).astype(np.float32)
    expo = rng.uniform(1, 12, size=20000).astype(np.float32)
    for name, args in (("flog", (pos,)), ("fexp", (sym,)),
                       ("ftanh", (sym,)), ("fsqrt_d", (pos,)),
                       ("fcosf", (sym,)), ("fsinf", (sym,)),
                       ("fpowf", (unit, expo)),
                       ("fpow_div", (pos, pos[::-1].copy(), unit))):
        want = np.asarray(jax.jit(getattr(J, name))(*map(jnp.asarray, args)))
        got = getattr(T, name)(*(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_aec_rdft_tables_are_a_true_copy():
    from wmix_tpu.ops import _aec_rdft_tables as J
    from wmix_tpu_torch.ops import _aec_rdft_tables as P
    for name in ("RDFT_W", "WK3_FIRST", "WK3_SECOND"):
        a, b = getattr(J, name), getattr(P, name)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
