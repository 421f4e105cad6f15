"""wmix_tpu_torch exact-mode transforms against wmix_tpu's, bit for bit.

`rdft` (Ooura fft4g `WebRtc_rdft`, 128 and 256 points) and `aec_rdft`
(the AEC's 128-point variant with shipped twiddles), forward and inverse,
on seeded int16-ranged and small-float inputs at batch 1 and 3, against
`wmix_tpu.ops.rdft` traced under x64 with WMIX_EXACT=1 (six programs, each
traced once on all six rows; a row's transform does not depend on the
batch it is in).  The host planners
(permutation, twiddle tables) are held equal too, and the `*_traced` entry
points are shown to follow the mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wmix_tpu_torch.ops import rdft as T  # noqa: E402


def _input(n, seed):
    """Six rows: three int16-ranged, three small floats."""
    rng = np.random.RandomState(seed)
    big = np.clip(np.round(rng.randn(3, n) * 12000.0), -32768, 32767)
    return np.concatenate([big, rng.randn(3, n) * 1e-3]).astype(np.float32)


@pytest.fixture(scope="module")
def want():
    """The reference's transforms of `_input`, traced fresh in exact mode
    (one program per transform, direction and size)."""
    from wmix_tpu.ops import rdft as J
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WMIX_EXACT", "1")
        for name, n in (("rdft", 128), ("rdft", 256), ("aec_rdft", 128)):
            x = jnp.asarray(_input(n, n))
            for inverse in (False, True):
                f = jax.jit(lambda v, name=name, inverse=inverse:
                            getattr(J, name + "_traced")(v, inverse))
                out[name, n, inverse] = np.asarray(f(x))
    return out


CASES = [("rdft", 128), ("rdft", 256), ("aec_rdft", 128)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", [slice(0, 1), slice(0, 3), slice(3, 4),
                                  slice(3, 6)],
                         ids=["int16-b1", "int16-b3", "small-b1",
                              "small-b3"])
@pytest.mark.parametrize("name,n", CASES)
def test_rdft_bit_equal(name, n, rows, inverse, want, monkeypatch):
    monkeypatch.setenv("WMIX_EXACT", "1")
    x = torch.from_numpy(_input(n, n)[rows])
    w = want[name, n, inverse][rows]
    np.testing.assert_array_equal(getattr(T, name)(x, inverse).numpy(), w)
    # the traced entry point follows the environment, or its argument
    traced = getattr(T, name + "_traced")
    np.testing.assert_array_equal(traced(x, inverse).numpy(), w)
    monkeypatch.delenv("WMIX_EXACT")
    np.testing.assert_array_equal(traced(x, inverse, exact=True).numpy(), w)


def test_leading_axes_are_batch():
    x = torch.from_numpy(_input(128, 4))
    flat = T.aec_rdft(x)
    assert torch.equal(T.aec_rdft(x.reshape(2, 3, 128)).reshape(6, 128), flat)


def test_aec_variant_differs_from_fft4g_and_from_torch_fft():
    """The shipped AEC twiddles round differently from fft4g's derived
    ones, and both from `torch.fft`: the three are told apart."""
    x = torch.from_numpy(_input(128, 5)[:3])
    assert not torch.equal(T.rdft(x), T.aec_rdft(x))
    assert not torch.equal(T.rdft(x), T.fast_rdft(x))
    torch.testing.assert_close(T.rdft(x), T.fast_rdft(x), rtol=1e-4,
                               atol=0.5)
    # round trip: the inverse is unscaled, callers apply 2/n
    torch.testing.assert_close(T.rdft(T.rdft(x), True) * (2.0 / 128), x,
                               rtol=1e-4, atol=0.05)


def test_traced_mode_switch(monkeypatch):
    x = torch.from_numpy(_input(256, 6)[:2])
    monkeypatch.delenv("WMIX_EXACT", raising=False)
    monkeypatch.delenv("WMIX_FAST_FFT", raising=False)
    assert torch.equal(T.rdft_traced(x), T.fast_rdft(x))
    assert torch.equal(T.rdft_traced(x, exact=True), T.rdft(x))
    monkeypatch.setenv("WMIX_FAST_FFT", "0")      # the reference's switch
    assert torch.equal(T.rdft_traced(x), T.rdft(x))


@pytest.mark.parametrize("n", [128, 256])
def test_host_plans_equal(n):
    from wmix_tpu.ops import rdft as J
    for pj, pt in ((J._plan(n), T._plan(n)),
                   (J._plan_aec128(), T._plan_aec128())):
        np.testing.assert_array_equal(pj["perm"], pt["perm"])
        assert np.float32(pj["w2"]) == np.float32(pt["w2"])
        for k in ("jF", "jR", "kR", "wkr", "wki"):
            np.testing.assert_array_equal(pj[k], pt[k], err_msg=k)
        assert pj["final_radix4"] == pt["final_radix4"]
        assert pj["l_final"] == pt["l_final"]
        assert len(pj["stages"]) == len(pt["stages"])
        for sj, (_l, st, _inv) in zip(pj["stages"], pt["stages"]):
            for a, b in zip(sj, st):
                np.testing.assert_array_equal(a, b)
