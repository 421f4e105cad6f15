"""wmix_tpu_torch NS at 8, 16 and 32 kHz, mono and stereo, against
wmix_tpu, in both arithmetic modes.

The same seeded packages (B = 2 streams x 7 packages of 20 ms, one of
them silent so the zero-input path runs) go through `wmix_tpu.dsp.ns
.process_pkg` and the port's.  Exact mode (WMIX_EXACT=1 on both sides,
x64 on the JAX side): the int16 outputs and every state leaf are
bit-equal.  Fast mode (WMIX_FAST=1; torch.fft against XLA's FFT, released
summation order): outputs within 1 LSB.  A stereo package's right channel
goes through as a high band; at 32 kHz only the first 160 samples of each
320-sample subpackage are processed and the rest of the output is zero.

The JAX wrapper runs op by op around its two cores (`analyze`,
`process`), which are jitted once per mode, rate and band count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

B, P = 2, 7
WINDOW_ENDS = (5, 9)
GEOMETRIES = [(f, c) for f in (8000, 16000, 32000) for c in (1, 2)]


def packages(freq, chn):
    """[P, B, 20 ms * chn] int32 holding int16 values, interleaved."""
    rng = np.random.RandomState(5 + freq // 1000 + chn)
    n = freq // 1000 * 20
    amp = rng.choice([300.0, 3000.0, 12000.0], size=(P, B, 1, 1))
    amp[2] = 0.0
    t = np.arange(n)[:, None] / freq
    tone = np.sin(2 * np.pi * rng.uniform(150, 3000, size=(P, B, 1, chn)) * t)
    x = amp * (0.5 * tone + 0.5 * rng.randn(P, B, n, chn))
    return np.clip(np.round(x), -32768, 32767).astype(np.int32).reshape(
        P, B, n * chn)


@pytest.fixture(scope="module", params=["exact", "fast"])
def mode(request):
    """Sets the mode on both sides and jits the reference's cores in it
    (fresh jit objects, so no trace of the other mode is reused)."""
    from wmix_tpu.dsp import ns
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WMIX_EXACT", "1" if request.param == "exact" else "0")
        mp.setenv("WMIX_FAST", "0" if request.param == "exact" else "1")
        mp.setattr(ns, "analyze", jax.jit(ns.analyze, static_argnums=2))
        mp.setattr(ns, "process", jax.jit(ns.process, static_argnums=2))
        yield request.param


@pytest.mark.parametrize("freq,chn", GEOMETRIES)
def test_ns_process_pkg(freq, chn, mode):
    from wmix_tpu.dsp import ns as J
    from wmix_tpu_torch.dsp import ns as T
    pkgs = packages(freq, chn)
    # the feature window (500 blocks) brought forward to the 5th and 9th
    # block of streams 0 and 1, so that the histogram extraction runs
    jsts = [J.init_state(freq)._replace(update_countdown=jnp.int32(c))
            for c in WINDOW_ENDS]
    tst = T.init_state(B, freq, device="cpu")
    tst = tst._replace(update_countdown=torch.tensor(WINDOW_ENDS,
                                                     dtype=torch.int32))
    worst = 0
    for pkg in pkgs:
        want = []
        for b in range(B):
            jsts[b], y = J.process_pkg(jsts[b], jnp.asarray(pkg[b]), chn, freq)
            want.append(np.asarray(y))
        want = np.stack(want)
        tst, got = T.process_pkg(tst, torch.from_numpy(pkg), chn, freq)
        got = got.numpy()
        assert got.shape == want.shape == pkg.shape
        if mode == "exact":
            np.testing.assert_array_equal(got, want)
        worst = max(worst, int(np.abs(got - want).max()))
        if freq == 32000:
            # the second half of each 10 ms subpackage is silence
            halves = got.reshape(B, 2, 2, 160, chn)
            assert not halves[:, :, 1].any()
            assert halves[:, :, 0].any() or not pkg.any()
    print(f"NS {freq} Hz chn {chn} {mode}: max {worst} LSB")
    assert worst <= (0 if mode == "exact" else 1)
    assert np.abs(got).max() > 200         # NS passed the signal through
    assert all(480 < c <= 500 for c in tst.update_countdown.tolist()), \
        "no feature window ended"
    if mode == "exact":
        for f in T.NsState._fields:
            np.testing.assert_array_equal(
                getattr(tst, f).numpy(),
                np.stack([np.asarray(getattr(st, f)) for st in jsts]),
                err_msg=f)


def test_ns_exact_argument_overrides_the_environment(monkeypatch):
    """`exact=` decides the mode whatever the environment says, and the
    two modes do differ on these inputs."""
    from wmix_tpu_torch.dsp import ns as T
    pkgs = packages(16000, 1)
    outs = {}
    for env, arg in (("0", True), ("1", False), ("1", None), ("0", None)):
        monkeypatch.setenv("WMIX_EXACT", env)
        st = T.init_state(B, 16000, device="cpu")
        for pkg in pkgs[:4]:
            st, y = T.process_pkg(st, torch.from_numpy(pkg), 1, 16000, arg)
        outs[env, arg] = st.synt_buf
    assert torch.equal(outs["0", True], outs["1", None])
    assert torch.equal(outs["1", False], outs["0", None])
    assert not torch.equal(outs["0", True], outs["0", None])
