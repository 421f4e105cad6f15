"""wmix_tpu_torch's exact-mode RecordChain against a live wmix_tpu chain.

The one geometry whose JAX chain is a single program: 32 kHz mono (the
daemon turns the AEC off above 16 kHz).  The AGC is off here: its
per-sample loops are 60 of the 90 s that XLA takes over the whole program
and NS + VAD compile in 35 s; the AGC at 32 kHz is held bit-equal on its
own in test_torch_geometries.py and inside the stored 32 kHz stereo
chain.  B = 2 streams, 3 packages of seeded audio, WMIX_EXACT=1 on both sides and
x64 on the JAX side: `origin`, the 8 kHz package, the VAD flags and every
state leaf bit-equal after each package count.  Then the JAX chain's own
state after two packages is carried into a fresh port chain with
`state_from_numpy`, and the third package must again be equal.

Every other geometry is held against stored references of the same kind
(test_torch_chain_exact.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

B, FREQ, N_PKGS = 2, 32000, 3


def _audio():
    rng = np.random.RandomState(32)
    n = FREQ // 1000 * 20
    t = np.arange(N_PKGS * n).reshape(N_PKGS, 1, n) / FREQ
    tone = 3000 * np.sin(2 * np.pi * rng.uniform(200, 1500, (1, B, 1)) * t)
    mic = tone + rng.randn(N_PKGS, B, n) * 900
    play = rng.randn(N_PKGS, B, n) * 5000
    cast = lambda x: np.clip(np.round(x), -32768, 32767).astype(np.int16)
    return cast(mic), cast(play)


@pytest.fixture(scope="module")
def live():
    """The reference chain's outputs package by package and its state
    before the last package."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WMIX_EXACT", "1")
        mp.setenv("WMIX_FAST", "0")
        from wmix_tpu.engine.chain import RecordChain
        mic, play = _audio()
        ch = RecordChain(B, FREQ, agc_enable=False)
        assert ch.flags[1] is False         # no AEC above 16 kHz
        outs, carried = [], None
        for k in range(N_PKGS):
            if k == N_PKGS - 1:
                carried = jax.tree_util.tree_map(np.array, ch.state)
            outs.append([np.asarray(v) for v in ch.step(mic[k], play[k])])
        final = jax.tree_util.tree_map(np.array, ch.state)
        yield dict(outs=outs, carried=carried, final=final)


def _port(monkeypatch):
    from wmix_tpu_torch.engine.chain import RecordChain
    monkeypatch.setenv("WMIX_EXACT", "1")
    ch = RecordChain(B, FREQ, agc_enable=False, device="cpu")
    assert ch.fast is False and ch.flags[1] is False
    return ch


def _assert_state_equal(port_state, jax_state):
    from wmix_tpu_torch.engine.checkpoint import _leaves
    want = jax.tree_util.tree_leaves(jax_state)
    got = _leaves(port_state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"leaf {i}")


def test_exact_chain_equals_live_wmix_tpu(live, monkeypatch):
    ch = _port(monkeypatch)
    mic, play = _audio()
    for k in range(N_PKGS):
        got = ch.step(mic[k], play[k])
        for g, w in zip(got, live["outs"][k]):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"pkg {k}")
    _assert_state_equal(ch.state, live["final"])
    origin = got[0].numpy()
    assert origin.dtype == np.int16 and origin.shape == (B, 640)
    # the second half of each 10 ms NS subpackage is silent by design, so
    # "not silent" looks at the first halves
    assert np.abs(origin.reshape(B, 2, 2, 160)[:, :, 0]).max() > 100


def test_exact_chain_from_carried_state(live, monkeypatch):
    from wmix_tpu_torch.engine.chain import state_from_numpy
    ch = _port(monkeypatch)
    mic, play = _audio()
    for _ in range(N_PKGS - 1):
        ch._plan_tick()
    ch.state = state_from_numpy(live["carried"], device="cpu")
    got = ch.step(mic[-1], play[-1])
    for g, w in zip(got, live["outs"][-1]):
        np.testing.assert_array_equal(g.numpy(), w)
    _assert_state_equal(ch.state, live["final"])
