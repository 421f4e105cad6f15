"""wmix_tpu_torch RecordChain in exact mode, at every geometry, bit-equal
to wmix_tpu's.

Stored references.  A live exact-mode JAX chain costs one XLA program per
plan signature, one to four CPU-minutes a geometry, so for 16 kHz mono,
16 kHz stereo, 8 kHz mono, 8 kHz stereo (with a 100 ms echo-path delay and
part_cap 32), a 10 ms chain and 32 kHz stereo the reference's outputs and
its final state (one SHA-256 per leaf) are stored under tests/data/ by
`tools/gen_torch_chain_ref.py`, from seeded audio that the tool makes
again here.  The port's exact chain must give the stored int16 `origin`
and 8 kHz packages and VAD flags, and a final state whose every leaf has
the stored digest.  The test marked `slow` runs `wmix_tpu` again and holds
the files to it.  (32 kHz mono runs live: test_torch_chain_live.py.)

Fast mode at the same geometries is held against the port's own exact
chain: `origin` within 4 LSB, VAD flags equal; no JAX program.

The state carried across: `state_to_numpy` then `state_from_numpy` gives
back every leaf, at every geometry, in both modes and both AEC layouts.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tools import gen_torch_chain_ref as ref  # noqa: E402

LSB = 4


def _port_chain(case, exact, monkeypatch):
    from wmix_tpu_torch.engine.chain import RecordChain
    freq, kw, _n, _seed = ref.CASES[case]
    monkeypatch.setenv("WMIX_EXACT", "1" if exact else "0")
    ch = RecordChain(ref.B, freq, device="cpu", **kw)
    assert ch.fast is (not exact)
    return ch


def _run(ch, case):
    mic, play = ref.audio(case)
    outs = [[v.numpy().copy() for v in ch.step(mic[k], play[k])]
            for k in range(mic.shape[0])]
    return [np.stack([o[j] for o in outs]) for j in range(3)]


def _leaf_digests(state):
    from wmix_tpu_torch.engine.checkpoint import _leaves
    return [ref.leaf_digest(x.numpy()) for x in _leaves(state)]


@pytest.mark.parametrize("case", list(ref.CASES))
def test_exact_chain_equals_stored_reference(case, monkeypatch):
    with np.load(ref.path_of(case)) as z:
        want = {k: z[k] for k in z.files}
    ch = _port_chain(case, True, monkeypatch)
    origin, pkg8k, vflags = _run(ch, case)
    assert origin.dtype == np.int16 and pkg8k.dtype == np.int16
    np.testing.assert_array_equal(origin, want["origin"])
    np.testing.assert_array_equal(pkg8k, want["pkg8k"])
    np.testing.assert_array_equal(vflags, want["vflags"])
    got = _leaf_digests(ch.state)
    assert len(got) == len(want["leaf_sha256"])
    bad = [str(n) for n, g, w in zip(want["leaf_names"], got,
                                     want["leaf_sha256"]) if g != w]
    assert not bad, f"state leaves differ from wmix_tpu's: {bad}"
    assert np.abs(origin[-1]).max() > 100       # not silent
    if ch.flags[1]:                             # past the AEC's start-up
        from wmix_tpu_torch.engine.aec_step import AecEngState
        assert isinstance(ch.state.aec, AecEngState)    # never the kernel's
        assert not np.array_equal(origin[-1], ref.audio(case)[0][-1])


@pytest.mark.parametrize("case", list(ref.CASES))
def test_fast_chain_within_4_lsb_of_exact(case, monkeypatch):
    exact = _run(_port_chain(case, True, monkeypatch), case)
    fast_chain = _port_chain(case, False, monkeypatch)
    fast = _run(fast_chain, case)
    d = np.abs(fast[0].astype(np.int32) - exact[0].astype(np.int32))
    d8 = np.abs(fast[1].astype(np.int32) - exact[1].astype(np.int32))
    print(f"{case}: fast vs exact max {d.max()} LSB, equal "
          f"{(d == 0).mean():.4%}")
    assert int(d.max()) <= LSB and int(d8.max()) <= LSB
    np.testing.assert_array_equal(fast[2], exact[2])
    if case.startswith("16k") and fast_chain.flags[1]:
        from wmix_tpu_torch.engine.aec_package import PackageAecState
        assert isinstance(fast_chain.state.aec, PackageAecState)


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
@pytest.mark.parametrize("case", list(ref.CASES))
def test_state_round_trip(case, exact, monkeypatch):
    """state_to_numpy -> state_from_numpy gives every leaf back, and the
    chain goes on from the carried state as if nothing had happened."""
    from wmix_tpu_torch.engine.chain import state_from_numpy, state_to_numpy
    from wmix_tpu_torch.engine.checkpoint import _leaves
    a = _port_chain(case, exact, monkeypatch)
    b = _port_chain(case, exact, monkeypatch)
    mic, play = ref.audio(case)
    half = mic.shape[0] - 2
    for k in range(half):
        a.step(mic[k], play[k])
        b._plan_tick()
    tree = state_to_numpy(a.state)
    assert all(isinstance(x, np.ndarray)
               for x in _leaves_np(tree))
    b.state = state_from_numpy(tree, device="cpu")
    assert type(b.state.aec) is type(a.state.aec)
    for x, y in zip(_leaves(a.state), _leaves(b.state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for k in range(half, mic.shape[0]):
        for u, v in zip(a.step(mic[k], play[k]), b.step(mic[k], play[k])):
            assert torch.equal(u, v)


def _leaves_np(tree):
    if isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_np(v)]
    return [x for v in tree for x in _leaves_np(v)]


@pytest.mark.parametrize("case", list(ref.CASES))
def test_reset_slots_at_every_geometry(case, monkeypatch):
    """Slot 1 reset after a few packages equals a fresh chain's slot, leaf
    by leaf, and slot 0 is untouched."""
    from wmix_tpu_torch.engine.checkpoint import _leaves
    ch = _port_chain(case, True, monkeypatch)
    mic, play = ref.audio(case)
    for k in range(5):
        ch.step(mic[k], play[k])
    before = [x.clone() for x in _leaves(ch.state)]
    ch.reset_slots([1])
    fresh = _leaves(_port_chain(case, True, monkeypatch).state)
    changed = 0
    for a, b0, fr in zip(_leaves(ch.state), before, fresh):
        assert torch.equal(a[0], b0[0])
        assert torch.equal(a[1], fr[1])
        changed += not torch.equal(b0[1], fr[1])
    assert changed > 10


@pytest.mark.slow
@pytest.mark.parametrize("case", list(ref.CASES))
def test_stored_reference_is_what_wmix_tpu_gives(case):
    """Runs `wmix_tpu` itself (minutes a case) and holds the stored file
    to it, array by array."""
    fresh = ref.reference_run(case)
    with np.load(ref.path_of(case)) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)


def test_reference_files_are_small():
    total = sum(os.path.getsize(ref.path_of(c)) for c in ref.CASES)
    assert total < 400_000, total
