"""wmix_tpu_torch.engine.checkpoint: the cases of tests/test_checkpoint.py
against the port, and snapshots made by `wmix_tpu` restored into it.

All on the CPU (`device="cpu"`).  The round trips are bit-exact by
construction: the restored leaves are the saved bytes and the host planner
replays from the saved cursors.  The `wmix_tpu` snapshots are of fresh
chains (constructing and snapshotting one compiles nothing).
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu_torch.engine import checkpoint  # noqa: E402
from wmix_tpu_torch.engine.aec_package import PackageAecState  # noqa: E402
from wmix_tpu_torch.engine.aec_step import AecEngState  # noqa: E402
from wmix_tpu_torch.engine.chain import (RecordChain,  # noqa: E402
                                         state_from_numpy)

B, FREQ, PKG = 2, 16000, 320


def _audio(n, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, B, PKG) * 3000).astype(np.int16),
            (rng.randn(n, B, PKG) * 5000).astype(np.int16))


def _chain(**kw):
    return RecordChain(B, FREQ, device="cpu", **kw)


# packages before the snapshot: 2 leaves the chain in AEC start-up (the
# exact ring layout), 7 is three packages after it converted to the kernel
# layout at the first steady package
@pytest.mark.parametrize("n_before, layout", [(2, AecEngState),
                                              (7, PackageAecState)])
def test_snapshot_restore_bit_identical(tmp_path, n_before, layout):
    n_after = 5
    mic, play = _audio(n_before + n_after, seed=11)

    ref = _chain()
    ref.run_chunk(mic[:n_before], play[:n_before])
    want = ref.run_chunk(mic[n_before:], play[n_before:])

    a = _chain()
    a.run_chunk(mic[:n_before], play[:n_before])
    assert isinstance(a.state.aec, layout)
    path = str(tmp_path / "snap.npz")
    checkpoint.save(a, path)

    b = _chain()
    checkpoint.load(b, path)
    assert isinstance(b.state.aec, layout)
    assert b.tick == a.tick and b.play_count == a.play_count
    got = b.run_chunk(mic[n_before:], play[n_before:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the snapshotted chain itself goes on unharmed
    again = a.run_chunk(mic[n_before:], play[n_before:])
    for g, w in zip(again, want):
        assert torch.equal(g, w)


def test_restored_leaves_keep_dtype_and_device():
    a = _chain()
    mic, play = _audio(1, seed=2)
    a.step(mic[0], play[0])
    b = _chain()
    checkpoint.restore(b, checkpoint.snapshot(a))
    la, lb = checkpoint._leaves(a.state), checkpoint._leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)
        assert x.data_ptr() != y.data_ptr()


def _edit_header(blob, edit):
    with np.load(io.BytesIO(blob)) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays["header"].tobytes()).decode())
    edit(header)
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_restore_rejects_geometry_mismatch():
    blob = checkpoint.snapshot(_chain())
    b = RecordChain(4, FREQ, device="cpu")
    with pytest.raises(ValueError, match="batch mismatch"):
        checkpoint.restore(b, blob)
    with pytest.raises(ValueError, match="flags mismatch"):
        checkpoint.restore(_chain(ns_enable=False), blob)


def test_restore_rejects_unknown_planner_field():
    blob = _edit_header(checkpoint.snapshot(_chain()),
                        lambda h: h["planner"].__setitem__("evil_field", 1))
    with pytest.raises(ValueError, match="unknown planner field"):
        checkpoint.restore(_chain(), blob)


@pytest.mark.parametrize("key, value", [("aec_layout", "aecm"),
                                        ("ns_backend", "nsx")])
def test_restore_rejects_unported_backends(key, value):
    """A snapshot of a chain with an integer backend restores into a chain
    with that backend, leaf for leaf; into a float chain it raises the
    reference's message, and so does a float snapshot into it."""
    kw = dict(aec_backend="aecm") if key == "aec_layout" else \
        dict(ns_backend="nsx")
    a = _chain(**kw)
    mic, play = _audio(3, seed=4)
    a.run_chunk(mic, play)
    blob = checkpoint.snapshot(a)
    with np.load(io.BytesIO(blob)) as z:
        assert json.loads(bytes(z["header"].tobytes()).decode())[key] == \
            value
    b = _chain(**kw)
    checkpoint.restore(b, blob)
    assert (b.tick, b.play_count) == (a.tick, a.play_count)
    _assert_states_equal(b.state, a.state)
    name = "aec_backend='aecm'" if key == "aec_layout" else \
        "ns_backend='nsx'"
    with pytest.raises(ValueError, match=name):
        checkpoint.restore(_chain(), blob)
    with pytest.raises(ValueError, match="construct the target"):
        checkpoint.restore(_chain(**kw), checkpoint.snapshot(_chain()))


def test_restore_rejects_wrong_leaf_shape_and_count():
    blob = checkpoint.snapshot(_chain())
    with np.load(io.BytesIO(blob)) as z:
        arrays = {k: z[k] for k in z.files}
    bad = dict(arrays, leaf_0=arrays["leaf_0"][:, :-1])
    buf = io.BytesIO()
    np.savez(buf, **bad)
    with pytest.raises(ValueError, match="leaf shape mismatch"):
        checkpoint.restore(_chain(), buf.getvalue())
    # a kernel-layout header over exact-layout leaves: the counts differ
    blob2 = _edit_header(blob, lambda h: h.__setitem__("aec_layout",
                                                       "pallas"))
    with pytest.raises(ValueError, match="leaf count mismatch"):
        checkpoint.restore(_chain(), blob2)


def _assert_states_equal(got, want):
    lg, lw = checkpoint._leaves(got), checkpoint._leaves(want)
    assert len(lg) == len(lw)
    for i, (x, y) in enumerate(zip(lg, lw)):
        assert x.dtype == y.dtype, i
        assert torch.equal(x, y), i


@pytest.mark.parametrize("layout", ["jax", "pallas", "aecm"])
def test_wmix_tpu_snapshot_restores_into_the_port(layout, monkeypatch):
    """A snapshot made by `wmix_tpu.engine.checkpoint` of a fresh 16 kHz
    fast-mode chain, in either AEC layout or with the integer backends
    (AECM and NSX, whose uint32 leaves the port holds in int64), restores
    into the port and
    equals `state_from_numpy` of the same state leaf by leaf: the two
    packages flatten their states in the same order."""
    import jax
    monkeypatch.setenv("WMIX_FAST", "1")
    from wmix_tpu.engine import aec_pallas
    from wmix_tpu.engine import checkpoint as jax_checkpoint
    from wmix_tpu.engine.chain import RecordChain as JaxChain
    integer = dict(aec_backend="aecm", ns_backend="nsx") \
        if layout == "aecm" else {}
    jc = JaxChain(B, FREQ, **integer)
    for _ in range(5):      # host cursors away from their start
        jc._plan_tick()
    if layout == "pallas":
        jc.state = jc.state._replace(
            aec=aec_pallas.init_chain_aec(B, jc.part_cap))
    # mark every leaf so that a swapped pair of equal-shaped leaves shows
    leaves, treedef = jax.tree_util.tree_flatten(jc.state)
    leaves = [x + np.asarray(i + 1, x.dtype) for i, x in enumerate(leaves)]
    jc.state = jax.tree_util.tree_unflatten(treedef, leaves)
    blob = jax_checkpoint.snapshot(jc)

    port = _chain(**integer)
    checkpoint.restore(port, blob)
    assert checkpoint._aec_layout(port) == layout
    assert port.tick == jc.tick == 5 and port.play_count == jc.play_count
    assert checkpoint._planner_state(port.planner) == \
        jax_checkpoint._planner_state(jc.planner)
    want = state_from_numpy(jax.tree_util.tree_map(np.array, jc.state),
                            device="cpu")
    _assert_states_equal(port.state, want)
    # and the port's own snapshot of it carries the same leaves and, but for
    # its own additions, the same header
    with np.load(io.BytesIO(blob)) as zj, \
            np.load(io.BytesIO(checkpoint.snapshot(port))) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        hj = json.loads(bytes(zj["header"].tobytes()).decode())
        hp = json.loads(bytes(zp["header"].tobytes()).decode())
        # the port's header adds what the reference's does not write
        assert {k: hp.pop(k) for k in ("interval_ms", "aec_interval_ms",
                                       "exact")} == \
            {"interval_ms": 20, "aec_interval_ms": 400, "exact": False}
        assert hj == hp
        for k in set(zj.files) - {"header"}:
            np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)

