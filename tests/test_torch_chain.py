"""wmix_tpu_torch RecordChain against wmix_tpu's, and the CUDA kernel
against its plain version.

Chain: RecordChain(2, 16000) in its defaults (NS+AEC+AGC+VAD, AGC 5 dB),
a chunk of 9 packages (3 start-up, 1 irregular, 5 steady) and a chunk of 5
steady ones, of seeded mic/play audio as test_aec_pallas.py makes them,
against the JAX chain with WMIX_PALLAS=1 (its Pallas kernel in interpret
mode) in fast mode.  The JAX chain's outputs and its state between the
chunks are stored in tests/data/torch_chain_fast_fast_pallas_16k.npz by
`python tools/gen_torch_chain_ref.py fast_pallas_16k` (about two
CPU-minutes of XLA compilation); the test marked `slow` runs `wmix_tpu`
again and holds the file to it.  Gate: origin and the 8 kHz package within
4 LSB, VAD flags equal (float32 reassociation through NS and AEC, as
test_aec_pallas.py:62-90).  A second check starts the port's chain from
the JAX chain's own state after chunk 1 (carried across with
`state_from_numpy`) and holds chunk 2 to the same gate.  On the same
fixture the port's StreamServer must give the port's `run_chunk` outputs
bit for bit.  `reset_slots` is held leaf by leaf (NS, AEC, AGC, VAD, the
play FIFO) in both AEC layouts.

The kernel test needs a CUDA device and skips without one; on a GPU
machine without jax it runs alone:
    python -m pytest --noconftest -m cuda tests/test_torch_chain.py
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tools import gen_torch_chain_ref as gen  # noqa: E402

B = gen.B
CHUNK_LENS = gen.FAST_CHUNK_LENS     # 4 + 5 steady packages, then 5 steady
K = CHUNK_LENS[0]
CHUNKS = len(CHUNK_LENS)
LSB = 4


def _audio():
    return gen.fast_audio()


def _chunk(x, c):
    lo = sum(CHUNK_LENS[:c])
    return x[lo:lo + CHUNK_LENS[c]]


@pytest.fixture(scope="module")
def ref():
    stored = gen.load_fast_reference()
    return dict(outs=stored["outs"], states={1: stored["state1"]})


@pytest.mark.slow
def test_stored_reference_is_what_wmix_tpu_gives(tmp_path):
    """Runs `wmix_tpu`'s fast Pallas chain again, in a process of its own
    (it reads its mode when it traces), and holds the stored file to it,
    array by array."""
    import subprocess
    import sys
    out = tmp_path / "fresh.npz"
    code = ("import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
            "from tools import gen_torch_chain_ref as g; "
            "np.savez(sys.argv[2], **g.fast_reference_run())")
    subprocess.run([sys.executable, "-c", code, gen.REPO, str(out)],
                   check=True, env=dict(os.environ, PYTHONPATH=gen.REPO))
    with np.load(gen.path_of(gen.FAST_CASE)) as z, np.load(out) as f:
        assert sorted(z.files) == sorted(f.files)
        for k in z.files:
            np.testing.assert_array_equal(z[k], f[k], err_msg=k)


def test_reference_file_is_small():
    assert os.path.getsize(gen.path_of(gen.FAST_CASE)) < 200_000


def _check(port, want):
    o, p8, vf = (v.numpy() for v in port)
    wo, wp8, wvf = want
    assert o.dtype == np.int16 and p8.dtype == np.int16
    d = np.abs(o.astype(np.int32) - wo.astype(np.int32))
    d8 = np.abs(p8.astype(np.int32) - wp8.astype(np.int32))
    assert int(d.max()) <= LSB, int(d.max())
    assert int(d8.max()) <= LSB, int(d8.max())
    np.testing.assert_array_equal(vf, wvf)
    return int(d.max()), float((d == 0).mean())


def test_chain_matches_wmix_tpu(ref):
    from wmix_tpu_torch.engine.aec_package import PackageAecState
    from wmix_tpu_torch.engine.chain import RecordChain
    mic, play = _audio()
    ch = RecordChain(B, 16000, device="cpu")
    for c in range(CHUNKS):
        got = ch.run_chunk(_chunk(mic, c), _chunk(play, c))
        worst, exact = _check(got, ref["outs"][c])
        print(f"chunk {c}: max {worst} LSB, bit-equal {exact:.4%}")
    assert isinstance(ch.state.aec, PackageAecState)


def test_chain_from_carried_state(ref):
    """Chunk 2 from the JAX chain's own state after chunk 1 (adapted AEC
    filter in the kernel layout), carried across by name."""
    from wmix_tpu_torch.engine.chain import (RecordChain, state_from_numpy,
                                             state_to_numpy)
    mic, play = _audio()
    ch = RecordChain(B, 16000, device="cpu")
    for _ in range(K):      # the host planner and FIFO cursor to chunk 2
        ch._plan_tick()
    ch.state = state_from_numpy(ref["states"][1], device="cpu")
    back = state_to_numpy(ch.state)
    np.testing.assert_array_equal(back.aec.p["wf_re"],
                                  ref["states"][1].aec.p["wf_re"])
    got = ch.run_chunk(_chunk(mic, 1), _chunk(play, 1))
    _check(got, ref["outs"][1])


def _check_reset(n_pkgs, kernel_layout):
    """Run n_pkgs, reset slot 1: every leaf of slot 1 (NS, AEC, AGC, VAD
    and the play FIFO) equals a fresh state's in the chain's current AEC
    layout, and every leaf of slot 0 is untouched."""
    from wmix_tpu_torch.engine import aec_package
    from wmix_tpu_torch.engine.chain import RecordChain
    from wmix_tpu_torch.engine.checkpoint import _leaves
    mic, play = _audio()
    ch = RecordChain(B, 16000, device="cpu")
    ch.run_chunk(mic[:n_pkgs], play[:n_pkgs])
    assert isinstance(ch.state.aec,
                      aec_package.PackageAecState) == kernel_layout
    before = [x.clone() for x in _leaves(ch.state)]
    ch.reset_slots([1])
    after = _leaves(ch.state)
    fresh = RecordChain(1, 16000, device="cpu").state
    if kernel_layout:
        fresh = fresh._replace(aec=aec_package.init_chain_aec(
            1, ch.part_cap, "cpu"))
    fresh = _leaves(fresh)
    assert len(after) == len(before) == len(fresh)
    changed = 0
    for a, b0, fr in zip(after, before, fresh):
        assert torch.equal(a[0], b0[0])
        assert torch.equal(a[1], fr[0])
        changed += int(not torch.equal(a[1], b0[1]))
    # the run did move the slot away from its fresh state, AEC and FIFO
    # included
    assert changed > len(fresh) // 3
    assert not torch.equal(before[-1][1], fresh[-1][0])      # play_fifo


def test_reset_slots_restarts_one_stream():
    """After the chain has converted to the kernel layout: a reset slot's
    state equals a fresh chain's with `init_chain_aec` rows; the other
    stream's state is untouched."""
    _check_reset(K, kernel_layout=True)


def test_reset_slots_in_the_exact_layout():
    """The same during AEC start-up, in the exact ring layout."""
    _check_reset(2, kernel_layout=False)


def test_step_takes_tensors_on_its_device_without_a_copy():
    from wmix_tpu_torch.engine.chain import RecordChain
    ch = RecordChain(B, 16000, device="cpu", ns_enable=False,
                     aec_enable=False)
    mic, play = _audio()
    t = torch.from_numpy(mic[0])
    assert ch._on_device(t) is t
    assert ch._on_device(mic[0]).dtype == torch.int16
    a = ch.step(t, torch.from_numpy(play[0]))
    b = RecordChain(B, 16000, device="cpu", ns_enable=False,
                    aec_enable=False).step(mic[0], play[0])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_stream_server_on_the_chain_fixture(ref):
    """The port's StreamServer, both slots opened before the first tick
    and fed the fixture's packages through feed_batch and tick, gives the
    port's run_chunk outputs bit for bit, and so stays within 4 LSB of the
    JAX chain with VAD flags equal."""
    from wmix_tpu_torch.engine.chain import RecordChain
    from wmix_tpu_torch.service.stream_server import StreamServer
    mic, play = _audio()
    n = sum(CHUNK_LENS)
    ch = RecordChain(B, 16000, device="cpu")
    want = ch.run_chunk(mic, play)
    srv = StreamServer(B, 16000, device="cpu")
    hs = [srv.open_stream() for _ in range(B)]
    got = []
    for t in range(n):
        srv.feed_batch(hs, mic[t], play[t])
        srv.tick()
        got.append(srv.read_batch(hs))
    got = tuple(torch.from_numpy(np.stack([g[j] for g in got]))
                for j in range(3))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for c in range(CHUNKS):
        _check(tuple(_chunk(g, c) for g in got), ref["outs"][c])


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 257])
def test_kernel_matches_package_body(cuda_device, batch):
    """The CUDA package kernel against its plain version, from an adapted
    state: rel <= 1e-4 on the output and every float state field, equality
    on every integer state field (the discrete decisions)."""
    from wmix_tpu_torch.engine.aec_package import (AecBatchPackage,
                                                   SCALAR_I, STATE_FIELDS,
                                                   _kernel_inputs,
                                                   build_far_body,
                                                   package_body,
                                                   package_step)
    from wmix_tpu_torch.engine.aec_step import pack_dyn
    rng = np.random.RandomState(batch)
    far = torch.from_numpy((rng.randn(9, batch, 320) * 4000).astype(
        np.float32)).to(cuda_device)
    near = (torch.roll(far, 2, dims=0) * 0.3 + torch.from_numpy(
        (rng.randn(9, batch, 320) * 800).astype(np.float32)).to(cuda_device))
    a = AecBatchPackage(batch, 16000, device=cuda_device)
    for p in range(8):
        a.step(far[p], near[p])
    plan = a.planner.plan_pkg()
    dyn = pack_dyn(plan, a.part_cap)
    build_far_body(plan.signature(), a.sub_len)(
        a.ast.far_pre, a.ast.far_parts, a.ast.farw_parts, far[8], dyn)
    ins = (near[8].contiguous(),
           *_kernel_inputs(a.ast.far_parts, a.ast.farw_parts, dyn))
    st_k = {k: v.clone() for k, v in a.ast.p.items()}
    st_p = {k: v.clone() for k, v in a.ast.p.items()}
    n0 = package_step.launches
    st_k, out_k = package_step(st_k, *ins)
    assert package_step.launches == n0 + 1
    st_p, out_p = package_body(st_p, *ins)
    torch.cuda.synchronize()

    def rel(x, y):
        x, y = x.double(), y.double()
        return float((x - y).abs().max() / y.abs().max().clamp_min(1.0))
    assert rel(out_k, out_p) <= 1e-4
    for k in STATE_FIELDS:
        if k in SCALAR_I:
            assert torch.equal(st_k[k], st_p[k]), k
        else:
            assert rel(st_k[k], st_p[k]) <= 1e-4, k
