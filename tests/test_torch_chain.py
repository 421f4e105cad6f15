"""wmix_tpu_torch RecordChain against wmix_tpu's, and the CUDA kernel
against its plain version.

Chain: RecordChain(2, 16000) in its defaults (NS+AEC+AGC+VAD, AGC 5 dB),
a chunk of 9 packages (3 start-up, 1 irregular, 5 steady) and a chunk of 5
steady ones, of seeded mic/play audio as test_aec_pallas.py makes them,
the JAX chain with WMIX_PALLAS=1 (its Pallas kernel in interpret mode) in
fast mode.  Both chunks hold 5 steady packages, so the JAX side compiles
its steady program (the slow part of the set-up) once.  Gate: origin and the 8 kHz package within
4 LSB, VAD flags equal (float32 reassociation through NS and AEC, as
test_aec_pallas.py:62-90).  A second check starts the port's chain from
the JAX chain's own state after chunk 1 (carried across with
`state_from_numpy`) and holds chunk 2 to the same gate.

The kernel test needs a CUDA device and skips without one; on a GPU
machine without jax it runs alone:
    python -m pytest --noconftest -m cuda tests/test_torch_chain.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

B = 2
CHUNK_LENS = (9, 5)     # 4 + 5 steady packages, then 5 steady
K = CHUNK_LENS[0]
CHUNKS = len(CHUNK_LENS)
LSB = 4


def _audio():
    rng = np.random.RandomState(0)
    mic = (rng.randn(sum(CHUNK_LENS), B, 320) * 3000).astype(np.int16)
    play = (rng.randn(sum(CHUNK_LENS), B, 320) * 5000).astype(np.int16)
    return mic, play


def _chunk(x, c):
    lo = sum(CHUNK_LENS[:c])
    return x[lo:lo + CHUNK_LENS[c]]


@pytest.fixture(scope="module")
def ref():
    # jax only here: the CUDA test below runs where jax is not installed
    import jax
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WMIX_FAST", "1")
        mp.setenv("WMIX_PALLAS", "1")
        from wmix_tpu.engine.chain import RecordChain
        mic, play = _audio()
        ch = RecordChain(B, 16000)
        outs, states = [], []
        for c in range(CHUNKS):
            states.append(jax.tree_util.tree_map(np.array, ch.state))
            o = ch.run_chunk(_chunk(mic, c), _chunk(play, c))
            outs.append([np.asarray(v) for v in o])
    return dict(outs=outs, states=states)


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


def test_reset_slots_restarts_one_stream():
    """A reset slot's state equals a fresh chain's; the other stream's
    state is untouched."""
    from wmix_tpu_torch.engine.chain import RecordChain, state_to_numpy
    mic, play = _audio()
    ch = RecordChain(B, 16000, device="cpu")
    ch.run_chunk(mic[:K], play[:K])
    before = state_to_numpy(ch.state)
    ch.reset_slots([1])
    after = state_to_numpy(ch.state)
    fresh = state_to_numpy(RecordChain(1, 16000, device="cpu").state)
    for f in ("ns", "agc", "vad"):
        for a, b0, fr in zip(getattr(after, f), getattr(before, f),
                             getattr(fresh, f)):
            np.testing.assert_array_equal(a[0], b0[0])
            np.testing.assert_array_equal(a[1], fr[0])


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
