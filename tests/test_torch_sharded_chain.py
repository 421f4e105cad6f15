"""wmix_tpu_torch's ShardedRecordChain and dryrun_multichip on the CPU.

The stream axis is pure data parallelism, so a batch split into shards
must give what one chain over the whole batch gives, bit for bit, as
tests/test_multichip.py holds wmix_tpu's sharded chain to its unsharded
one: 16 streams in 8 shards, 2 chunks of K = 4 with the planner
pre-advanced past the AEC's start-up, in fast mode, with the AEC in the
package (kernel) layout at 16 kHz and in the ring layout at 8 kHz; a
slot reset across a shard boundary; `step`; the shards taking turns at
their device reads.  In exact mode and in the
integer chain two shards of one stream each give the stored `wmix_tpu`
outputs and final state of tests/data (no JAX run).  The launch on a
device other than the current one needs two cards and skips here.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tools import gen_torch_chain_ref as ref  # noqa: E402
from wmix_tpu_torch.engine.chain import (RecordChain,  # noqa: E402
                                         ShardedRecordChain)

SHARDS = 8
BATCH = 2 * SHARDS
K, CHUNKS = 4, 2


def _audio(freq, seed, k=K, chunks=CHUNKS):
    n = freq // 1000 * 20
    rng = np.random.RandomState(seed)
    mic = (rng.randn(chunks, k, BATCH, n) * 3000).astype(np.int16)
    play = (rng.randn(chunks, k, BATCH, n) * 5000).astype(np.int16)
    return mic, play


def _advanced(chain, ticks=3):
    for _ in range(ticks):
        chain._plan_tick()
    return chain


def _equal(got, want, what=""):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g, w), what


@pytest.mark.parametrize("freq,layout", [(16000, "kernel"), (8000, "ring")])
def test_sharded_equals_unsharded(freq, layout):
    from wmix_tpu_torch.engine.aec_package import PackageAecState
    from wmix_tpu_torch.engine.aec_step import AecEngState
    mics, plays = _audio(freq, seed=4 if layout == "ring" else 6)
    one = _advanced(RecordChain(BATCH, freq, device="cpu"))
    sh = _advanced(ShardedRecordChain(BATCH, freq, shards=SHARDS,
                                      devices=["cpu"] * SHARDS))
    assert len(sh.state) == SHARDS and sh.shard_b == 2
    for c in range(CHUNKS):
        want = one.run_chunk(mics[c], plays[c])
        got = sh.run_chunk(mics[c], plays[c])
        assert got[0].shape == (K, BATCH, freq // 50)
        _equal(got, want, f"chunk {c}")
    kind = PackageAecState if layout == "kernel" else AecEngState
    assert isinstance(one.state.aec, kind)
    assert all(isinstance(st.aec, kind) for st in sh.state)
    assert sh.planner is sh.chains[0].planner
    assert all(ch.tick == one.tick for ch in sh.chains)


def test_inputs_as_tensors_and_step():
    """`step` over the batch, fed tensors (a pinned-style host tensor is
    sliced by slot range like an array), equals the unsharded step."""
    mics, plays = _audio(16000, seed=7, k=5, chunks=1)
    one = RecordChain(BATCH, 16000, device="cpu")
    sh = ShardedRecordChain(BATCH, 16000, shards=4, devices=["cpu"] * 4)
    for k in range(5):
        mic, play = torch.from_numpy(mics[0, k]), torch.from_numpy(
            plays[0, k])
        _equal(sh.step(mic, play), one.step(mics[0, k], plays[0, k]),
               f"package {k}")


def test_take_turns_issues_every_call_before_any_reads():
    """Three calls, each issuing three segments with a device read after
    each: at every read, every other call still running has issued the
    same segment; the results come back in order, and a call's exception
    is raised after the others have ended."""
    from wmix_tpu_torch.utils.turns import read_bool, take_turns
    log = []

    def call(i, fail=False):
        def run():
            for k in range(3):
                log.append(("issue", i, k))
                assert read_bool(torch.tensor(True))
                log.append(("read", i, k))
                if fail and k == 1:
                    raise ValueError("shard 1")
            return i
        return run
    assert take_turns([call(i) for i in range(3)]) == [0, 1, 2]
    for n, (what, i, k) in enumerate(log):
        if what == "read":
            assert all(("issue", j, k) in log[:n] for j in range(3)), log
    log.clear()
    with pytest.raises(ValueError, match="shard 1"):
        take_turns([call(0), call(1, fail=True), call(2)])
    assert ("read", 0, 2) in log and ("read", 2, 2) in log


@pytest.mark.parametrize("method", ["step", "run_chunk"])
def test_shards_take_turns_at_their_reads(method, monkeypatch):
    """The shards' AGC reads hand the turn on, from a thread of each
    shard, none of them the caller's, and the outputs still equal the
    unsharded chain's."""
    from wmix_tpu_torch.utils import turns
    mics, plays = _audio(16000, seed=9, k=2, chunks=1)
    one = RecordChain(BATCH, 16000, device="cpu")
    sh = ShardedRecordChain(BATCH, 16000, shards=4, devices=["cpu"] * 4)
    passes = []
    real = turns._Turns.pass_on
    monkeypatch.setattr(turns._Turns, "pass_on", lambda self, me: (
        passes.append((me, threading.get_ident())), real(self, me))[1])
    mic, play = (mics[0], plays[0]) if method == "run_chunk" else \
        (mics[0, 0], plays[0, 0])
    _equal(getattr(sh, method)(mic, play), getattr(one, method)(mic, play))
    assert {me for me, _t in passes} == {0, 1, 2, 3}
    threads = {t for _me, t in passes}
    assert len(threads) == 4 and threading.get_ident() not in threads


def test_reset_slots_across_a_shard_boundary():
    """Slots 3 and 4 (the last of shard 0, the first of shard 1 of four)
    reset between chunks: every shard's state equals its rows of the
    unsharded chain given the same reset, leaf by leaf, and so do the
    next chunk's outputs."""
    from wmix_tpu_torch.engine.checkpoint import _leaves
    mics, plays = _audio(16000, seed=8)
    one = _advanced(RecordChain(BATCH, 16000, device="cpu"))
    sh = _advanced(ShardedRecordChain(BATCH, 16000, shards=4,
                                      devices=["cpu"] * 4))
    _equal(sh.run_chunk(mics[0], plays[0]), one.run_chunk(mics[0],
                                                          plays[0]))
    before = [x.clone() for x in _leaves(sh.state[1])]
    one.reset_slots([3, 4])
    sh.reset_slots(np.array([3, 4]))
    whole = _leaves(one.state)
    for i, st in enumerate(sh.state):
        for x, w in zip(_leaves(st), whole):
            assert torch.equal(x, w[4 * i:4 * i + 4])
    after = _leaves(sh.state[1])
    assert sum(not torch.equal(x[0], b[0])
               for x, b in zip(after, before)) > 10      # row 0 reset
    assert all(torch.equal(x[1:], b[1:]) for x, b in zip(after, before))
    _equal(sh.run_chunk(mics[1], plays[1]), one.run_chunk(mics[1],
                                                          plays[1]))


def _stored(case):
    with np.load(ref.path_of(case)) as z:
        return {k: z[k] for k in z.files}


def _leaf_matches(x, digest):
    forms = [x]
    if x.dtype.kind in "iu":
        forms += [x.astype(t) for t in (np.int32, np.uint32, np.int64)]
    return any(ref.leaf_digest(f) == digest for f in forms)


@pytest.mark.parametrize("case", ["16k_mono", "int_16k_mono"])
def test_two_shards_equal_stored_wmix_tpu(case, monkeypatch):
    """ShardedRecordChain(2, shards=2): one stream a shard, in exact mode
    (16 kHz mono) and in the integer chain (NSX + AECM); the outputs and
    every leaf of the final state (the shards' rows joined) equal the
    stored `wmix_tpu` run bit for bit."""
    from wmix_tpu_torch.engine.checkpoint import _leaves
    integer = case in ref.INT_CASES
    freq, kw, _n, _seed = (ref.INT_CASES if integer else ref.CASES)[case]
    mic, play = (ref.int_audio if integer else ref.audio)(case)
    monkeypatch.setenv("WMIX_EXACT", "1")
    sh = ShardedRecordChain(ref.B, freq, shards=2, devices=["cpu", "cpu"],
                            **kw)
    assert not sh.chains[0].fast
    outs = [[v.numpy() for v in sh.step(mic[k], play[k])]
            for k in range(mic.shape[0])]
    want = _stored(case)
    for j, nm in enumerate(("origin", "pkg8k", "vflags")):
        np.testing.assert_array_equal(np.stack([o[j] for o in outs]),
                                      want[nm], err_msg=nm)
    joined = [torch.cat(rows).numpy() for rows in
              zip(*(_leaves(st) for st in sh.state))]
    assert len(joined) == len(want["leaf_sha256"])
    bad = [str(n) for n, x, d in zip(want["leaf_names"], joined,
                                     want["leaf_sha256"])
           if not _leaf_matches(x, str(d))]
    assert not bad, f"state leaves differ from wmix_tpu's: {bad}"


def test_dryrun_multichip_on_cpu_shards(capsys):
    from wmix_tpu_torch.multichip import dryrun_multichip
    dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all("dryrun_multichip: " in ln
                                   for ln in lines)


def test_no_card_no_shards(monkeypatch):
    """Without a card: the default devices raise, `cuda:N` raises at
    `resolve_device`, and dryrun_multichip refuses to stack shards."""
    from wmix_tpu_torch.device import resolve_device
    from wmix_tpu_torch.multichip import dryrun_multichip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: ShardedRecordChain(4, 16000),
                  lambda: resolve_device("cuda:7"),
                  lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            build()
    with pytest.raises(ValueError):
        ShardedRecordChain(5, 16000, shards=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        ShardedRecordChain(4, 16000, shards=2, devices=["cpu"])


def test_cuda_index_beyond_the_count_raises(monkeypatch):
    from wmix_tpu_torch.device import resolve_device
    from wmix_tpu_torch.multichip import shard_devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="only 2 CUDA device"):
        resolve_device("cuda:2")
    assert resolve_device("cuda:1") == torch.device("cuda:1")
    assert shard_devices(2) == [torch.device("cuda:0"),
                                torch.device("cuda:1")]
    with pytest.raises(RuntimeError, match="3 CUDA devices wanted, 2"):
        shard_devices(3)


@pytest.mark.cuda
def test_kernel_on_a_device_that_is_not_current():
    """With cuda:0 current, the kernel on cuda:1's tensors launches on
    cuda:1 and equals its plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from wmix_tpu_torch.engine import aec_package as ap
    from wmix_tpu_torch.engine.aec_step import pack_dyn
    dev = torch.device("cuda:1")
    torch.cuda.set_device(0)
    rng = np.random.RandomState(1)
    far = torch.from_numpy((rng.randn(9, 8, 320) * 4000).astype(
        np.float32)).to(dev)
    near = torch.roll(far, 2, dims=0) * 0.3
    a = ap.AecBatchPackage(8, 16000, device=dev)
    for p in range(8):
        a.step(far[p], near[p])
    plan = a.planner.plan_pkg()
    dyn = pack_dyn(plan, a.part_cap)
    ap.build_far_body(plan.signature(), a.sub_len)(
        a.ast.far_pre, a.ast.far_parts, a.ast.farw_parts, far[8], dyn)
    ins = (near[8].contiguous(),
           *ap._kernel_inputs(a.ast.far_parts, a.ast.farw_parts, dyn))
    n0 = ap.package_step.launches_by_device["cuda:1"]
    st_k, out_k = ap.package_step({k: v.clone() for k, v in
                                   a.ast.p.items()}, *ins)
    st_p, out_p = ap.package_body({k: v.clone() for k, v in
                                   a.ast.p.items()}, *ins)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert ap.package_step.launches_by_device["cuda:1"] == n0 + 1
    rel = float((out_k - out_p).abs().max() /
                out_p.abs().max().clamp_min(1.0))
    assert rel <= 1e-4
    for k in ap.SCALAR_I:
        assert torch.equal(st_k[k], st_p[k]), k
