"""wmix_tpu_torch StreamServer: the cases of tests/test_stream_server.py
against the port's server and the port's dedicated chain, on the CPU.

Per-slot outputs are bit-exact against a dedicated RecordChain(1) at the
same tick phase (the admission contract), for admissions at tick 0, at
tick 3 (the irregular package, exact AEC layout) and at tick 6 (steady:
the reset slot gets fresh kernel-layout rows, the dedicated chain converts
its fresh exact-layout state at its first step).  Full chain where the
case is about admission; AGC + VAD only where it is about lanes and
ordering.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu_torch.engine.chain import RecordChain  # noqa: E402
from wmix_tpu_torch.service.stream_server import (SlotClosed,  # noqa: E402
                                                  StreamServer)
from wmix_tpu_torch.staging import PinnedRing  # noqa: E402

FREQ = 16000
PKG = FREQ // 1000 * 20
LANES = dict(ns_enable=False, aec_enable=False)     # AGC + VAD only


def _server(capacity, **kw):
    return StreamServer(capacity, FREQ, device="cpu", **kw)


def _ref_chain(phase_ticks, mics, plays, **kw):
    """Dedicated single-slot chain admitted at the same planner phase."""
    rc = RecordChain(1, FREQ, device="cpu", **kw)
    for _ in range(phase_ticks):
        rc._plan_tick()
    outs = []
    for m, p in zip(mics, plays):
        o, p8, v = rc.step(m[None], p[None])
        outs.append((o.numpy()[0], p8.numpy()[0], v.numpy()[0]))
    return outs


@pytest.mark.parametrize("admit_c_at", [3, 6])
def test_concurrent_slots_bit_exact(admit_c_at):
    rng = np.random.RandomState(5)
    srv = _server(4)
    n_ticks = admit_c_at + 5

    def pcm(scale):
        return (rng.randn(n_ticks, PKG) * scale).astype(np.int16)
    mics_a, plays_a = pcm(3000), pcm(5000)
    mics_b, plays_b = pcm(2000), pcm(4000)
    mics_c, plays_c = pcm(1000), pcm(2500)

    a = srv.open_stream()
    b = srv.open_stream()
    got = {a: [], b: []}
    c = None
    for t in range(n_ticks):
        if t == admit_c_at:
            c = srv.open_stream()
            got[c] = []
        srv.feed(a, mics_a[t], plays_a[t])
        srv.feed(b, mics_b[t], plays_b[t])
        if c is not None:
            srv.feed(c, mics_c[t - admit_c_at], plays_c[t - admit_c_at])
        srv.tick()
        for h in list(got):
            r = srv.read(h)
            if r is not None:
                got[h].append(r)

    n_c = n_ticks - admit_c_at
    refs = ((a, _ref_chain(0, mics_a, plays_a)),
            (b, _ref_chain(0, mics_b, plays_b)),
            (c, _ref_chain(admit_c_at, mics_c[:n_c], plays_c[:n_c])))
    for h, ref in refs:
        assert len(got[h]) == len(ref)
        for i, ((o, p8, v), (ro, rp8, rv)) in enumerate(zip(got[h], ref)):
            np.testing.assert_array_equal(o, ro, err_msg=f"pkg {i}")
            np.testing.assert_array_equal(p8, rp8)
            np.testing.assert_array_equal(v, rv)


def test_reaped_slot_restarts_at_a_steady_tick():
    """A slot closed and reopened mid-stream (full chain, kernel layout)
    serves its new stream like a dedicated chain at that phase, and the
    neighbour slot is not disturbed."""
    rng = np.random.RandomState(9)
    n_ticks, reopen_at = 10, 6
    mics = (rng.randn(n_ticks, 2, PKG) * 3000).astype(np.int16)
    plays = (rng.randn(n_ticks, 2, PKG) * 5000).astype(np.int16)
    srv = _server(2)
    keep, old = srv.open_stream(), srv.open_stream()
    got_keep, got_new = [], []
    new = None
    for t in range(n_ticks):
        if t == reopen_at:
            srv.close_stream(old)
            new = srv.open_stream()
            assert new & 0xFFFF == old & 0xFFFF and new != old
        srv.feed(keep, mics[t, 0], plays[t, 0])
        srv.feed(old if new is None else new, mics[t, 1], plays[t, 1])
        srv.tick()
        got_keep.append(srv.read(keep))
        if new is not None:
            got_new.append(srv.read(new))
    for got, ref in ((got_keep, _ref_chain(0, mics[:, 0], plays[:, 0])),
                     (got_new, _ref_chain(reopen_at, mics[reopen_at:, 1],
                                          plays[reopen_at:, 1]))):
        assert len(got) == len(ref)
        for (o, p8, v), (ro, rp8, rv) in zip(got, ref):
            np.testing.assert_array_equal(o, ro)
            np.testing.assert_array_equal(p8, rp8)
            np.testing.assert_array_equal(v, rv)


def test_slot_reuse_and_generation_guard():
    srv = _server(1, **LANES)
    h1 = srv.open_stream()
    srv.close_stream(h1)
    with pytest.raises(SlotClosed):
        srv.feed(h1, np.zeros(PKG, np.int16))
    h2 = srv.open_stream()
    assert h2 != h1  # generation bumped, same slot
    assert h2 & 0xFFFF == h1 & 0xFFFF and h2 >> 16 == (h1 >> 16) + 1
    srv.feed(h2, np.zeros(PKG, np.int16))
    srv.tick()
    assert srv.read(h2) is not None
    with pytest.raises(RuntimeError, match="no free stream slots"):
        srv.open_stream()  # capacity exhausted
    with pytest.raises(ValueError):
        srv.feed(h2, np.zeros(PKG + 1, np.int16))
    with pytest.raises(SlotClosed):
        srv.feed_batch([h1], np.zeros((1, PKG), np.int16))
    with pytest.raises(SlotClosed):
        srv.read(7 | (1 << 16))     # a slot beyond the capacity


def test_pipelined_fast_lane_matches_sync_tick():
    """tick_pipelined + feed_batch/read_batch (the realtime fast lane)
    must deliver byte-identical outputs, in order, to the blocking
    tick() + feed()/read() path."""
    B, n_ticks, depth = 4, 12, 3
    rng = np.random.RandomState(7)
    mics = (rng.randn(n_ticks, B, PKG) * 2500).astype(np.int16)
    plays = (rng.randn(n_ticks, B, PKG) * 4000).astype(np.int16)

    sync = _server(B, **LANES)
    hs = [sync.open_stream() for _ in range(B)]
    want = []
    for t in range(n_ticks):
        for b, h in enumerate(hs):
            sync.feed(h, mics[t, b], plays[t, b])
        sync.tick()
        want.append([sync.read(h) for h in hs])

    pipe = _server(B, **LANES)
    hp = [pipe.open_stream() for _ in range(B)]
    got = []
    for t in range(n_ticks):
        block = mics[t].copy()
        pipe.feed_batch(hp, block, plays[t])
        block[:] = 0        # the caller may reuse its block at once
        pipe.tick_pipelined(depth)
        r = pipe.read_batch(hp)
        if r is not None:
            got.append(r)
    assert len(got) == n_ticks - depth  # outputs lag by `depth`
    pipe.flush_pipeline()
    while True:
        r = pipe.read_batch(hp)
        if r is None:
            break
        got.append(r)
    assert len(got) == n_ticks

    for t, (o_blk, p8_blk, v_blk) in enumerate(got):
        assert o_blk.dtype == np.int16 and p8_blk.dtype == np.int16
        assert v_blk.dtype == np.int32
        for b in range(B):
            o, p8, v = want[t][b]
            np.testing.assert_array_equal(o_blk[b], o, err_msg=f"t{t}b{b}")
            np.testing.assert_array_equal(p8_blk[b], p8)
            np.testing.assert_array_equal(v_blk[b], v)
    with pytest.raises(ValueError, match="max_depth"):
        pipe.tick_pipelined(pipe.max_depth + 1)


def test_mixed_feed_batch_and_feed_order_preserved():
    """feed_batch blocks spill into per-slot queues when mixed with
    feed(); package order per slot must survive the demotion."""
    B = 2
    rng = np.random.RandomState(3)
    srv = _server(B, **LANES)
    hs = [srv.open_stream() for _ in range(B)]
    blocks = (rng.randn(3, B, PKG) * 2000).astype(np.int16)
    srv.feed_batch(hs, blocks[0])          # fast lane
    srv.feed(hs[0], blocks[1][0])          # forces spill of block 0
    srv.feed(hs[1], blocks[1][1])
    srv.feed_batch(hs, blocks[2])          # queues non-empty: slow path

    ref = _server(B, **LANES)
    hr = [ref.open_stream() for _ in range(B)]
    for t in range(3):
        for b in range(B):
            ref.feed(hr[b], blocks[t][b])

    for t in range(3):
        srv.tick()
        ref.tick()
        for b in range(B):
            got, want = srv.read(hs[b]), ref.read(hr[b])
            for j in range(3):
                np.testing.assert_array_equal(got[j], want[j],
                                              err_msg=f"t{t}b{b}")


def test_drain_thread_matches_inline_drain():
    """start_drain_thread(): outputs must be identical and in order vs
    the inline-drain pipelined path; the drainer only moves the wait for
    the copies off the pump thread."""
    B, n_ticks, depth = 4, 12, 3
    rng = np.random.RandomState(11)
    mics = (rng.randn(n_ticks, B, PKG) * 2500).astype(np.int16)
    plays = (rng.randn(n_ticks, B, PKG) * 4000).astype(np.int16)

    inline = _server(B, **LANES)
    hi = [inline.open_stream() for _ in range(B)]
    want = []
    for t in range(n_ticks):
        inline.feed_batch(hi, mics[t], plays[t])
        inline.tick_pipelined(depth)
    inline.flush_pipeline()
    while True:
        r = inline.read_batch(hi)
        if r is None:
            break
        want.append(r)
    assert len(want) == n_ticks

    threaded = _server(B, **LANES)
    ht = [threaded.open_stream() for _ in range(B)]
    threaded.start_drain_thread()
    drainer = threaded._drainer
    got = []
    for t in range(n_ticks):
        threaded.feed_batch(ht, mics[t], plays[t])
        threaded.tick_pipelined(depth)
        r = threaded.read_batch(ht)
        if r is not None:
            got.append(r)
    threaded.flush_pipeline()
    while True:
        r = threaded.read_batch(ht)
        if r is None:
            break
        got.append(r)
    threaded.stop_drain_thread()
    assert not drainer.is_alive() and threaded._drainer is None
    assert len(got) == n_ticks

    for t in range(n_ticks):
        for j in range(3):
            np.testing.assert_array_equal(got[t][j], want[t][j],
                                          err_msg=f"tick {t} part {j}")


def test_tick_chunk_matches_ticks():
    """K packages in one call give what K ticks give."""
    B, K = 2, 3
    rng = np.random.RandomState(13)
    mics = (rng.randn(K, B, PKG) * 2500).astype(np.int16)
    one, many = _server(B, **LANES), _server(B, **LANES)
    ho = [one.open_stream() for _ in range(B)]
    hm = [many.open_stream() for _ in range(B)]
    for t in range(K):
        for b in range(B):
            one.feed(ho[b], mics[t, b])
            many.feed(hm[b], mics[t, b])
        one.tick()
    many.tick_chunk(K)
    for t in range(K):
        for b in range(B):
            got, want = many.read(hm[b]), one.read(ho[b])
            for j in range(3):
                np.testing.assert_array_equal(got[j], want[j])
    assert many.read(hm[0]) is None


def test_server_defaults_to_the_card():
    """Without a `device` the server asks for the card and raises where
    there is none; it never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamServer(2, FREQ)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PinnedRing([((2, 4), torch.int16)], 2)


def test_cpu_staging_copies():
    """On the CPU the staging ring pins nothing; what it hands out is
    independent of the caller's arrays and of the tensors it was given."""
    ring = PinnedRing([((2, 4), torch.int16)], 2, device="cpu")
    assert ring.nbytes == 0
    a = np.arange(8, dtype=np.int16).reshape(2, 4)
    (t,) = ring.upload([a])
    a[:] = -1
    assert t.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    src = torch.arange(8, dtype=torch.int16).reshape(2, 4)
    pending = ring.download([src])
    src.zero_()
    np.testing.assert_array_equal(np.asarray(pending),
                                  np.arange(8).reshape(2, 4))
    assert pending.result()[0].dtype == np.int16
