"""wmix_tpu_torch's batched AAC-LC filterbank (`codecs/aac_batch.py`
`imdct`, `BatchedFilterbank`) against wmix_tpu's host numpy path
(`faad_imdct`, `ifilter_bank`, itself bit-exact against faad2) and, on
two window combinations, its jitted `BatchedFilterbank`.  Every
comparison is equality of the float32 bits.

Spectra are seeded numpy arrays handed to both packages; the port runs on
the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu.codecs.aac import faad_imdct, ifilter_bank  # noqa: E402
from wmix_tpu_torch.codecs.aac_batch import (BatchedFilterbank,  # noqa: E402
                                             imdct)

# the ten-frame window walk of tests/test_aac_batch.py: every sequence
# (0 long, 1 start, 2 eight short, 3 stop), both shapes (0 sine, 1 KBD),
# every transition between them
WALK = [(0, 0), (1, 0), (2, 1), (2, 1), (3, 0), (0, 0), (1, 1), (2, 0),
        (3, 1), (0, 1)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


class _Host:
    """Per-slot host filterbank state, as AacDecoder keeps it."""

    def __init__(self, slots):
        self.ov = [np.zeros(1024, np.float32) for _ in range(slots)]
        self.prev = [0] * slots

    def run(self, slot, seq, shape, spec):
        out, self.ov[slot] = ifilter_bank(seq, shape, self.prev[slot], spec,
                                          self.ov[slot])
        self.prev[slot] = shape
        return out


@pytest.mark.parametrize("N", [2048, 256])
def test_imdct_matches_host(N):
    rng = np.random.RandomState(N)
    x = (rng.randn(5, N // 2) * 100).astype(np.float32)
    x[4] = 0.0
    x[3, ::7] = -0.0
    want = np.stack([faad_imdct(N, x[i]) for i in range(5)])
    _eq(imdct(N, torch.from_numpy(x)), want)


def test_window_walk_matches_host():
    """Every sequence and shape over the walk, all slots at once, against
    ifilter_bank: time_out, overlap and shape_prev after every frame."""
    rng = np.random.RandomState(1)
    B = 3
    fb = BatchedFilterbank(B, device="cpu")
    host = _Host(B)
    for t, (seq, shape) in enumerate(WALK):
        specs = (rng.randn(B, 1024) * 50).astype(np.float32)
        outs = fb.frame([(b, seq, shape, specs[b]) for b in range(B)])
        for b in range(B):
            _eq(outs[b], host.run(b, seq, shape, specs[b]),
                f"frame {t} slot {b}")
            _eq(fb.overlap[b], host.ov[b], f"overlap, frame {t} slot {b}")
        assert fb.shape_prev.tolist() == host.prev


def test_frame_with_mixed_groups():
    """One tick with slots in three (sequence, shape, prev) groups and an
    idle slot: each group runs on its own and the idle slot keeps its
    state."""
    rng = np.random.RandomState(2)
    S = 6
    fb = BatchedFilterbank(S, device="cpu")
    host = _Host(S)
    ticks = [
        [(0, 0, 0), (1, 0, 0), (2, 0, 1), (3, 0, 1), (4, 1, 0), (5, 0, 0)],
        [(0, 1, 1), (1, 2, 0), (2, 0, 0), (3, 1, 0), (4, 2, 1)],
        [(0, 2, 1), (1, 3, 1), (2, 1, 1), (4, 3, 0), (5, 1, 0)],
        [(0, 3, 0), (1, 0, 0), (2, 2, 1), (3, 2, 1), (4, 0, 0), (5, 2, 1)],
    ]
    for t, jobs in enumerate(ticks):
        specs = (rng.randn(S, 1024) * 80).astype(np.float32)
        outs = fb.frame([(s, seq, sh, specs[s]) for s, seq, sh in jobs])
        assert sorted(outs) == sorted(s for s, _, _ in jobs)
        for s, seq, sh in jobs:
            _eq(outs[s], host.run(s, seq, sh, specs[s]), f"tick {t} slot {s}")
        for s in range(S):
            _eq(fb.overlap[s], host.ov[s], f"overlap, tick {t} slot {s}")
        assert fb.shape_prev.tolist() == host.prev


def test_frame_stacked_equals_frame():
    rng = np.random.RandomState(3)
    a = BatchedFilterbank(4, device="cpu")
    b = BatchedFilterbank(4, device="cpu")
    for seq, shape in WALK[:5]:
        specs = (rng.randn(3, 1024) * 50).astype(np.float32)
        got = a.frame_stacked([0, 2, 3], seq, shape, specs)
        want = b.frame([(s, seq, shape, specs[j])
                        for j, s in enumerate([0, 2, 3])])
        for j, s in enumerate([0, 2, 3]):
            _eq(got[j], want[s])
    _eq(a.overlap, b.overlap.numpy())
    a.frame_stacked([1], 0, 1, specs[:1])
    with pytest.raises(ValueError, match="mixed shape_prev"):
        a.frame_stacked([0, 1], 0, 0, specs[:2])


@pytest.mark.parametrize("seq,shape,prev", [(0, 0, 1), (2, 1, 0)])
def test_against_jax_batched_filterbank(seq, shape, prev):
    """One long and one eight-short combination against the reference's
    jitted filterbank (two programs, to bound the compile time)."""
    from wmix_tpu.codecs.aac_batch import BatchedFilterbank as JaxFb
    rng = np.random.RandomState(4 + seq)
    B = 3
    ref = JaxFb(B)
    port = BatchedFilterbank(B, device="cpu")
    ov = (rng.randn(B, 1024) * 30).astype(np.float32)
    ref.overlap = ref.overlap.at[:].set(ov)
    ref.shape_prev[:] = prev
    port.load_state(ov, np.full(B, prev))
    specs = (rng.randn(B, 1024) * 50).astype(np.float32)
    jobs = [(b, seq, shape, specs[b]) for b in range(B)]
    want = ref.frame(jobs)
    got = port.frame(jobs)
    for b in range(B):
        _eq(got[b], want[b], f"slot {b}")
    _eq(port.overlap, np.asarray(ref.overlap))
    np.testing.assert_array_equal(port.shape_prev.numpy(), ref.shape_prev)


def test_load_state_carried_across():
    """The host filterbank runs half the walk; its overlap and shapes,
    loaded into the port, continue as the host continues."""
    rng = np.random.RandomState(5)
    B = 2
    host = _Host(B)
    for seq, shape in WALK[:5]:
        specs = (rng.randn(B, 1024) * 50).astype(np.float32)
        for b in range(B):
            host.run(b, seq, shape, specs[b])
    port = BatchedFilterbank(B, device="cpu")
    ptrs = (port.overlap.data_ptr(), port.shape_prev.data_ptr())
    port.load_state(np.stack(host.ov), host.prev)
    for seq, shape in WALK[5:]:
        specs = (rng.randn(B, 1024) * 50).astype(np.float32)
        outs = port.frame([(b, seq, shape, specs[b]) for b in range(B)])
        for b in range(B):
            _eq(outs[b], host.run(b, seq, shape, specs[b]))
    _eq(port.overlap, np.stack(host.ov))
    assert (port.overlap.data_ptr(), port.shape_prev.data_ptr()) == ptrs


def test_reset_clears_slots_in_place():
    rng = np.random.RandomState(6)
    fb = BatchedFilterbank(4, device="cpu")
    ptr = fb.overlap.data_ptr()
    specs = (rng.randn(4, 1024) * 50).astype(np.float32)
    fb.frame([(s, 0, 1, specs[s]) for s in range(4)])
    fb.reset([1, 2])
    assert fb.overlap.data_ptr() == ptr
    assert not fb.overlap[1:3].any() and fb.overlap[0].any()
    assert fb.shape_prev.tolist() == [1, 0, 0, 1]
