"""wmix_tpu_torch's batched MP3 synthesis (`codecs/mp3_batch.py`
`BatchedSynth`, `dct32`) against wmix_tpu's: the host `Synth` with
`mad_scale` (itself bit-exact against libmad), once its jitted
`BatchedSynth`, and the numpy branch of its `dct32`.  Every comparison is
equality of the int16 PCM and of the int32 state.

Inputs are seeded numpy arrays handed to both packages; the port runs on
the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu.codecs.mp3 import Synth, mad_scale  # noqa: E402
from wmix_tpu_torch.codecs.mp3_batch import BatchedSynth  # noqa: E402

Q28 = 1 << 28


def _sb(rng, B, ns=36, lo=-Q28, hi=Q28):
    return rng.randint(lo, hi, size=(B, 2, ns, 32)).astype(np.int32)


def _host_frames(hosts, sb, nch, ns):
    return [mad_scale(h.frame(sb[b], nch, ns)) for b, h in enumerate(hosts)]


@pytest.mark.parametrize("nch,ns", [(2, 36), (1, 36), (2, 18), (1, 12)])
def test_batched_synth_random_frames(nch, ns):
    """Seeded Q28 subband frames at the geometries of MPEG-1 Layer II/III
    (36 slots), LSF Layer III (18) and Layer I (12), phases advancing."""
    rng = np.random.RandomState(ns + nch)
    B = 3
    hosts = [Synth() for _ in range(B)]
    port = BatchedSynth(B, device="cpu")
    for frame in range(4):
        sb = _sb(rng, B, ns)
        got = port.frame(sb, nch, ns).numpy()
        assert got.shape == (B, nch, 32 * ns) and got.dtype == np.int16
        for b, want in enumerate(_host_frames(hosts, sb, nch, ns)):
            np.testing.assert_array_equal(
                got[b], want, err_msg=f"frame {frame} stream {b}")
    for b in range(B):
        assert int(port.phase[b]) == hosts[b].phase


def test_batched_synth_mixed_phases():
    """Streams at different phases (a reset after two frames) share one
    program; stereo frames, then mono frames on the same state."""
    rng = np.random.RandomState(1)
    B = 4
    hosts = [Synth() for _ in range(B)]
    port = BatchedSynth(B, device="cpu")
    for frame, (nch, ns) in enumerate([(2, 36), (2, 36), (2, 12), (2, 36),
                                       (1, 36), (1, 18)]):
        sb = _sb(rng, B, ns)
        if frame == 2:
            hosts[1] = Synth()
            hosts[3] = Synth()
            port.reset([1, 3])
        got = port.frame(sb, nch, ns).numpy()
        for b, want in enumerate(_host_frames(hosts, sb, nch, ns)):
            np.testing.assert_array_equal(got[b], want,
                                          err_msg=f"f{frame} s{b}")
    assert sorted(set(int(p) for p in port.phase)) == \
        sorted(set(h.phase for h in hosts))


@pytest.mark.parametrize("fill", ["edges", "max", "min"])
def test_batched_synth_at_the_q28_range(fill):
    """Subband samples at and next to +-2^28, where the MACs wrap."""
    rng = np.random.RandomState(7)
    B, nch, ns = 2, 2, 36
    edges = np.array([Q28 - 1, -Q28, Q28, -Q28 + 1, 0, 1, -1], np.int64)
    hosts = [Synth() for _ in range(B)]
    port = BatchedSynth(B, device="cpu")
    for frame in range(3):
        if fill == "edges":
            sb = rng.choice(edges, size=(B, 2, ns, 32))
        else:
            sb = np.full((B, 2, ns, 32), Q28 - 1 if fill == "max" else -Q28)
            sb[:, :, frame::3, ::2] *= -1
        sb = sb.astype(np.int32)
        got = port.frame(sb, nch, ns).numpy()
        for b, want in enumerate(_host_frames(hosts, sb, nch, ns)):
            np.testing.assert_array_equal(got[b], want,
                                          err_msg=f"f{frame} s{b}")


def test_dct32_full_range_int32():
    """The torch branch of the copied SSA against the numpy branch of the
    reference's, on full-range int32 inputs (the MULs and sums wrap)."""
    from wmix_tpu.codecs._mp3_dct32 import dct32 as dct32_ref
    from wmix_tpu_torch.codecs._mp3_dct32 import dct32
    rng = np.random.RandomState(3)
    x = rng.randint(-2**31, 2**31, size=(32, 4096), dtype=np.int64)
    x[:, :4] = [2**31 - 1, -2**31, 0, -1]
    x = x.astype(np.int32)
    with np.errstate(over="ignore"):
        hi_ref, lo_ref = dct32_ref(x)
    hi, lo = dct32(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.int32
    np.testing.assert_array_equal(hi.numpy(), hi_ref)
    np.testing.assert_array_equal(lo.numpy(), lo_ref)


def test_against_jax_batched_synth():
    """Two stereo frames against the reference's jitted BatchedSynth:
    PCM, filter history and phase."""
    from wmix_tpu.codecs.mp3_batch import BatchedSynth as JaxSynth
    rng = np.random.RandomState(5)
    B = 3
    ref = JaxSynth(B)
    port = BatchedSynth(B, device="cpu")
    for frame in range(2):
        sb = _sb(rng, B)
        want = np.asarray(ref.frame(sb, 2, 36))
        np.testing.assert_array_equal(port.frame(sb, 2, 36).numpy(), want,
                                      err_msg=f"frame {frame}")
    np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))
    np.testing.assert_array_equal(port.phase.numpy(), ref.phase)


def test_load_state_carried_across():
    """Host synths run three frames; their FIFOs, carried into the port's
    history layout, continue in the port as in the host."""
    from wmix_tpu.codecs.mp3_batch import BatchedSynth as JaxSynth
    rng = np.random.RandomState(6)
    B = 2
    ref = JaxSynth(B)
    hosts = [Synth() for _ in range(B)]
    for frame in range(3):
        sb = _sb(rng, B)
        np.asarray(ref.frame(sb, 2, 36))
        _host_frames(hosts, sb, 2, 36)
    port = BatchedSynth(B, device="cpu")
    port.load_state(np.asarray(ref.hist), ref.phase)
    for frame in range(3):
        sb = _sb(rng, B, lo=-Q28 // 4, hi=Q28 // 4)
        got = port.frame(sb, 2, 36).numpy()
        want_j = np.asarray(ref.frame(sb, 2, 36))
        np.testing.assert_array_equal(got, want_j)
        for b, want in enumerate(_host_frames(hosts, sb, 2, 36)):
            np.testing.assert_array_equal(got[b], want,
                                          err_msg=f"f{frame} s{b}")
    np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))


def test_slot_of_a_batch_equals_a_lone_stream():
    """Stream 1 of a B = 3 run equals a B = 1 run on its inputs."""
    rng = np.random.RandomState(8)
    three = BatchedSynth(3, device="cpu")
    one = BatchedSynth(1, device="cpu")
    for frame in range(3):
        sb = _sb(rng, 3)
        got = three.frame(sb, 2, 36).numpy()
        alone = one.frame(sb[1:2], 2, 36).numpy()
        np.testing.assert_array_equal(got[1], alone[0])
    np.testing.assert_array_equal(three.hist[1].numpy(), one.hist[0].numpy())


def test_state_stays_in_place():
    """`hist` and `phase` are updated in place: frame, reset and
    load_state keep the tensors (and their storage)."""
    rng = np.random.RandomState(9)
    port = BatchedSynth(2, device="cpu")
    ptrs = (port.hist.data_ptr(), port.phase.data_ptr())
    port.frame(_sb(rng, 2), 2, 36)
    port.reset([0])
    assert int(port.phase[0]) == 0 and int(port.phase[1]) == 4
    assert not port.hist[0].any() and port.hist[1].any()
    port.load_state(np.zeros((2, 2, 2, 16, 16), np.int32), [3, 5])
    assert (port.hist.data_ptr(), port.phase.data_ptr()) == ptrs
    assert port.phase.tolist() == [3, 5]
