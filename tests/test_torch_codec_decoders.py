"""wmix_tpu_torch's batch decoders (`codecs/mp3_batch.py`
`Mp3BatchDecoder`, `codecs/aac_batch.py` `AacBatchDecoder`) against
wmix_tpu's host decoders, frame for frame and bit for bit, on the streams
stored under tests/data (`tools/gen_torch_codec_streams.py`): AAC-LC at
44.1 kHz stereo (with short blocks) and 32 kHz mono, an 8 kHz stream the
batch path refuses, Layer II, and seeded Layer III frames.  The port runs
on the CPU.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu_torch.codecs.aac_batch import AacBatchDecoder  # noqa: E402
from wmix_tpu_torch.codecs.mp3_batch import Mp3BatchDecoder  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _stream(name):
    with open(os.path.join(DATA, "torch_codec_" + name), "rb") as f:
        return f.read()


def _aac_host(data):
    """The reference's AacDecoder over the whole stream: the PCM of every
    frame that emits (faad suppresses the first)."""
    from wmix_tpu.codecs.aac import AacDecoder
    dec = AacDecoder()
    pos, out = 0, []
    while pos + 7 <= len(data):
        pcm, consumed, _nch, _freq = dec.decode(data[pos:])
        if consumed == 0:
            break
        pos += consumed
        if pcm.size:
            out.append(pcm)
    return out


def _run(dec, streams, starts):
    """Start stream b's data at tick starts[b]; tick until every stream
    has finished.  Returns ({stream: [pcm per emitted frame]}, {stream:
    tick it finished in})."""
    got = {b: [] for b in range(len(streams))}
    done_at = {}
    t = 0
    while len(done_at) < len(streams):
        for b, s in enumerate(starts):
            if t == s:
                dec.start(b, streams[b])
        pcms, done = dec.tick()
        if isinstance(pcms, dict):
            for b, pcm in pcms.items():
                got[b].append(pcm)
        elif pcms is not None:
            for b in range(len(streams)):
                if b not in done_at and b not in done and t >= starts[b]:
                    got[b].append(pcms[b])
        for b in done:
            done_at[b] = t
        t += 1
        assert t < 1000
    return got, done_at


@pytest.mark.parametrize("name", ["aac_44k_stereo.aac", "aac_32k_mono.aac"])
def test_aac_batch_decoder_staggered(name):
    """Three concurrent decodes of one stream, started at ticks 0, 2 and
    5, against the host decoder: every emitted frame equal (mono streams
    come out upmatrixed to two channels, as the reference's)."""
    data = _stream(name)
    want = _aac_host(data)
    got, done_at = _run(AacBatchDecoder(3, device="cpu"), [data] * 3,
                        [0, 2, 5])
    for b in range(3):
        assert len(got[b]) == len(want) > 50
        for i, (g, w) in enumerate(zip(got[b], want)):
            np.testing.assert_array_equal(g, w, err_msg=f"s{b} frame {i}")
    assert done_at[2] - done_at[0] == 5


def test_aac_batch_decoder_mixed_streams():
    """Different streams share the tick (stereo with short blocks beside
    mono, so several window groups per tick); the 8 kHz stream, which the
    reference decodes through its SBR path, is refused by both front-ends
    and ends in the tick it started, without output."""
    stereo, mono, low = (_stream(n) for n in ("aac_44k_stereo.aac",
                                              "aac_32k_mono.aac",
                                              "aac_8k_mono.aac"))
    dec = AacBatchDecoder(4, device="cpu")
    got, done_at = _run(dec, [stereo, mono, low, stereo], [0, 1, 1, 3])
    assert got[2] == [] and done_at[2] == 1
    for b, data in ((0, stereo), (1, mono), (3, stereo)):
        want = _aac_host(data)
        assert len(got[b]) == len(want)
        for i, (g, w) in enumerate(zip(got[b], want)):
            np.testing.assert_array_equal(g, w, err_msg=f"s{b} frame {i}")


def _mp3_host(data, n=None):
    from wmix_tpu.codecs.mp3 import Mp3Decoder
    return [pcm for pcm, _rate, _nch in Mp3Decoder().frames(data, n)]


def test_mp3_batch_decoder_layer2_fallback():
    """The Layer II stream goes through the Python front-end (the native
    one refuses it) and equals the reference's decoder."""
    data = _stream("mp3_l2.mp3")
    want = _mp3_host(data)
    got, _done = _run(Mp3BatchDecoder(2, device="cpu"), [data] * 2, [0, 3])
    for b in range(2):
        assert len(got[b]) == len(want) == 24
        for i, (g, w) in enumerate(zip(got[b], want)):
            np.testing.assert_array_equal(g, w, err_msg=f"s{b} frame {i}")


@pytest.mark.parametrize("native", [True, False], ids=["mp3fe", "python"])
def test_mp3_batch_decoder_layer3(native, monkeypatch):
    """The seeded Layer III frames through the native front-end and, with
    WMIX_MP3FE=0, through the Python one: three staggered streams equal to
    the reference's decoder (Huffman to PCM) on every frame."""
    from wmix_tpu_torch.codecs import mp3fe
    if not native:
        monkeypatch.setenv("WMIX_MP3FE", "0")
    assert mp3fe.available() == native
    data = _stream("mp3_l3.mp3")
    want = _mp3_host(data)
    got, _done = _run(Mp3BatchDecoder(3, device="cpu"), [data] * 3,
                      [0, 1, 4])
    for b in range(3):
        assert len(got[b]) == len(want) == 80
        for i, (g, w) in enumerate(zip(got[b], want)):
            np.testing.assert_array_equal(g, w, err_msg=f"s{b} frame {i}")


def test_mp3_batch_decoder_against_jax_batch_decoder():
    """The reference's own batch decoder on the Layer III frames: the
    same PCM array every tick, the same finished lists."""
    from wmix_tpu.codecs.mp3_batch import Mp3BatchDecoder as Ref
    data = _stream("mp3_l3.mp3")[:417 * 12 + 16]
    ref, port = Ref(2), Mp3BatchDecoder(2, device="cpu")
    for d in (ref, port):
        d.start(0, data)
        d.start(1, data[417 * 3:])
    while True:
        (pw, dw), (pg, dg) = ref.tick(), port.tick()
        assert dg == dw
        if pw is None:
            assert pg is None
            break
        np.testing.assert_array_equal(pg, np.asarray(pw))
