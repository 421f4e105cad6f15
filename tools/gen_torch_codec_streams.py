"""Coded streams for the port's batched MP3 and AAC decoders.

    python tools/gen_torch_codec_streams.py [name ...]

writes `tests/data/torch_codec_<name>` for each stream of `STREAMS` (all
of them without arguments), made from a seed with `wmix_tpu`'s own tools,
since the repository holds no coded audio:

  * `aac_44k_stereo.aac` (1.5 s), `aac_32k_mono.aac` (2 s): AAC-LC ADTS
    from `wmix_tpu.codecs.aacenc` of tones and noise; the stereo stream
    has clicks that make the encoder switch to short blocks (every window
    sequence occurs);
  * `aac_8k_mono.aac` (1 s): the same at 8 kHz.  At 24 kHz and below the
    reference's decoder upsamples through its SBR path (implicit
    signalling), which the batched filterbank does not take: the batch
    decoder ends such a stream in its first tick;
  * `mp3_l2.mp3`: Layer II frames with seeded payloads
    (`tests/test_mp3_l12.py` `_stream`; every such frame is valid);
  * `mp3_l3.mp3`: MPEG-1 Layer III frames, 44.1 kHz joint stereo, with
    valid headers, seeded side information (main_data_begin 0, so each
    frame carries its own main data) and seeded main data.  There is no
    Layer III encoder in the repository; a candidate frame is kept only
    when `wmix_tpu.codecs.mp3.Mp3Decoder`'s Python front-end decodes it
    alone to a nonzero `sbsample`, so the Huffman, requantize, stereo and
    IMDCT paths all do real work.  The kept frames are checked again as
    one stream.

`chip_smoke.py` phase 15 and `tests/test_torch_codec_*.py` read the
files; a test there marked `slow` runs this generator again and compares
the bytes.  About ten CPU-seconds for all five.
"""
from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "tests", "data")
PREFIX = "torch_codec_"


def _aac(pcm: np.ndarray, chn: int, freq: int) -> bytes:
    from wmix_tpu.codecs import aacenc
    enc = None
    out = b""
    step = 1024 * chn
    for i in range(0, pcm.size - step + 1, step):
        enc, blob = aacenc.aac_encode(enc, pcm[i:i + step].tobytes(), chn,
                                      freq)
        out += blob
    return out


def _tones(freq: int, seconds: float, seed: int, clicks: bool):
    """(left, right) float signals: three tones, noise, and (`clicks`) a
    full-scale click every seventh frame of the left channel."""
    rng = np.random.RandomState(seed)
    n = int(freq * seconds)
    t = np.arange(n) / freq
    sig = sum(np.sin(2 * np.pi * f * t + p) * a
              for f, p, a in [(220, 0, 6000), (660, 1, 3000), (1800, 2, 1500)])
    left = sig + rng.randn(n) * 300
    right = sig * 0.6 + rng.randn(n) * 300
    if clicks:
        for k in range(5, n // 1024, 7):
            left[k * 1024 + 37:k * 1024 + 101] = 28000
    return left, right


def _i16(x):
    return np.clip(x, -32768, 32767).astype(np.int16)


def aac_44k_stereo() -> bytes:
    left, right = _tones(44100, 1.5, seed=3, clicks=True)
    pcm = np.empty(left.size * 2, np.int16)
    pcm[0::2] = _i16(left)
    pcm[1::2] = _i16(right)
    return _aac(pcm, 2, 44100)


def aac_32k_mono() -> bytes:
    left, _right = _tones(32000, 2.0, seed=4, clicks=False)
    return _aac(_i16(left), 1, 32000)


def aac_8k_mono() -> bytes:
    left, _right = _tones(8000, 1.0, seed=5, clicks=False)
    return _aac(_i16(left), 1, 8000)


def mp3_l2() -> bytes:
    sys.path.insert(0, REPO)
    from tests.test_mp3_l12 import _stream
    # 112 kbit/s, 44.1 kHz, stereo, 24 frames
    return _stream(2, 8, 0, 0, frames=24, seed=7)


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, v: int, n: int) -> None:
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def tobytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(np.packbits(np.asarray(bits, np.uint8)))


L3_BITRATE_IDX, L3_BITRATE = 9, 128000          # 128 kbit/s
L3_RATE = 44100
L3_FRAME = 144 * L3_BITRATE // L3_RATE          # 417 bytes, no padding
L3_SIDE = 32                                    # MPEG-1 stereo side info
L3_GUARD = 16


def _table(rng) -> int:
    """A Huffman pair table that exists (4 and 14 do not)."""
    return int(rng.choice([t for t in range(32) if t not in (4, 14)]))


def _l3_frame(rng) -> bytes:
    """One MPEG-1 Layer III joint-stereo frame at 128 kbit/s, 44.1 kHz:
    header, seeded side information, seeded main data."""
    w = _BitWriter()
    w.put(0x7FF, 11)
    w.put(1, 1)                 # MPEG-1
    w.put(1, 1)
    w.put(1, 2)                 # Layer III
    w.put(1, 1)                 # no CRC
    w.put(L3_BITRATE_IDX, 4)
    w.put(0, 2)                 # 44.1 kHz
    w.put(0, 1)                 # no padding
    w.put(0, 1)
    w.put(1, 2)                 # joint stereo
    w.put(int(rng.randint(4)), 2)       # mode extension: MS and intensity
    w.put(0, 4)                 # copyright, original, emphasis
    avail = (L3_FRAME - 4 - L3_SIDE) * 8
    w.put(0, 9)                 # main_data_begin
    w.put(0, 3)                 # private bits
    w.put(0, 8)                 # scfsi, both channels
    for _gr in range(2):
        for _ch in range(2):
            part23 = int(rng.randint(avail // 8, avail // 4))
            w.put(part23, 12)
            # a Huffman pair takes several bits: big_values must not run
            # the pairs past part2_3_length
            w.put(int(rng.randint(0, part23 // 12 + 1)), 9)
            w.put(int(rng.randint(120, 200)), 8)        # global_gain
            w.put(int(rng.randint(16)), 4)              # scalefac_compress
            if rng.rand() < 0.3:                        # window switching
                w.put(1, 1)
                w.put(int(rng.randint(1, 4)), 2)        # block_type
                w.put(int(rng.rand() < 0.3), 1)         # mixed
                for _ in range(2):
                    w.put(_table(rng), 5)
                for _ in range(3):
                    w.put(int(rng.randint(8)), 3)
            else:
                w.put(0, 1)
                for _ in range(3):
                    w.put(_table(rng), 5)
                w.put(int(rng.randint(16)), 4)
                w.put(int(rng.randint(8)), 3)
            w.put(int(rng.randint(8)), 3)   # preflag, sf scale, count1tab
    head = w.tobytes()
    assert len(head) == 4 + L3_SIDE
    return head + bytes(rng.randint(0, 256, L3_FRAME - len(head),
                                    dtype=np.uint8))


def _sbsamples(data: bytes) -> list:
    from wmix_tpu.codecs.mp3 import Mp3Decoder
    return [sb for _h, sb in Mp3Decoder()._frames_sbsample(data)]


def mp3_l3(n_frames: int = 80, seed: int = 11) -> bytes:
    rng = np.random.RandomState(seed)
    kept = []
    while len(kept) < n_frames:
        frame = _l3_frame(rng)
        sbs = _sbsamples(frame + b"\0" * L3_GUARD)
        if len(sbs) == 1 and np.any(sbs[0]):
            kept.append(frame)
    data = b"".join(kept) + b"\0" * L3_GUARD
    sbs = _sbsamples(data)
    if len(sbs) != n_frames or not all(np.any(sb) for sb in sbs):
        raise RuntimeError("a kept Layer III frame does not decode in the "
                           "stream")
    return data


STREAMS = {
    "aac_44k_stereo.aac": aac_44k_stereo,
    "aac_32k_mono.aac": aac_32k_mono,
    "aac_8k_mono.aac": aac_8k_mono,
    "mp3_l2.mp3": mp3_l2,
    "mp3_l3.mp3": mp3_l3,
}


def path(name: str) -> str:
    return os.path.join(DATA_DIR, PREFIX + name)


def main(names) -> None:
    for name in names or STREAMS:
        data = STREAMS[name]()
        with open(path(name), "wb") as f:
            f.write(data)
        print(f"{path(name)}: {len(data)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
