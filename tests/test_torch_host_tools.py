"""The host tools that wmix_tpu_torch keeps as copies of wmix_tpu's, held to
their originals: the display FFT (`ops/mathfft.py`), the framebuffer wave
display (`ui/`) and the stand-alone RTP senders and receivers
(`tools/rtp_pcm.py`, `tools/rtp_aac.py`).  Every module's text is equal
but for the lines that name the package; the FFT's outputs are equal bit
for bit at every entry point, the BMP bytes and rendered frames equal, and
each package's RTP sender is heard by the other package's receiver over
loopback UDP, the two receivers writing equal files.
"""
import os
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tests.test_torch_codec_copies import _assert_copy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = ["ops/mathfft.py", "ui/__init__.py", "ui/bmp.py", "ui/fbmap.py",
          "ui/wave.py", "tools/__init__.py", "tools/rtp_pcm.py",
          "tools/rtp_aac.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equal_but_the_package_name(rel):
    changed = _assert_copy(rel)
    if rel in ("ops/mathfft.py", "ui/bmp.py", "ui/__init__.py",
               "tools/__init__.py"):
        assert changed == 0


# ------------------------------------------------------------- mathfft

def _bits_equal(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32, what
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


@pytest.mark.parametrize("N", [8, 64, 256, 1024])
def test_mathfft_entry_points_bit_equal(N):
    from wmix_tpu.ops import mathfft as J
    from wmix_tpu_torch.ops import mathfft as T
    rng = np.random.RandomState(N)
    re = (rng.randn(N) * 1000).astype(np.float32)
    im = (rng.randn(N) * 500).astype(np.float32)
    calls = [("fft", (re, im, N), dict(want_af=True, want_pf=True)),
             ("fft", (re,), {}),
             ("fft", (re, None, N), dict(want_af=True)),
             ("ifft", (re, im, N), {}),
             ("ifft", (re,), {}),
             ("fftr", (re, None, N), dict(want_af=True, want_pf=True)),
             ("fftr", (re,), {}),
             ("ifftr", (re, im, N), {}),
             ("ifftr", (re,), {})]
    for name, args, kw in calls:
        a = getattr(J, name)(*args, **kw)
        b = getattr(T, name)(*args, **kw)
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            _bits_equal(x, y, f"{name} N={N} {sorted(kw)} output {i}")


@pytest.mark.parametrize("st_len,in_len", [(256, 64), (128, 32),
                                           (256, 128)])
def test_mathfft_stream_bit_equal(st_len, in_len):
    """fft_stream over several calls, its pool carried by each package:
    the pools and every (af, pf) equal, with and without the phase."""
    from wmix_tpu.ops import mathfft as J
    from wmix_tpu_torch.ops import mathfft as T
    rng = np.random.RandomState(st_len + in_len)
    pools = [np.zeros(st_len, np.float32) for _ in range(2)]
    for k in range(5):
        block = (rng.randn(in_len) * 3000).astype(np.float32)
        want_pf = k % 2 == 0
        a = J.fft_stream(block, pools[0], want_pf=want_pf)
        b = T.fft_stream(block, pools[1], want_pf=want_pf)
        _bits_equal(pools[0], pools[1], f"pool after call {k}")
        for i, (x, y) in enumerate(zip(a, b)):
            _bits_equal(x, y, f"call {k} output {i}")


# ------------------------------------------------------------------ ui

@pytest.mark.parametrize("w,h", [(64, 32), (63, 17), (62, 9), (40, -20)])
def test_bmp_bytes_equal(w, h, tmp_path):
    from wmix_tpu.ui import bmp as J
    from wmix_tpu_torch.ui import bmp as T
    data = np.random.RandomState(abs(w * h)).randint(
        0, 256, abs(h) * w * 3, dtype=np.uint8)
    a = J.create(str(tmp_path / "j.bmp"), data, w, h, 3)
    b = T.create(str(tmp_path / "t.bmp"), data, w, h, 3)
    assert a == b
    assert (tmp_path / "j.bmp").read_bytes() == \
        (tmp_path / "t.bmp").read_bytes()
    for src in (a, str(tmp_path / "t.bmp")):
        ga, gb = J.get(src), T.get(src)
        np.testing.assert_array_equal(ga[0], gb[0])
        assert ga[1:] == gb[1:]
    assert T.create2(7, str(tmp_path), data, w, abs(h)) == \
        str(tmp_path / "0007.bmp")
    assert (tmp_path / "0007.bmp").read_bytes() == \
        J.create(None, data, w, abs(h), 3)


def _waves(mod_wave, w, h, frames, seed):
    """A Wave fed seeded samples on every channel, `output()` once a
    frame; the rendered map after each frame."""
    wave = mod_wave.Wave(0, 0, w, h)
    rng = np.random.RandomState(seed)
    maps = []
    for _ in range(frames):
        for c in range(mod_wave.WAVE_CHN):
            wave.load(c, int(rng.randint(-32768, 32768)))
        wave.output()
        maps.append(wave.map.copy())
    return maps


@pytest.mark.parametrize("fb", ["file", "none"])
def test_wave_renders_the_same_frames(fb, tmp_path, monkeypatch):
    """Wave.output renders (`_render`) and blits through FbMap: onto a
    temporary file in place of /dev/fb0 (mmap, BGRX) or, with no
    framebuffer, into the malloc'd RGB buffer, then a BMP screenshot.
    Rendered maps, framebuffer bytes and screenshots equal.  The wave is
    wider than the display's 720 columns, so the blit clips."""
    from wmix_tpu.ui import fbmap as JF
    from wmix_tpu.ui import wave as JW
    from wmix_tpu_torch.ui import fbmap as TF
    from wmix_tpu_torch.ui import wave as TW
    w, h, frames = 730, 40, 6
    outs = {}
    for name, fbm, wav in (("j", JF, JW), ("t", TF, TW)):
        path = tmp_path / f"fb_{name}"
        if fb == "file":
            path.write_bytes(bytes(fbm.DEFAULT_W * fbm.DEFAULT_H * 4))
        monkeypatch.setattr(fbm, "FB_PATH", str(path))
        monkeypatch.setattr(fbm, "_fbmap", None)
        try:
            maps = _waves(wav, w, h, frames, seed=5)
            assert (fbm._fbmap.fd is None) == (fb == "none")
            shot = tmp_path / f"shot_{name}.bmp"
            fbm._fbmap.screenshot(str(shot))
        finally:
            fbm.fb_release()
        outs[name] = (maps, shot.read_bytes(),
                      path.read_bytes() if fb == "file" else b"")
    (maps_j, shot_j, fb_j), (maps_t, shot_t, fb_t) = outs["j"], outs["t"]
    for k, (a, b) in enumerate(zip(maps_j, maps_t)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    assert maps_t[-1].any() and shot_t == shot_j and fb_t == fb_j
    if fb == "file":
        assert any(fb_t)


def test_wave_output2_bmp_equal(tmp_path):
    from wmix_tpu.ui import wave as JW
    from wmix_tpu_torch.ui import wave as TW
    files = []
    for mod in (JW, TW):
        wave = mod.Wave(0, 0, 61, 23)
        rng = np.random.RandomState(9)
        for k in range(3):
            for c in range(mod.WAVE_CHN):
                wave.load(c, int(rng.randint(-32768, 32768)))
            path = tmp_path / f"{mod.__name__}_{k}.bmp"
            wave.output2(str(path))
            files.append(path.read_bytes())
    assert files[:3] == files[3:]


# ------------------------------------------------------------------ RTP

class _Done(Exception):
    """Ends a tool's endless loop from its `time.sleep`."""


class _SenderClock:
    """The sender's `time`: each packet sent ends in one `sleep`; the
    `packets`-th ends the loop."""

    def __init__(self, packets):
        self.left = packets
        self.monotonic = time.monotonic

    def sleep(self, _s):
        self.left -= 1
        if self.left == 0:
            raise _Done()
        time.sleep(0.002)


class _ReceiverClock:
    """The receiver's `time`: `sleep` is its idle poll.  The first poll
    says the socket is bound; once the sender is done, 50 idle polls in a
    row end the loop with `stop`."""

    def __init__(self, stop):
        self.stop = stop
        self.ready = threading.Event()
        self.sent = threading.Event()
        self.idle = 0

    def sleep(self, _s):
        self.ready.set()
        self.idle = self.idle + 1 if self.sent.is_set() else 0
        if self.idle >= 50:
            raise self.stop()
        time.sleep(0.001)


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _carry(monkeypatch, tmp_path, tag, tx, rx, tx_args, rx_args, packets,
           stop):
    """tx.send(*tx_args, bind=False) to rx.recv(*rx_args, bind=True) over
    loopback, `packets` packets; returns the SDP text the sender wrote,
    its port replaced by PORT."""
    port = _free_port()
    rclock = _ReceiverClock(stop)
    monkeypatch.setattr(rx, "time", rclock)
    monkeypatch.setattr(tx, "time", _SenderClock(packets))
    sdp_dir = tmp_path / f"sdp_{tag}"
    sdp_dir.mkdir()
    real_sdp = tx.rtp.create_sdp

    def create_sdp(path, *a, **kw):
        return real_sdp(str(sdp_dir / os.path.basename(path)), *a, **kw)
    monkeypatch.setattr(tx.rtp, "create_sdp", create_sdp)
    errors = []

    def receive():
        try:
            rx.recv(*rx_args[:1], True, *rx_args[1:], "127.0.0.1", port)
        except _Done:
            pass
        except BaseException as e:     # noqa: BLE001 - reported below
            errors.append(e)
    th = threading.Thread(target=receive, daemon=True)
    th.start()
    assert rclock.ready.wait(10)
    with pytest.raises(_Done):
        tx.send(*tx_args, False, "127.0.0.1", port)
    rclock.sent.set()
    th.join(10)
    assert not th.is_alive() and not errors, errors
    (sdp,) = list(sdp_dir.iterdir())
    return sdp.read_text().replace(f"m=audio {port} ", "m=audio PORT ")


def test_rtp_pcm_between_the_packages(monkeypatch, tmp_path):
    """rtp_pcm: each package's sender loops a WAV as G.711a packets to the
    other's receiver; both receivers write the same WAV, whose samples
    are the file's first packets through A-law and back."""
    from wmix_tpu.codecs import wav as wavc
    from wmix_tpu.ops import g711
    from wmix_tpu.tools import rtp_pcm as J
    from wmix_tpu_torch.tools import rtp_pcm as T
    packets = 5
    pcm = (np.random.RandomState(3).randn(160 * packets) * 4000).astype(
        np.int16)
    src = tmp_path / "in.wav"
    wavc.write(str(src), pcm.tobytes(), 1, 8000)
    got, sdps = {}, {}
    for tx, rx, tag in ((T, J, "t2j"), (J, T, "j2t")):
        out = tmp_path / f"{tag}.wav"
        sdps[tag] = _carry(monkeypatch, tmp_path, tag, tx, rx, (str(src),),
                           (str(out),), packets, KeyboardInterrupt)
        got[tag] = out.read_bytes()
    assert got["t2j"] == got["j2t"] and sdps["t2j"] == sdps["j2t"]
    hdr, data = wavc.read(str(tmp_path / "t2j.wav"))
    assert (hdr.channels, hdr.sample_rate) == (1, 8000)
    want = g711.np_decode_alaw(g711.np_encode_alaw(pcm)).astype(np.int16)
    assert data == want.tobytes()


def test_rtp_aac_between_the_packages(monkeypatch, tmp_path):
    """rtp_aac: each package's sender sends the ADTS stream's frames as AUs
    to the other's receiver, which wraps each in a new ADTS header; both
    receivers write the same file, each frame's payload unchanged."""
    from wmix_tpu.codecs import adts
    from wmix_tpu.tools import rtp_aac as J
    from wmix_tpu_torch.tools import rtp_aac as T
    src = os.path.join(REPO, "tests", "data", "torch_codec_aac_8k_mono.aac")
    data = open(src, "rb").read()
    payloads, pos = [], 0
    while pos + 7 <= len(data):
        info = adts.parse_header(data[pos:pos + 7])
        payloads.append(data[pos + 7:pos + info.frame_len])
        pos += info.frame_len
    packets = len(payloads)
    got, sdps = {}, {}
    for tx, rx, tag in ((T, J, "t2j"), (J, T, "j2t")):
        out = tmp_path / f"{tag}.aac"
        sdps[tag] = _carry(monkeypatch, tmp_path, tag, tx, rx, (src,),
                           (str(out), info.chn, info.freq), packets, _Done)
        got[tag] = out.read_bytes()
    assert got["t2j"] == got["j2t"] and sdps["t2j"] == sdps["j2t"]
    heard, pos = [], 0
    while pos < len(got["t2j"]):
        info = adts.parse_header(got["t2j"][pos:pos + 7])
        heard.append(got["t2j"][pos + 7:pos + info.frame_len])
        pos += info.frame_len
    assert heard == payloads


@pytest.mark.parametrize("tool", ["rtp_pcm", "rtp_aac"])
def test_tool_usage_equal(tool, capsys):
    import importlib
    J = importlib.import_module(f"wmix_tpu.tools.{tool}")
    T = importlib.import_module(f"wmix_tpu_torch.tools.{tool}")
    argv = [] if tool == "rtp_pcm" else ["prog"]
    rc_j = J.main(argv)
    out_j = capsys.readouterr().out
    rc_t = T.main(argv)
    out_t = capsys.readouterr().out
    assert rc_j == rc_t != 0
    assert out_t == out_j.replace("wmix_tpu.", "wmix_tpu_torch.")
