"""The host modules of the daemon that wmix_tpu_torch keeps as copies of
wmix_tpu's, held to their originals: every module's text equal but for the
lines that name the package (and the reference checkout's absolute path in
comments), the host half of the mixer function for function, and the
copies' behaviour equal: a WAV written by one package and read by the
other, RTP packets byte-equal and carried between the two packages'
sockets, the AAC encoder's ADTS bytes, the speex AEC's packages, the HALs,
and the SysV queue and shared-memory ring carrying messages and samples
from the port's side to the reference's.  Every queue and ring here is
keyed under a private MSG_PATH (the reference's own tests hold the fixed
key "/tmp/wmix" on other workers).
"""
import ctypes
import inspect
import re
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_codec_copies import _assert_copy  # noqa: E402

COPIES = [
    "ops/resample.py", "native/stepper.c",
    "codecs/wav.py", "codecs/aacenc.py", "codecs/_aacenc_tables.py",
    "io_/__init__.py", "io_/rtp.py", "dsp/speex_aec.py",
    "service/sysv.py", "service/mem.py", "service/hal.py",
    "service/hal_alsa.py", "service/client.py", "service/cli.py",
    "service/tasks.py", "service/engine_bridge.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_text_equal_but_the_package_name(rel):
    changed = _assert_copy(rel)
    if rel in ("codecs/_aacenc_tables.py", "service/sysv.py",
               "service/hal.py", "io_/rtp.py", "dsp/speex_aec.py"):
        assert changed == 0


def test_stepper_text_equal_but_its_typed_arguments():
    """ops/stepper.py is the reference's line for line (the package
    renamed), except `_native`, which types the C functions' arguments
    as well as their results."""
    from tests.test_torch_codec_copies import _normalize, _texts
    orig, copy = _texts("ops/stepper.py")

    def without_native(text):
        a = text.index("def _native():")
        b = text.index("@functools.lru_cache(maxsize=1)")
        return text[:a] + text[b:]
    assert without_native(copy).splitlines() == \
        [_normalize(ln) for ln in without_native(orig).splitlines()]
    assert "lib.load_insert_events.argtypes = [" in copy


@pytest.mark.parametrize("name", ["_trunc_div", "_copy_frames",
                                  "build_contrib"])
def test_mixer_host_half_text_equal(name):
    from wmix_tpu.ops import mixer as J
    from wmix_tpu_torch.ops import mixer as T
    assert inspect.getsource(getattr(T, name)) == \
        inspect.getsource(getattr(J, name))


def test_mixer_load_data_equal_but_its_device_branch():
    """load_data is the reference's line for line, except the
    `use_device` branch (torch's `device_mix` on a named device for the
    jitted one) and the docstring and signature that name the device."""
    from wmix_tpu.ops import mixer as J
    from wmix_tpu_torch.ops import mixer as T
    def body(fn):
        src = inspect.getsource(fn)
        src = src[src.index("    raw = bytes(src)"):]
        a, b = src.index("        if use_device:"), src.index("        else:")
        return src[:a] + src[b:]
    assert body(T.load_data) == body(J.load_data)


def test_aacenc_tables_equal():
    from wmix_tpu.codecs import _aacenc_tables as J
    from wmix_tpu_torch.codecs import _aacenc_tables as T
    names = [n for n in vars(J) if n.isupper()]
    assert names and names == [n for n in vars(T) if n.isupper()]
    for n in names:
        a, b = getattr(J, n), getattr(T, n)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=n)
        else:
            assert a == b, n


# ------------------------------------------------------------------ WAV

@pytest.mark.parametrize("chn,freq", [(1, 8000), (2, 44100)])
def test_wav_written_by_one_read_by_the_other(tmp_path, chn, freq):
    from wmix_tpu.codecs import wav as J
    from wmix_tpu_torch.codecs import wav as T
    pcm = (np.random.RandomState(chn).randn(3000 * chn) * 5000).astype(
        np.int16).tobytes()
    for w, r, name in ((T, J, "port.wav"), (J, T, "ref.wav")):
        w.write(tmp_path / name, pcm, chn, freq)
        hdr, data = r.read(str(tmp_path / name))
        assert (hdr.channels, hdr.sample_rate, hdr.sample_bits) == \
            (chn, freq, 16)
        assert data == pcm
    assert (tmp_path / "port.wav").read_bytes() == \
        (tmp_path / "ref.wav").read_bytes()
    assert T.WavHeader.params(10, chn, 16, freq).pack() == \
        J.WavHeader.params(10, chn, 16, freq).pack()


# ------------------------------------------------------------------ RTP

def test_rtp_packets_byte_equal():
    from wmix_tpu.io_ import rtp as J
    from wmix_tpu_torch.io_ import rtp as T
    for kw in (dict(pt=J.PT_PCMA, m=1, seq=7, timestamp=160, ssrc=1),
               dict(pt=J.PT_AAC, seq=0xFFFF, timestamp=0xFFFFFFFF,
                    ssrc=0x32411)):
        a, b = J.RtpHeader(**kw).pack(), T.RtpHeader(**kw).pack()
        assert a == b
        assert T.RtpHeader.unpack(a) == T.RtpHeader(**kw)
    for n in (0, 1, 255, 8191):
        assert T.aac_au_header(n) == J.aac_au_header(n)
    for pt in (J.PT_AAC, J.PT_PCMA, J.PT_PCMU):
        assert T.create_sdp("", "127.0.0.1", 9832, 1, 8000, pt) == \
            J.create_sdp("", "127.0.0.1", 9832, 1, 8000, pt)


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("pt", ["pcma", "aac"])
def test_rtp_between_the_packages(pt):
    """A packet sent by one package's RtpSocket is received by the
    other's, header, payload and size equal, both ways."""
    import time
    from wmix_tpu.io_ import rtp as J
    from wmix_tpu_torch.io_ import rtp as T
    code = J.PT_AAC if pt == "aac" else J.PT_PCMA
    payload = bytes(range(160))
    for tx_mod, rx_mod in ((T, J), (J, T)):
        port = _free_port()
        rx = rx_mod.RtpSocket("127.0.0.1", port, bind_mode=True)
        tx = tx_mod.RtpSocket("127.0.0.1", port, bind_mode=False)
        tx.header = tx_mod.RtpHeader(pt=code, m=1, seq=41, timestamp=960)
        assert tx.send(payload) > 0
        got = None
        for _ in range(200):
            got = rx.recv()
            if got is not None:
                break
            time.sleep(0.005)
        tx.close()
        rx.close()
        assert got is not None
        hdr, raw, size = got
        assert hdr.pack() == J.RtpHeader(pt=code, m=1, seq=41,
                                         timestamp=960).pack()
        want = J.aac_au_header(160) + payload if pt == "aac" else payload
        assert raw == want
        assert size == 160


# ------------------------------------------------------------ AAC, speex

@pytest.mark.parametrize("chn,freq", [(1, 8000), (2, 16000), (1, 32000)])
def test_aacenc_adts_bytes_equal(chn, freq):
    from wmix_tpu.codecs import aacenc as J
    from wmix_tpu_torch.codecs import aacenc as T
    pcm = (np.random.RandomState(freq + chn).randn(1024 * chn * 8) *
           4000).astype(np.int16)
    outs = []
    for mod in (J, T):
        enc, out = None, b""
        for i in range(8):
            enc, blob = mod.aac_encode(
                enc, pcm[i * 1024 * chn:(i + 1) * 1024 * chn].tobytes(),
                chn, freq)
            out += blob
        outs.append(out)
    assert len(outs[0]) > 100 and outs[1] == outs[0]


@pytest.mark.parametrize("chn,freq", [(1, 8000), (2, 16000)])
def test_speex_aec_equal(chn, freq):
    from wmix_tpu.dsp import speex_aec as J
    from wmix_tpu_torch.dsp import speex_aec as T
    rng = np.random.RandomState(freq)
    n = freq // 1000 * 20 * chn
    far = (rng.randn(12, n) * 5000).astype(np.int16)
    near = (0.5 * np.roll(far, 40, axis=1) + rng.randn(12, n) * 800).astype(
        np.int16)
    a, b = J.SpxAecProcessor(chn, freq, 20, 0), \
        T.SpxAecProcessor(chn, freq, 20, 0)
    for k in range(12):
        want, got = a.process2(far[k], near[k]), b.process2(far[k], near[k])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"package {k}")


# -------------------------------------------------------------- the HALs

def test_hals_equal():
    from wmix_tpu.service import hal as J
    from wmix_tpu_torch.service import hal as T
    for cls in ("T31Hal", "NullHal", "LoopHal"):
        a, b = getattr(J, cls)(), getattr(T, cls)()
        for vol in (-3, 0, 1, 5, 10, 11, 70):
            a.ao_vol_set(a.ao_init(1, 8000), vol)
            b.ao_vol_set(b.ao_init(1, 8000), vol)
            a.ai_vol_set(a.ai_init(1, 8000), vol)
            b.ai_vol_set(b.ai_init(1, 8000), vol)
            assert b.ao_vol_get(None) == a.ao_vol_get(None)
            assert b.ai_vol_get(None) == a.ai_vol_get(None)
    a, b = J.LoopHal(), T.LoopHal()
    mic = bytes(range(256)) * 5
    for h in (a, b):
        h.feed_mic(mic)
        h.ao_write(None, b"\x01\x02" * 50)
    for size in (320, 640, 640):
        assert b.ai_read(None, size) == a.ai_read(None, size)
    assert b.played == a.played


# ------------------------------------------- SysV queues and shared memory

_libc = ctypes.CDLL(None, use_errno=True)
_libc.shmat.restype = ctypes.c_void_p


@pytest.fixture
def private_msg_path(tmp_path, monkeypatch):
    """Both packages' MSG_PATH on one private directory (so the port's
    side can talk to the reference's without touching "/tmp/wmix"); the
    shared-memory segments made under it are removed afterwards."""
    from wmix_tpu.service import sysv as J
    from wmix_tpu_torch.service import sysv as T
    path = str(tmp_path / "wmix")
    monkeypatch.setattr(J, "MSG_PATH", path)
    monkeypatch.setattr(T, "MSG_PATH", path)
    yield path
    for ch in (T.MEM_AI_1X8000_CHAR, T.MEM_AI_ORIGIN_CHAR):
        try:
            key = T.ftok(path, ord(ch))
        except OSError:
            continue
        shm_id = _libc.shmget(key, 0, 0)
        if shm_id != -1:
            _libc.shmctl(shm_id, T.IPC_RMID, None)


def test_message_from_the_port_reaches_the_reference(private_msg_path):
    import os
    from wmix_tpu.service import sysv as J
    from wmix_tpu_torch.service import sysv as T
    os.makedirs(private_msg_path, exist_ok=True)
    key = T.ftok(private_msg_path, T.MSG_ID)
    assert key == J.ftok(private_msg_path, J.MSG_ID)
    fd = T.msgget(key, T.IPC_CREAT | 0o666)
    try:
        assert ctypes.sizeof(T._MsgBuf) == ctypes.sizeof(J._MsgBuf)
        T.msgsnd(fd, 0x0A0B0103, b"hello\0world")
        mtype, value = J.msgrcv(J.msgget(key, 0o666))
        assert mtype == 0x0A0B0103
        assert value[:11] == b"hello\0world" and len(value) == 128
        assert T.msgrcv(fd) is None
    finally:
        T.msgctl_rmid(fd)
    assert not T.queue_exists(key)


def test_shm_ring_from_the_port_read_by_the_reference(private_msg_path):
    from wmix_tpu.service import mem as J
    from wmix_tpu_torch.service import mem as T
    from wmix_tpu_torch.service import sysv
    assert ctypes.sizeof(sysv.MemCircle) == 2 + 2 * (10240 + 4)
    w = T.MemWriter(sysv.MEM_AI_ORIGIN_CHAR)
    r = J.MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    data = (np.arange(12000) * 7 % 60000 - 30000).astype(np.int16)
    got = []
    for k in range(0, data.size, 3000):
        w.write(data[k:k + 3000])
        got.append(r.read(4000))
    np.testing.assert_array_equal(np.concatenate(got), data)
    port_reader = T.MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    w.write(data[:5])
    np.testing.assert_array_equal(port_reader.read(10), data[:5])


def test_msg_path_is_read_from_sysv_at_call_time():
    """Every path under MSG_PATH is read from `sysv` at call time, so a
    private MSG_PATH reaches the client, the rings and the daemon."""
    import os
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "wmix_tpu_torch", "service")
    for name in ("client.py", "mem.py", "tasks.py", "core.py"):
        with open(os.path.join(root, name)) as f:
            text = f.read()
        code = re.sub(r'"""[\s\S]*?"""|#.*', "", text)
        assert '"/tmp/wmix"' not in code, name
        assert "MSG_PATH" not in code or "sysv.MSG_PATH" in code, name
