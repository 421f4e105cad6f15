"""The daemon of wmix_tpu_torch (`service.core.WmixDaemon`, its tasks,
client and entry point) on the CPU.

Against wmix_tpu's daemon: both daemons, fed the same LoopHal input, give
the same bytes at the speaker and the same record packages.  For a
deterministic comparison a task runs in the test's thread and its waits
pump the daemon one tick (`_PumpClock`): WAV play, two streams mixed with
saturation, the note tap, MP3 play (tests/data/torch_codec_mp3_l3.mp3,
Layer III at 44.1 kHz) and AAC play through SBR
(tests/data/torch_codec_aac_8k_mono.aac: the first caller of the port's
SBR and PS copies).  The record path with NS, AEC, AGC and VAD on is held
bit-equal in exact mode to wmix_tpu's daemon as stored by
`tools/gen_torch_daemon_ref.py`; with the integer backends (NSX, AECM)
and with the speex AEC, live.

Through the control plane, as tests/test_service.py drives wmix_tpu's:
the port's client over SysV queues and shared memory keyed under a
private MSG_PATH (the fixed key "/tmp/wmix" is held by the reference's
tests on other workers): play, kill, clean list, the record fan-out,
record WAV, info and switches, RTP receive, and the entry point's flags.
"""
import ctypes
import os
import pathlib
import socket
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
sys.path.insert(0, os.path.join(REPO, "tools"))
import gen_torch_daemon_ref as ref  # noqa: E402

from wmix_tpu_torch.codecs import wav as wavc  # noqa: E402
from wmix_tpu_torch.config import EngineConfig  # noqa: E402
from wmix_tpu_torch.service import client, core, sysv  # noqa: E402
from wmix_tpu_torch.service.core import WmixDaemon  # noqa: E402
from wmix_tpu_torch.service.hal import LoopHal  # noqa: E402

PACKAGES = ("wmix_tpu", "wmix_tpu_torch")


@pytest.fixture(autouse=True)
def reference_stepper_in_python(monkeypatch):
    """wmix_tpu's stepper on its pure-Python simulation: its untyped
    ctypes call to `load_insert_events` may return no events
    (tests/test_torch_host_mixer.py)."""
    from tests.test_torch_host_mixer import python_stepper
    from wmix_tpu.ops import stepper
    clear = python_stepper(monkeypatch, stepper)
    yield
    clear()


def _mods(package):
    import importlib
    return [importlib.import_module(f"{package}.{m}")
            for m in ("service.core", "service.tasks", "service.hal",
                      "config")]


class _PumpClock:
    """A task module's `time`: each sleep pumps the daemon one tick, so
    the task runs in the caller's thread and the run is the same every
    time."""

    def __init__(self, d):
        self.d = d

    def sleep(self, _s):
        self.d.pump(1)

    monotonic = staticmethod(time.monotonic)


def _daemon(package, monkeypatch, freq=8000, chn=1, **cfg_kw):
    """A daemon of `package` without queues or rings whose tasks run in
    the caller's thread."""
    core_m, tasks_m, hal_m, config_m = _mods(package)
    kw = {"device": "cpu"} if package == "wmix_tpu_torch" else {}
    hal = hal_m.LoopHal()
    d = core_m.WmixDaemon(config_m.EngineConfig(chn=chn, freq=freq,
                                                **cfg_kw),
                          hal=hal, msg_queue=False, shmem=False, **kw)
    monkeypatch.setattr(tasks_m, "time", _PumpClock(d))
    d._spawn = lambda fn, mtype, value: fn(d, mtype, value)
    return d, hal, core_m


def _drain(d, max_ticks=400):
    for _ in range(max_ticks):
        if d.thread_play == 0 and not d.tick_has_data():
            return
        d.pump(1)
    raise AssertionError("the ring never drained")


def _tone_wav(path, freq_hz, n, fs=8000, amp=8000, chn=1):
    t = np.arange(n) / fs
    pcm = (np.sin(2 * np.pi * freq_hz * t) * amp).astype(np.int16)
    wavc.write(path, np.repeat(pcm, chn).tobytes(), chn, fs)
    return pcm


def _played(hal):
    return np.frombuffer(bytes(hal.played), np.int16)


def _play_both(monkeypatch, plays, freq=8000, chn=1, note=None):
    """Every (path, order) of `plays` dispatched in turn to a daemon of
    each package, then the ring drained; returns the two speakers'
    samples (and the two note files' bytes when `note` names a path
    stem)."""
    out, notes = [], []
    for package in PACKAGES:
        d, hal, core_m = _daemon(package, monkeypatch, freq, chn)
        d.pump(2)
        if note:
            d.dispatch(core_m.WMT_NOTE, f"{note}.{package}.wav".encode()
                       + b"\0")
        for path, mtype in plays:
            d.dispatch(mtype, str(path).encode() + b"\0")
        _drain(d)
        if note:
            d.dispatch(core_m.WMT_NOTE, b"\0")
            d.pump(2)
            with open(f"{note}.{package}.wav", "rb") as f:
                notes.append(f.read())
        d.stop()
        out.append(_played(hal))
    return out, notes


@pytest.mark.parametrize("fs,chn,eng_freq,eng_chn", [
    (8000, 1, 8000, 1), (16000, 2, 8000, 1), (11025, 1, 16000, 2)])
def test_play_wav_equal(monkeypatch, tmp_path, fs, chn, eng_freq, eng_chn):
    pcm = _tone_wav(tmp_path / "tone.wav", 440, fs // 2, fs=fs, chn=chn)
    (want, got), _ = _play_both(
        monkeypatch, [(tmp_path / "tone.wav", core.WMT_PLAY_MIX)],
        eng_freq, eng_chn)
    np.testing.assert_array_equal(got, want)
    nz = np.nonzero(got)[0]
    assert nz.size > eng_freq // 4 * eng_chn
    if (fs, chn, eng_freq, eng_chn) == (8000, 1, 8000, 1):
        start = nz[0] - 1          # pcm[0] is sin(0) == 0
        np.testing.assert_array_equal(got[start:start + pcm.size], pcm)


def test_two_streams_saturating_mix_equal(monkeypatch, tmp_path):
    a = _tone_wav(tmp_path / "a.wav", 400, 6000, amp=20000)
    (want, got), _ = _play_both(
        monkeypatch, [(tmp_path / "a.wav", core.WMT_PLAY_MIX)] * 2)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 32767 and got.min() == -32768
    doubled = np.clip(2 * a[:20].astype(np.int32), -32768, 32767).astype(
        np.int16)
    assert np.tile(doubled, 2).tobytes() in got.tobytes()


def test_note_taps_play_stream_equal(monkeypatch, tmp_path):
    _tone_wav(tmp_path / "tone.wav", 500, 2400)
    (want, got), (nw, ng) = _play_both(
        monkeypatch, [(tmp_path / "tone.wav", core.WMT_PLAY_MIX)],
        note=str(tmp_path / "note"))
    np.testing.assert_array_equal(got, want)
    assert ng == nw
    hdr, data = wavc.read(ng)
    assert hdr.sample_rate == 8000 and hdr.channels == 1
    tap = np.frombuffer(data, np.int16)
    assert tap.size and np.count_nonzero(tap) > 1000


def test_play_mp3_equal(monkeypatch, tmp_path):
    """Layer III at 44.1 kHz stereo, decoded by each package's host
    decoder and mixed into an 8 kHz mono engine."""
    path = tmp_path / "clip.mp3"
    with open(os.path.join(DATA, "torch_codec_mp3_l3.mp3"), "rb") as f:
        path.write_bytes(f.read())
    (want, got), _ = _play_both(monkeypatch, [(path, core.WMT_PLAY_MIX)])
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 1000


def test_play_aac_through_sbr_equal(monkeypatch, tmp_path):
    """8 kHz mono AAC: at 24 kHz and below the decoder upsamples through
    SBR (implicit signalling), so the port's SBR and PS copies decode it;
    the 16 kHz output is mixed into a 16 kHz engine."""
    from wmix_tpu_torch.codecs import aac
    path = tmp_path / "clip.aac"
    with open(os.path.join(DATA, "torch_codec_aac_8k_mono.aac"), "rb") as f:
        path.write_bytes(f.read())
    with open(path, "rb") as f:
        dec, _raw, _chn, freq = aac.aac_decode2(None, f)
    assert dec.force_up
    (want, got), _ = _play_both(monkeypatch, [(path, core.WMT_PLAY_MIX)],
                                freq=16000)
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 1000


@pytest.mark.parametrize("freq", ref.DAEMON_FREQS)
def test_record_path_all_modules_equal_stored(monkeypatch, freq):
    """NS, AEC, AGC and VAD on the record heartbeat, exact mode: every
    fanned-out package bit-equal to wmix_tpu's daemon (stored)."""
    monkeypatch.setenv("WMIX_EXACT", "1")
    got = ref.record_packages("wmix_tpu_torch", freq, device="cpu")
    with np.load(ref.PATH) as z:
        want = z[f"daemon_{freq}"]
    assert got.shape == want.shape and got.shape[0] > 20
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["aecm+nsx", "speex"])
def test_record_path_alternate_backends_equal(monkeypatch, backend):
    """The integer backends (AECM, NSX) and the speex AEC (alone: the
    float NS would need the stored reference) on the record heartbeat:
    fanned-out packages equal to wmix_tpu's daemon, live."""
    kw = dict(aec_backend="aecm", ns_backend="nsx") \
        if backend == "aecm+nsx" else dict(aec_backend="speex")
    mic = (np.sin(np.arange(16000) * 0.21) * 8000 +
           np.random.RandomState(3).randn(16000) * 500).astype(np.int16)
    outs = []
    for package in PACKAGES:
        d, hal, core_m = _daemon(package, monkeypatch, 8000, 1, **kw)
        hal.feed_mic(mic.tobytes())
        d.webrtc_enable[core_m.WR_AEC] = 1
        d.webrtc_enable[core_m.WR_NS] = int(backend == "aecm+nsx")
        d.shmem_run = 1
        got = []
        out = d._record_out
        d._record_out = lambda b, got=got, out=out: (
            got.append(np.array(b, np.int16)), out(b))
        d.pump(6)
        assert d._webrtc[core_m.WR_AEC] is not None
        d.stop()
        outs.append(np.stack(got))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1].shape[0] > 20 and np.count_nonzero(outs[1])


def test_heartbeat_copies_once_each_way(monkeypatch):
    """A heartbeat with all four modules on moves its audio to the device
    once (mic and far end together) and back once."""
    calls = {"in": 0, "out": 0}
    to_dev, to_host = core._to_device, core._to_host

    def count(name, fn):
        def f(*a):
            calls[name] += 1
            return fn(*a)
        return f
    monkeypatch.setattr(core, "_to_device", count("in", to_dev))
    monkeypatch.setattr(core, "_to_host", count("out", to_host))
    hal = LoopHal()
    hal.feed_mic(ref.daemon_mic(16000))
    d = WmixDaemon(EngineConfig(chn=1, freq=16000), hal=hal,
                   msg_queue=False, shmem=False, device="cpu")
    for i in ref.WR_ALL:
        d.webrtc_enable[i] = 1
    d.shmem_run = 1
    d.pump(1)                     # the record path opens
    calls.update({"in": 0, "out": 0})
    d.shmem_write_circle()
    assert calls == {"in": 1, "out": 1}
    d.stop()


def test_daemon_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WmixDaemon(EngineConfig(), msg_queue=False, shmem=False)


def test_entry_point_flags():
    from wmix_tpu_torch.service import daemon
    s = daemon.parse_args(["-c", "2", "-f", "16000", "--hal", "loop",
                           "--device", "cpu", "-aec", "1", "-va", "9",
                           "/tmp/boot.wav"])
    assert s["device"] == "cpu" and s["hal"] == "loop"
    assert s["webrtc"] == {core.WR_AEC: 1} and s["volume_agc"] == 9
    cfg = daemon.make_config(s)
    assert (cfg.chn, cfg.freq) == (2, 16000)
    assert isinstance(daemon.make_hal("loop"), LoopHal)
    assert daemon.parse_args(["--help"])["help"]
    assert daemon.main(["--help"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            daemon.main(["--hal", "null"])


def test_startup_settings_reach_the_core():
    from wmix_tpu_torch.service import daemon
    s = daemon.parse_args(["-v", "8", "-vr", "12", "-va", "7", "-ns", "1",
                           "-agc", "1", "--device", "cpu"])
    hal = LoopHal()
    d = WmixDaemon(daemon.make_config(s), hal=hal, msg_queue=False,
                   shmem=False, device=s["device"])
    daemon.apply_startup(d, s)
    assert d.volume == 8 and hal.ao_vol == 8
    assert d.volume_mic == 10 and d.volume_agc == 7
    assert d.webrtc_enable[core.WR_NS] == 1 and \
        d.webrtc_enable[core.WR_AGC] == 1
    d.stop()


# ------------------------------------------- through the control plane

_libc = ctypes.CDLL(None, use_errno=True)


@pytest.fixture
def short_dir():
    """A directory with a short path: a message carries an audio path and
    a task's queue path in 128 bytes (WMIX_MSG_BUFF_SIZE)."""
    import shutil
    import tempfile
    path = tempfile.mkdtemp(prefix="wm")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def daemon(short_dir, monkeypatch):
    """The port's daemon with its queue and rings under a private
    MSG_PATH, driven through the port's client."""
    path = os.path.join(short_dir, "q")
    monkeypatch.setattr(sysv, "MSG_PATH", path)
    hal = LoopHal()
    d = WmixDaemon(EngineConfig(chn=1, freq=8000), hal=hal, device="cpu")
    yield d, hal
    d.stop()
    for ch in (sysv.MEM_AI_1X8000_CHAR, sysv.MEM_AI_ORIGIN_CHAR):
        shm_id = _libc.shmget(sysv.ftok(path, ord(ch)), 0, 0)
        if shm_id != -1:
            _libc.shmctl(shm_id, sysv.IPC_RMID, None)


def _pump_until(d, cond, max_ticks=600):
    for _ in range(max_ticks):
        d.pump(1)
        if cond():
            return True
        time.sleep(0.002)
    return False


def test_play_through_the_queue_reaches_speaker(daemon, short_dir):
    d, hal = daemon
    tmp_path = pathlib.Path(short_dir)
    pcm = _tone_wav(tmp_path / "tone.wav", 440, 4000)
    assert client.play(str(tmp_path / "tone.wav"), order=2) > 0
    assert _pump_until(d, lambda: d.thread_play == 0 and
                       not d.tick_has_data(), max_ticks=2000)
    out = _played(hal)
    nz = np.nonzero(out)[0]
    assert nz.size, "nothing played"
    start = nz[0] - 1
    np.testing.assert_array_equal(out[start:start + pcm.size], pcm)


def test_play_kill_and_clean_list(daemon, short_dir):
    d, hal = daemon
    tmp_path = pathlib.Path(short_dir)
    _tone_wav(tmp_path / "long.wav", 220, 80000)
    tid = client.play(str(tmp_path / "long.wav"), order=2)
    note_file = f"{sysv.MSG_PATH}/{tid}"

    def described():
        # the task creates its note file, then writes it
        return os.path.exists(note_file) and \
            "play" in open(note_file).read()
    assert _pump_until(d, lambda: d.thread_play == 1 and described())
    assert any(t == tid for t, _ in client.list_tasks())
    client.play_kill(tid)
    assert _pump_until(d, lambda: d.thread_play == 0)
    assert not os.path.exists(note_file)
    client.play(str(tmp_path / "long.wav"), order=2)
    client.play(str(tmp_path / "long.wav"), order=2)
    assert _pump_until(d, lambda: d.thread_play == 2)
    client.play_kill(0)   # WMT_CLEAN_LIST
    assert _pump_until(d, lambda: d.thread_play == 0)


def test_record_path_shmem_fanout(daemon):
    from wmix_tpu_torch.service.mem import MemReader
    d, hal = daemon
    mic = (np.arange(8000) % 1000 * 30 - 15000).astype(np.int16)
    hal.feed_mic(mic.tobytes())
    client.mem_switch(True)
    d.pump(1)
    rd = MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    rd.addr = int(rd.circle.w)
    assert _pump_until(d, lambda: d.record_run and d.obj_ai is not None)
    got = np.zeros(0, np.int16)
    for _ in range(60):
        d.pump(1)
        got = np.concatenate([got, rd.read(4000)])
        if got.size >= 3200:
            break
    client.mem_switch(False)
    assert got.size >= 3200
    assert np.nonzero(got == mic[320])[0].size, \
        "mic audio never reached the shm ring"


def test_record_with_modules_through_the_client(daemon):
    """NS+AGC+VAD switched on through the queue: processed audio reaches
    the 8 kHz ring, read by the client; switched off, the processors
    go."""
    d, hal = daemon
    hal.feed_mic((np.random.RandomState(0).randn(16000) * 2000).astype(
        np.int16).tobytes())
    for m in ("ns", "agc", "vad"):
        client.webrtc_switch(m, True)
    client.mem_switch(True)
    d.pump(2)
    assert isinstance(d._webrtc[core.WR_NS], core._NsProc)
    from wmix_tpu_torch.service.mem import MemReader
    rd = MemReader(sysv.MEM_AI_1X8000_CHAR)
    got = np.zeros(0, np.int16)
    for _ in range(20):
        d.pump(1)
        got = np.concatenate([got, rd.read(4000)])
    client.mem_switch(False)
    for m in ("ns", "agc", "vad"):
        client.webrtc_switch(m, False)
    d.pump(1)
    assert got.size >= 1600 and np.abs(got.astype(np.int32)).max() > 0
    assert d._webrtc[core.WR_VAD] is None and d._webrtc[core.WR_NS] is None


def test_record_wav_task(daemon, short_dir):
    d, hal = daemon
    tmp_path = pathlib.Path(short_dir)
    mic = (np.sin(np.arange(24000) * 0.1) * 5000).astype(np.int16)
    hal.feed_mic(mic.tobytes())
    out = tmp_path / "rec.wav"
    client.record(str(out), 1, 8000, 1)
    assert _pump_until(d, lambda: d.thread_record == 1)
    assert _pump_until(d, lambda: d.thread_record == 0, max_ticks=1200)
    hdr, data = wavc.read(str(out))
    assert hdr.sample_rate == 8000 and hdr.channels == 1
    assert len(data) >= 8000 * 2 * 0.9


def test_info_and_switches(daemon):
    d, hal = daemon
    client.webrtc_switch("ns", True)
    client.webrtc_switch("agc", True)
    client.set_volume(7)
    client.set_volume_agc(9)
    d.pump(1)
    assert d.webrtc_enable[core.WR_NS] == 1 and \
        d.webrtc_enable[core.WR_AGC] == 1
    assert d.volume == 7 and hal.ao_vol == 7 and d.volume_agc == 9
    s = d.info()
    assert "chn: 1" in s and "freq: 8000" in s and "agc/9" in s


def test_rtp_recv_task_plays_into_ring(daemon):
    from wmix_tpu_torch.io_ import rtp
    from wmix_tpu_torch.ops import g711
    d, hal = daemon
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    client.rtp("127.0.0.1", port, 1, 8000, send_mode=False, bind_mode=True)
    assert _pump_until(d, lambda: d.thread_play == 1)
    time.sleep(0.05)
    tx = rtp.RtpSocket("127.0.0.1", port, bind_mode=False)
    tx.header = rtp.RtpHeader(pt=rtp.PT_PCMA)
    pcm = (np.arange(160 * 10) * 40 % 8000).astype(np.int16)
    for k in range(10):
        tx.send(g711.np_encode_alaw(pcm[k * 160:(k + 1) * 160]).astype(
            np.uint8).tobytes())
        d.pump(1)
        time.sleep(0.01)
    tx.close()
    assert _pump_until(d, lambda: np.any(_played(hal) != 0),
                       max_ticks=100)
    client.kill_all()
    assert _pump_until(d, lambda: d.thread_play == 0)
