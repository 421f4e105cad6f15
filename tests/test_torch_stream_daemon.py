"""wmix_tpu_torch stream front door: client connections stream 20 ms
packages over the socket protocol into engine slots and read DSP output
back, on the CPU.

The transport test uses the pass-through chain (all DSP stages off, origin
== mic), because the daemon pump free-runs: slots process silence between
client feeds, which rightly advances adaptive DSP state.  Bit-exactness of
the DSP behind slots is tests/test_torch_stream_server.py's.  Every join
and socket read has a timeout, so a hang fails instead of waiting.
"""
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu_torch.service import stream_daemon  # noqa: E402
from wmix_tpu_torch.service.stream_daemon import (StreamDaemon,  # noqa: E402
                                                  StreamSocketClient)
from wmix_tpu_torch.utils import trace  # noqa: E402

N_CLIENTS = 16
N_PKGS = 5
FREQ = 16000
PKG = FREQ // 1000 * 20
N8K = 160
PASS = dict(ns_enable=False, aec_enable=False, agc_enable=False,
            vad_enable=False)
TIMEOUT = 30


@pytest.fixture
def daemon(tmp_path):
    sock = str(tmp_path / "stream.sock")
    d = StreamDaemon(sock, capacity=N_CLIENTS, freq=FREQ, device="cpu",
                     **PASS)
    d.start()
    yield d, sock
    d.stop()
    assert not any(t.is_alive() for t in d._threads)


def _client_run(client_cls, sock, seed, results, errors):
    try:
        c = client_cls(sock)
        c.sock.settimeout(TIMEOUT)
        c.open()
        rng = np.random.RandomState(seed)
        sent = (rng.randn(N_PKGS, PKG) * 3000).astype(np.int16)
        got = []
        for i in range(N_PKGS):
            c.feed(sent[i])
            pkg = c.read_pkg(timeout=TIMEOUT)
            assert pkg is not None, "timed out waiting for output"
            pcm, vad = pkg
            assert pcm.shape == (PKG + N8K,) and vad == 0
            got.append(pcm[:PKG])
        c.close()
        results[seed] = (sent, np.stack(got))
    except Exception as e:  # surface in the main thread
        errors.append((seed, e))


def _run_clients(client_cls, sock, n):
    results, errors = {}, []
    threads = [threading.Thread(target=_client_run,
                                args=(client_cls, sock, s, results, errors))
               for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(results) == n
    for seed, (sent, got) in results.items():
        np.testing.assert_array_equal(got, sent)


def test_e2e_16_clients(daemon):
    d, sock = daemon
    _run_clients(StreamSocketClient, sock, N_CLIENTS)
    # deadline accounting recorded
    s = d.stats()
    assert s["n"] > 0 and "p95_ms" in s and s["budget_ms"] == 20
    assert s["capacity"] == N_CLIENTS and s["freq"] == FREQ


def test_wmix_tpu_client_against_the_ports_daemon(daemon):
    """Wire compatibility: the JAX package's client, byte for byte."""
    from wmix_tpu.service import stream_daemon as jax_daemon
    for name in ("T_OPEN", "T_FEED", "T_CLOSE", "T_OPENED", "T_PKG",
                 "T_ERR"):
        assert getattr(stream_daemon, name) == getattr(jax_daemon, name)
    assert stream_daemon._HDR.format == jax_daemon._HDR.format == "<BII"
    _, sock = daemon
    _run_clients(jax_daemon.StreamSocketClient, sock, 4)


def test_capacity_rejection(daemon):
    d, sock = daemon
    clients = []
    for _ in range(N_CLIENTS):
        c = StreamSocketClient(sock)
        c.sock.settimeout(TIMEOUT)
        c.open()
        clients.append(c)
    extra = StreamSocketClient(sock)
    extra.sock.settimeout(TIMEOUT)
    with pytest.raises(RuntimeError, match="no free stream slots"):
        extra.open()
    extra.sock.close()
    # freeing one slot admits a new stream
    clients[0].close()
    again = StreamSocketClient(sock)
    again.sock.settimeout(TIMEOUT)
    deadline = time.time() + TIMEOUT
    while True:
        try:
            again.open()
            break
        except RuntimeError:
            assert time.time() < deadline, "the freed slot never came back"
            time.sleep(0.05)
    again.close()
    for c in clients[1:]:
        c.close()


def test_err_for_a_closed_handle_and_bad_frames(daemon):
    d, sock = daemon
    c = StreamSocketClient(sock)
    c.sock.settimeout(TIMEOUT)
    h = c.open()
    stream_daemon._send_frame(c.sock, stream_daemon.T_CLOSE, h)
    c.feed(np.zeros(PKG, np.int16))         # the handle is closed now
    with pytest.raises(RuntimeError, match="is closed"):
        c.read_pkg(timeout=TIMEOUT)
    # a reopened stream on the same connection; a short package is refused
    # with an ERR and the stream lives on
    h2 = c.open()
    assert h2 != h
    c.feed(np.zeros(PKG - 1, np.int16))
    with pytest.raises(RuntimeError, match="int16 samples"):
        c.read_pkg(timeout=TIMEOUT)
    c.feed(np.full(PKG, 7, np.int16))
    pcm, vad = c.read_pkg(timeout=TIMEOUT)
    assert (pcm[:PKG] == 7).all()
    # a header that claims an absurd length ends the connection
    c.sock.sendall(struct.pack("<BII", stream_daemon.T_FEED, h2, 1 << 30))
    with pytest.raises(ConnectionError):
        c.read_pkg(timeout=TIMEOUT)
    c.sock.close()


def test_dsp_through_transport(tmp_path):
    """A client package flows through a real (AGC+VAD) chain: output is
    gain-lifted speech with a VAD flag attached."""
    sock = str(tmp_path / "dsp.sock")
    d = StreamDaemon(sock, capacity=2, freq=FREQ, device="cpu",
                     ns_enable=False, aec_enable=False,
                     agc_enable=True, vad_enable=True)
    d.start()
    try:
        c = StreamSocketClient(sock)
        t = np.arange(PKG * 10) / FREQ
        tone = (np.sin(2 * np.pi * 300 * t) * 8000).astype(np.int16)
        c.open()
        outs = []
        for i in range(10):
            c.feed(tone[i * PKG:(i + 1) * PKG])
            pkg = c.read_pkg(timeout=TIMEOUT)
            assert pkg is not None
            assert pkg[0].shape == (PKG + N8K,)
            outs.append(pkg[0][:PKG])
        c.close()
        out = np.concatenate(outs).astype(np.float64)
        assert np.sqrt(np.mean(out[-PKG:] ** 2)) > 0
        assert out.shape == (10 * PKG,)
    finally:
        d.stop()


def test_daemon_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamDaemon(str(tmp_path / "x.sock"), capacity=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_daemon.main(["--socket", str(tmp_path / "y.sock"),
                            "--capacity", "2"])


def test_step_timer_matches_wmix_tpu(monkeypatch):
    """The port's own copy of StepTimer summarizes the same samples as
    the original does."""
    from wmix_tpu.utils import trace as jax_trace
    rng = np.random.RandomState(1)
    samples = [float(x) for x in rng.gamma(2.0, 8.0, 41)]
    a, b = trace.StepTimer(budget_ms=20.0), jax_trace.StepTimer(20.0)
    assert a.summary() == b.summary() == {"n": 0}
    for t in (a, b):
        t.samples.extend(samples)
        t.overruns = sum(s > 20.0 for s in samples)
    assert a.summary() == b.summary()
    with a.step():
        pass
    assert a.summary()["n"] == 42
    a.reset()
    assert a.summary() == {"n": 0} and a.overruns == 0
    for val, want in (("", False), ("0", False), ("1", True)):
        monkeypatch.setenv("WMIX_TRACE_STEPS", val)
        assert trace.steps_enabled() is want
        assert jax_trace.steps_enabled() is want


def test_profile_and_annotate_write_a_trace(tmp_path):
    with trace.profile(str(tmp_path / "prof")) as prof:
        with trace.annotate("wmix-span"):
            torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any(e.key == "wmix-span" for e in prof.key_averages())
