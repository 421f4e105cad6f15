"""wmix_tpu_torch's EngineBridge on the CPU: the record chains of N
WmixDaemons served by ONE StreamServer batch, against the same daemons
running their processors inline (as tests/test_engine_bridge.py holds
wmix_tpu's).

* Exact mode (WMIX_EXACT=1), 8 and 16 kHz: three bridged daemons equal
  three inline daemons bit for bit.
* Fast mode, 16 kHz: the bridge's steady packages take the AEC kernel's
  layout (its plain body here, the CUDA kernel on the card) while the
  inline AEC stays in the ring layout: within 4 LSB, the fast gate.
* A daemon whose switches diverge from the bridge's falls back to its
  inline processors; the -tm self-test reads the 8 kHz ring through the
  client while the DSP runs batched (queues and rings under a private
  MSG_PATH).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import gen_torch_daemon_ref as ref  # noqa: E402

from wmix_tpu_torch.config import EngineConfig  # noqa: E402
from wmix_tpu_torch.engine import aec_package  # noqa: E402
from wmix_tpu_torch.service.core import (WR_AEC, WR_VAD,  # noqa: E402
                                         WmixDaemon)
from wmix_tpu_torch.service.engine_bridge import EngineBridge  # noqa: E402
from wmix_tpu_torch.service.hal import LoopHal  # noqa: E402

TICKS = 6
LSB = 4


def _mk_daemon(freq, seed, bridge=None, **kw):
    hal = LoopHal()
    rng = np.random.RandomState(seed)
    hal.feed_mic((rng.randn(freq * 2) * 3000).astype(np.int16).tobytes())
    d = WmixDaemon(EngineConfig(chn=1, freq=freq), hal=hal,
                   msg_queue=kw.pop("msg_queue", False),
                   shmem=kw.pop("shmem", False), device="cpu")
    for i in ref.WR_ALL:
        d.webrtc_enable[i] = 1
    d.shmem_run = 1            # a consumer holds the record path open
    if bridge is not None:
        bridge.attach(d)
    return d, hal


def _capture(d):
    got = []
    out = d._record_out
    d._record_out = lambda buf: (got.append(np.array(buf, np.int16)),
                                 out(buf))
    return got


def _bridged_and_inline(freq):
    bridge = EngineBridge(capacity=4, freq=freq, device="cpu")
    bridged, inline = [], []
    for seed in (1, 2, 3):
        db, _ = _mk_daemon(freq, seed, bridge)
        di, _ = _mk_daemon(freq, seed)
        bridged.append((db, _capture(db)))
        inline.append((di, _capture(di)))
    for _ in range(TICKS):
        for db, _ in bridged:
            db.pump(1)
        assert bridge.tick() <= 4
        for di, _ in inline:
            di.pump(1)
    for (db, _), (di, _) in zip(bridged, inline):
        assert db.dsp_bridge is bridge and bridge.accepts(db)
        bridge.detach(db)
        db.stop()
        di.stop()
    return bridge, [np.stack(g) for _, g in bridged], \
        [np.stack(w) for _, w in inline]


@pytest.mark.parametrize("freq", [8000, 16000])
def test_three_bridged_daemons_equal_inline_exact(monkeypatch, freq):
    monkeypatch.setenv("WMIX_EXACT", "1")
    bridge, got, want = _bridged_and_inline(freq)
    assert not bridge.server.chain.fast
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.shape[0] > 20, k
        np.testing.assert_array_equal(g, w, err_msg=f"daemon {k}")


def test_bridged_daemons_within_4_lsb_fast_16k(monkeypatch):
    monkeypatch.delenv("WMIX_EXACT", raising=False)
    bridge, got, want = _bridged_and_inline(16000)
    assert bridge.server.chain.fast
    # the bridge's steady packages took the kernel layout
    assert isinstance(bridge.server.chain.state.aec,
                      aec_package.PackageAecState)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.shape[0] > 20, k
        d = np.abs(g.astype(np.int32) - w.astype(np.int32)).max()
        assert d <= LSB, f"daemon {k}: {d} LSB"


def test_switch_divergence_falls_back_inline():
    """A daemon that turns a module off mid-run leaves the batch and
    keeps processing inline (reference WMT_*_SW semantics)."""
    bridge = EngineBridge(capacity=2, freq=8000, device="cpu")
    d, _ = _mk_daemon(8000, 5, bridge)
    got = _capture(d)
    for _ in range(3):
        d.pump(1)
        bridge.tick()
    n_bridged = len(got)
    assert d._webrtc[WR_VAD] is None          # nothing ran inline
    d.webrtc_enable[WR_VAD] = 0               # diverge from the batch
    assert not bridge.accepts(d)
    for _ in range(3):
        d.pump(1)
        assert bridge.tick() == 0
    assert len(got) > n_bridged, "inline fallback stopped producing"
    assert d._webrtc[WR_VAD] is None and d._webrtc[WR_AEC] is not None
    bridge.detach(d)
    assert d.dsp_bridge is None
    d.stop()


def test_tm_selftest_served_by_batch(monkeypatch):
    """The -tm self-test (wmix_mem_test, srcMsg/wmixMsg.c:110-139): the
    client reads the 1x8000 shm ring while the daemon's DSP runs
    batched."""
    import ctypes
    import shutil
    import tempfile
    from wmix_tpu_torch.service import client, sysv
    short = tempfile.mkdtemp(prefix="wm")    # a message holds 128 bytes
    path = os.path.join(short, "q")
    monkeypatch.setattr(sysv, "MSG_PATH", path)
    bridge = EngineBridge(capacity=2, freq=8000, device="cpu")
    d, hal = _mk_daemon(8000, 9, bridge, msg_queue=True, shmem=True)
    hal.feed_mic((np.random.RandomState(11).randn(8000 * 6) * 3000)
                 .astype(np.int16).tobytes())
    stop = threading.Event()

    def pump_loop():
        while not stop.is_set():
            d.pump(1)
            bridge.tick()
            time.sleep(0.001)

    t = threading.Thread(target=pump_loop, daemon=True)
    t.start()
    try:
        pcm = client.mem_1x8000(1600, wait=True)
        assert pcm.size == 1600
        assert np.abs(pcm.astype(np.int64)).max() > 100, \
            "batched record chain produced silence"
    finally:
        stop.set()
        t.join(timeout=10)
        bridge.detach(d)
        d.stop()
        libc = ctypes.CDLL(None)
        for ch in (sysv.MEM_AI_1X8000_CHAR, sysv.MEM_AI_ORIGIN_CHAR):
            shm_id = libc.shmget(sysv.ftok(path, ord(ch)), 0, 0)
            if shm_id != -1:
                libc.shmctl(shm_id, sysv.IPC_RMID, None)
        shutil.rmtree(short, ignore_errors=True)


def test_bridge_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineBridge(capacity=2, freq=16000)
