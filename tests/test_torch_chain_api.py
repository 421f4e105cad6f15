"""wmix_tpu_torch RecordChain's constructor, guards, checkpoint header and
the server's geometry against the reference's (no JAX program is built).
"""
import inspect
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu_torch.engine import checkpoint  # noqa: E402
from wmix_tpu_torch.engine.chain import RecordChain  # noqa: E402


def test_signature_equals_the_reference_plus_device():
    from wmix_tpu.engine.chain import RecordChain as JaxChain
    want = list(inspect.signature(JaxChain.__init__).parameters.values())
    got = list(inspect.signature(RecordChain.__init__).parameters.values())
    assert got[-1].name == "device" and got[-1].default is None
    assert [(p.name, p.default, p.kind) for p in got[:-1]] == \
        [(p.name, p.default, p.kind) for p in want]


def test_positional_interval_ms():
    """The third positional argument is the package length, as in the
    reference."""
    ch = RecordChain(1, 16000, 10, aec_enable=False, device="cpu")
    assert (ch.interval_ms, ch.pkg_len, ch.flags[0]) == (10, 160, True)
    assert ch.fifo_pkgs == 400 // 10 + 2


@pytest.mark.parametrize("kw", [dict(aec_backend="aecm"),
                                dict(ns_backend="nsx")])
def test_integer_backends_name_the_roadmap_item(kw):
    """The integer backends of ROADMAP item 9 build and run, with the
    reference's backend names; a backend of a stage that is off is not
    built, as in the reference."""
    from wmix_tpu.engine.chain import RecordChain as JaxChain
    from wmix_tpu_torch.dsp.nsx import NsxState
    from wmix_tpu_torch.engine.aecm_step import AecmEngState, AecmPlanner
    ch = RecordChain(1, 16000, device="cpu", **kw)
    jc = JaxChain(1, 16000, **kw)
    assert (ch.aec_backend, ch.ns_backend) == (jc.aec_backend, jc.ns_backend)
    if "aec_backend" in kw:
        assert isinstance(ch.planner, AecmPlanner)
        assert isinstance(ch.state.aec, AecmEngState)
    else:
        assert isinstance(ch.state.ns, NsxState)
    pkg = (np.random.RandomState(1).randn(1, 320) * 3000).astype(np.int16)
    origin, pkg8k, vflags = ch.step(pkg, pkg)
    assert origin.dtype == torch.int16 and origin.shape == (1, 320)
    off = dict(aec_enable=False) if "aec_backend" in kw else \
        dict(ns_enable=False)
    ch_off = RecordChain(1, 16000, device="cpu", **kw, **off)
    jc_off = JaxChain(1, 16000, **kw, **off)
    assert (ch_off.aec_backend, ch_off.ns_backend) == \
        (jc_off.aec_backend, jc_off.ns_backend) == ("aec", "ns")
    assert ch_off.planner is None or "ns_backend" in kw


def test_reference_guards_hold():
    assert RecordChain(1, 32000, device="cpu").flags[1] is False
    assert RecordChain(1, 32000, device="cpu").planner is None
    for bad in (dict(freq=44100), dict(freq=48000), dict(chn=3),
                dict(aec_backend="x"), dict(ns_backend="x")):
        kw = dict(freq=16000, device="cpu")
        kw.update(bad)
        with pytest.raises(ValueError):
            RecordChain(1, **kw)
    with pytest.raises(ValueError, match="aec_enable=False"):
        RecordChain(1, 16000, 10, device="cpu")


@pytest.mark.parametrize("freq", [8000, 16000, 32000])
@pytest.mark.parametrize("chn", [1, 2])
def test_every_geometry_runs(freq, chn):
    ch = RecordChain(2, freq, chn=chn, device="cpu")
    n = freq // 1000 * 20 * chn
    rng = np.random.RandomState(freq + chn)
    for _ in range(2):
        pkg = (rng.randn(2, n) * 3000).astype(np.int16)
        origin, pkg8k, vflags = ch.step(pkg, pkg)
    assert origin.shape == (2, n) and origin.dtype == torch.int16
    assert pkg8k.shape == (2, 160) and vflags.shape == (2,)
    if (freq, chn) == (8000, 1):
        assert torch.equal(pkg8k, origin)           # no zoom at 8 kHz mono
    elif freq == 8000:
        assert torch.equal(pkg8k, origin[:, ::2])   # the left channel


def _header(blob):
    with np.load(io.BytesIO(blob)) as z:
        return json.loads(bytes(z["header"].tobytes()).decode())


def test_checkpoint_header_and_geometry_checks(monkeypatch):
    kw = dict(chn=2, aec_interval_ms=100, part_cap=32, device="cpu")
    a = RecordChain(2, 8000, **kw)
    pkg = np.zeros((2, 320), np.int16)
    a.step(pkg, pkg)
    blob = checkpoint.snapshot(a)
    h = _header(blob)
    assert (h["chn"], h["interval_ms"], h["aec_interval_ms"], h["part_cap"],
            h["exact"], h["freq"]) == (2, 20, 100, 32, False, 8000)
    b = RecordChain(2, 8000, **kw)
    checkpoint.restore(b, blob)
    for x, y in zip(checkpoint._leaves(a.state), checkpoint._leaves(b.state)):
        assert torch.equal(x, y)
    for other, what in ((dict(kw, chn=1), "chn"),
                        (dict(kw, aec_interval_ms=400), "aec_interval_ms"),
                        (dict(kw, part_cap=64), "part_cap")):
        with pytest.raises(ValueError, match=what):
            checkpoint.restore(RecordChain(2, 8000, **other), blob)
    c = RecordChain(2, 16000, 10, aec_enable=False, device="cpu")
    with pytest.raises(ValueError, match="interval_ms"):
        checkpoint.restore(
            RecordChain(2, 16000, aec_enable=False, device="cpu"),
            checkpoint.snapshot(c))


def test_checkpoint_across_modes(monkeypatch):
    """A ring-layout snapshot restores in the other mode (the mode changes
    no leaf); a kernel-layout snapshot does not restore into an exact-mode
    chain."""
    rng = np.random.RandomState(0)
    pkgs = (rng.randn(6, 2, 320) * 3000).astype(np.int16)
    monkeypatch.setenv("WMIX_EXACT", "1")
    e = RecordChain(2, 16000, device="cpu")
    for p in pkgs[:3]:
        e.step(p, p)
    blob = checkpoint.snapshot(e)
    assert _header(blob)["exact"] is True
    monkeypatch.setenv("WMIX_EXACT", "0")
    f = RecordChain(2, 16000, device="cpu")
    checkpoint.restore(f, blob)                     # exact -> fast: allowed
    for p in pkgs[3:]:
        f.step(p, p)
    assert checkpoint._aec_layout(f) == "pallas"    # the kernel layout
    kernel_blob = checkpoint.snapshot(f)
    monkeypatch.setenv("WMIX_EXACT", "1")
    with pytest.raises(ValueError, match="exact-mode chain"):
        checkpoint.restore(RecordChain(2, 16000, device="cpu"), kernel_blob)


@pytest.mark.parametrize("freq", [8000, 32000])
def test_stream_server_at_other_rates(freq):
    """The server's rings follow the chain's package and 8 kHz lengths;
    a slot equals a dedicated chain."""
    from wmix_tpu_torch.service.stream_server import StreamServer
    n = freq // 1000 * 20
    srv = StreamServer(2, freq, device="cpu", agc_gain_db=9)
    assert (srv.pkg_len, srv.chain.n8k, srv.chain.agc_gain_db) == (n, 160, 9)
    ded = RecordChain(2, freq, agc_gain_db=9, device="cpu")
    hs = [srv.open_stream() for _ in range(2)]
    rng = np.random.RandomState(freq)
    for _ in range(3):
        mic = (rng.randn(2, n) * 3000).astype(np.int16)
        srv.feed_batch(hs, mic, mic)
        srv.tick_pipelined(depth=1)
        want = ded.step(mic, mic)
    srv.flush_pipeline()
    got = [srv.read_batch(hs) for _ in range(3)][-1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    for kw in (dict(chn=2), dict(interval_ms=10)):
        with pytest.raises(ValueError, match="mono with 20 ms"):
            StreamServer(2, 16000, device="cpu", **kw)
