"""wmix_tpu_torch RecordChain with the integer backends (NSX, AECM) bit-equal
to wmix_tpu's chain, and the chain's step timer.

Stored references.  wmix_tpu's chain with NSX or AECM costs one XLA
program per plan signature, three to thirteen CPU-minutes a case
(`tools/gen_torch_chain_ref.py`'s own timing), so its outputs and final
state (one SHA-256 per leaf) are stored under tests/data/ for
`gen_torch_chain_ref.INT_CASES`: NSX and AECM together at 16 kHz mono,
8 kHz mono and 16 kHz stereo, AECM with the float NS, the float AEC with
NSX, and NSX at 32 kHz stereo (where the chain turns the AEC off).  The
port must give the stored int16 packages and VAD flags and a final state
whose every leaf has the stored digest, taken in the reference's dtype
(for an integer leaf one of int32, uint32 and int64: under x64 the
reference widens some sums).  The chains with both integer backends run in
the port's default mode, the others in exact mode as the reference did.
A test marked `slow` runs `wmix_tpu` again and holds the files to it.

One file also holds a snapshot that `wmix_tpu` took halfway: restored
into the port, the chain runs on to the stored outputs and final state.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tools import gen_torch_chain_ref as ref  # noqa: E402
from wmix_tpu_torch.engine import checkpoint  # noqa: E402
from wmix_tpu_torch.engine.chain import RecordChain  # noqa: E402

INTEGER_ONLY = [c for c, (_f, kw, _n, _s) in ref.INT_CASES.items()
                if kw.get("aec_backend") == "aecm" and
                kw.get("ns_backend") == "nsx"]


def _load(case):
    with np.load(ref.path_of(case)) as z:
        return {k: z[k] for k in z.files}


def _chain(case, monkeypatch, batch=ref.B):
    freq, kw, _n, _seed = ref.INT_CASES[case]
    monkeypatch.setenv("WMIX_EXACT", "0" if case in INTEGER_ONLY else "1")
    return RecordChain(batch, freq, device="cpu", **kw)


def _run(ch, mic, play):
    outs = [[v.numpy().copy() for v in ch.step(mic[k], play[k])]
            for k in range(mic.shape[0])]
    return [np.stack([o[j] for o in outs]) for j in range(3)]


def _leaf_matches(x: np.ndarray, digest: str) -> bool:
    forms = [x]
    if x.dtype.kind in "iu":
        forms += [x.astype(t) for t in (np.int32, np.uint32, np.int64)]
    return any(ref.leaf_digest(f) == digest for f in forms)


def _assert_state_is_stored(state, want):
    leaves = checkpoint._leaves(state)
    assert len(leaves) == len(want["leaf_sha256"])
    bad = [str(n) for n, x, d in zip(want["leaf_names"], leaves,
                                     want["leaf_sha256"])
           if not _leaf_matches(x.numpy(), str(d))]
    assert not bad, f"state leaves differ from wmix_tpu's: {bad}"


@pytest.mark.parametrize("case", list(ref.INT_CASES))
def test_chain_equals_stored_reference(case, monkeypatch):
    want = _load(case)
    ch = _chain(case, monkeypatch)
    _freq, kw, _n, _seed = ref.INT_CASES[case]
    assert ch.ns_backend == kw.get("ns_backend", "ns")
    assert ch.aec_backend == (kw.get("aec_backend", "aec")
                              if ch.flags[1] else "aec")
    mic, play = ref.int_audio(case)
    origin, pkg8k, vflags = _run(ch, mic, play)
    assert origin.dtype == np.int16 and pkg8k.dtype == np.int16
    np.testing.assert_array_equal(origin, want["origin"])
    np.testing.assert_array_equal(pkg8k, want["pkg8k"])
    np.testing.assert_array_equal(vflags, want["vflags"])
    _assert_state_is_stored(ch.state, want)
    assert np.abs(origin[-1]).max() > 50        # not silent
    if ch.aec_backend == "aecm":
        assert ch.planner.ec_startup == 0       # the AECM ran
        assert not np.array_equal(origin[-1], mic[-1])


@pytest.mark.parametrize("freq, kw", [
    (16000, dict(aec_backend="aecm", ns_backend="nsx", chn=2)),
    (8000, dict(aec_backend="aecm", ns_backend="nsx")),
    (32000, dict(ns_backend="nsx"))])
def test_fresh_state_leaves_match_wmix_tpu(freq, kw):
    """A fresh chain's state flattens as `jax.tree_util` flattens
    `wmix_tpu`'s: the same count, order, shapes and values, int32 for int32
    and the port's int64 for uint32."""
    import jax
    from wmix_tpu.engine.chain import RecordChain as JaxChain
    got = checkpoint._leaves(RecordChain(3, freq, device="cpu", **kw).state)
    want = jax.tree_util.tree_leaves(JaxChain(3, freq, **kw).state)
    assert len(got) == len(want)
    dtypes = {np.dtype(np.int32): torch.int32, np.dtype(np.uint32):
              torch.int64, np.dtype(np.float32): torch.float32}
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == dtypes[w.dtype], i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(i))


def test_wmix_tpu_snapshot_restores_and_runs_on(monkeypatch):
    """The snapshot `wmix_tpu` took halfway through its run restores into
    the port, which then gives the stored second half and final state."""
    case = ref.SNAPSHOT_CASES[0]
    want = _load(case)
    n = ref.INT_CASES[case][2]
    ch = _chain(case, monkeypatch)
    checkpoint.restore(ch, want["snapshot"].tobytes())
    assert checkpoint._aec_layout(ch) == "aecm" and ch.tick == n // 2
    mic, play = ref.int_audio(case)
    origin, pkg8k, vflags = _run(ch, mic[n // 2:], play[n // 2:])
    np.testing.assert_array_equal(origin, want["origin"][n // 2:])
    np.testing.assert_array_equal(pkg8k, want["pkg8k"][n // 2:])
    np.testing.assert_array_equal(vflags, want["vflags"][n // 2:])
    _assert_state_is_stored(ch.state, want)
    # and the port's snapshot of the integer chain round-trips
    blob = checkpoint.snapshot(ch)
    other = _chain(case, monkeypatch)
    checkpoint.restore(other, blob)
    for x, y in zip(checkpoint._leaves(ch.state),
                    checkpoint._leaves(other.state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="aec_backend='aecm'"):
        checkpoint.restore(RecordChain(ref.B, 16000, device="cpu",
                                       ns_backend="nsx",
                                       aec_interval_ms=60), blob)
    with pytest.raises(ValueError, match="ns_backend='nsx'"):
        checkpoint.restore(RecordChain(ref.B, 16000, device="cpu",
                                       aec_backend="aecm",
                                       aec_interval_ms=60), blob)


@pytest.mark.parametrize("case", ["int_16k_mono", "int_8k_mono"])
def test_slot_equals_a_chain_of_its_own(case, monkeypatch):
    """Stream 1 of a chain of three equals a chain of one fed the same."""
    freq, kw, n, seed = ref.INT_CASES[case]
    mic, play = ref.int_audio(case)
    mic3 = np.concatenate([mic, mic[:, :1]], 1)
    play3 = np.concatenate([play, play[:, :1]], 1)
    got = _run(_chain(case, monkeypatch, 3), mic3[:8], play3[:8])
    one = _run(_chain(case, monkeypatch, 1), mic[:8, 1:2], play[:8, 1:2])
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g[:, 1:2], o)


def test_step_timer(monkeypatch):
    """With WMIX_TRACE_STEPS=1 one run_chunk of K packages is one step
    timed against K * interval_ms, as in the reference; without it the
    chain has no timer."""
    monkeypatch.setenv("WMIX_TRACE_STEPS", "1")
    ch = RecordChain(2, 16000, 10, aec_enable=False, device="cpu",
                     ns_backend="nsx")
    zeros = np.zeros((3, 2, 160), np.int16)
    ch.run_chunk(zeros, zeros)
    s = ch.step_timer.summary()
    assert s["n"] == 1 and s["budget_ms"] == 3 * 10
    ch.step(zeros[0], zeros[0])              # a step() is not timed
    assert len(ch.step_timer.samples) == 1
    monkeypatch.setenv("WMIX_TRACE_STEPS", "0")
    assert RecordChain(2, 16000, device="cpu").step_timer is None


def test_stream_server_slot_equals_the_chain(monkeypatch):
    """StreamServer passes the integer backends to its chain: a slot's
    packages equal a dedicated RecordChain's."""
    from wmix_tpu_torch.service.stream_server import StreamServer
    case = "int_16k_mono"
    _freq, kw, _n, _seed = ref.INT_CASES[case]
    mic, play = ref.int_audio(case)
    srv = StreamServer(2, 16000, device="cpu", **kw)
    assert (srv.chain.aec_backend, srv.chain.ns_backend) == ("aecm", "nsx")
    hs = [srv.open_stream() for _ in range(2)]
    want = _run(_chain(case, monkeypatch), mic[:8], play[:8])
    for t in range(8):
        srv.feed_batch(hs, mic[t], play[t])
        srv.tick()
        got = srv.read_batch(hs)
        for j in range(3):
            np.testing.assert_array_equal(got[j], want[j][t])


def test_daemon_main_serves_an_integer_chain_client(tmp_path):
    """`python -m wmix_tpu_torch.service.stream_daemon --aec-backend aecm
    --ns-backend nsx --device cpu` serves a socket client until SIGINT."""
    import signal
    import subprocess
    import sys
    from wmix_tpu_torch.service.stream_daemon import StreamSocketClient
    sock = str(tmp_path / "int.sock")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "wmix_tpu_torch.service.stream_daemon",
         "--socket", sock, "--capacity", "2", "--device", "cpu",
         "--aec-backend", "aecm", "--ns-backend", "nsx",
         "--stats-every", "0.5"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        while not any("serving" in ln for ln in lines):
            ln = proc.stdout.readline()
            assert ln, "".join(lines)
            lines.append(ln)
        assert "aecm + nsx" in lines[-1]
        c = StreamSocketClient(sock)
        c.sock.settimeout(60)
        c.open()
        mic, play = ref.int_audio("int_16k_mono")
        for k in range(6):
            c.feed(mic[k, 0], play[k, 0])
            pcm, vad = c.read_pkg(timeout=60)
            assert pcm.shape == (480,) and pcm.dtype == np.int16
            assert isinstance(vad, int)
        c.close()
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out


def test_reference_files_are_small():
    total = sum(os.path.getsize(ref.path_of(c)) for c in ref.INT_CASES)
    assert total < 400_000, total


@pytest.mark.slow
@pytest.mark.parametrize("case", list(ref.INT_CASES))
def test_stored_reference_is_what_wmix_tpu_gives(case):
    """Runs `wmix_tpu` itself (minutes a case) and holds the stored file
    to it, array by array."""
    fresh = ref.reference_run(case)
    want = _load(case)
    assert sorted(want) == sorted(fresh)
    for k in want:
        np.testing.assert_array_equal(want[k], fresh[k], err_msg=k)
