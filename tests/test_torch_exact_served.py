"""wmix_tpu_torch's exact-mode record chain served by `StreamServer`, as the
`x16k.served` cell serves it, and the spans of the exact path: `aec.block`
a block of the exact-layout AEC, `ns.window_read` the NS's countdown
check, `ns.features` the NS's histogram extraction.

What the served chain is held to:
- wmix_tpu's exact chain: the stored 16 kHz mono case of
  `tools/gen_torch_chain_ref.py`, served, gives its stored outputs and a
  final state whose every leaf has the stored digest;
- the port's `RecordChain` stepped directly (which
  test_torch_chain_exact.py holds to wmix_tpu's stored chains) on the
  cell's traffic, two-party calls from `wbench/traffic/conversation.py`
  made on the CPU: outputs and every state leaf, over 40 packages with the
  AEC's start-up; and the cell's own reference (`wbench/reference/`), which
  decides `correct` on the card.

The NS's feature window ends at its 500th block, package 250 of a 16 kHz
stream: the last test runs the port's exact NS there at B = 2 against
wmix_tpu's, live, as test_torch_ns_geometries.py does for windows brought
forward.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tools import gen_torch_chain_ref as ref  # noqa: E402
from wbench import check, harness  # noqa: E402
from wmix_tpu_torch.engine.chain import RecordChain  # noqa: E402
from wmix_tpu_torch.engine.checkpoint import _leaves  # noqa: E402
from wmix_tpu_torch.service.stream_server import StreamServer  # noqa: E402
from wmix_tpu_torch.utils import trace  # noqa: E402

CFG = harness.config("record.x16k")
FREQ = CFG["freq"]
SEED = 2 ** 32 + 17
NS_ONLY = dict(ns_enable=True, aec_enable=False, agc_enable=False,
               vad_enable=False)
STARTUP_PKGS = 4            # the AEC's pass-through packages and the first
                            # irregular one, before every package has 5 blocks


def _traffic(batch, n_pkgs):
    """(mic, play) int16 numpy [n_pkgs, batch, 320]: the cell's calls."""
    served = harness.traffic("conversation.served")
    gen = harness.load_module("traffic", served["generator"])
    mic, play = gen.generate(batch, n_pkgs, FREQ, SEED, served["params"],
                             torch.device("cpu"))
    return mic.numpy(), play.numpy()


@pytest.fixture
def spans():
    """The program's spans on for the test, and none left behind."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _by_name():
    return Counter(iv.name for iv in trace.snapshot()["intervals"])


def _serve(mic, play, depth=4, **chain_kw):
    """Every package through StreamServer as the cell serves it: every
    slot opened, `feed_batch` + `tick_pipelined` a tick, the drain thread
    on, read as ready.  The outputs stacked [n, B, ...], and the chain."""
    batch = mic.shape[1]
    srv = StreamServer(batch, FREQ, max_depth=depth, device="cpu",
                       **chain_kw)
    outs = []
    try:
        srv.start_drain_thread()
        handles = [srv.open_stream() for _ in range(batch)]

        def read_ready():
            while (got := srv.read_batch(handles)) is not None:
                outs.append(got)
        for t in range(mic.shape[0]):
            srv.feed_batch(handles, mic[t], play[t])
            srv.tick_pipelined(depth)
            read_ready()
        srv.flush_pipeline()
        read_ready()
    finally:
        srv.stop_drain_thread()
    return tuple(np.stack([o[j] for o in outs]) for j in range(3)), \
        srv.chain


def _step(mic, play, **chain_kw):
    """The same packages through the port's RecordChain, stepped."""
    ch = RecordChain(mic.shape[1], FREQ, device="cpu", **chain_kw)
    outs = [[v.numpy().copy() for v in ch.step(mic[k], play[k])]
            for k in range(mic.shape[0])]
    return tuple(np.stack([o[j] for o in outs]) for j in range(3)), ch


def test_served_exact_chain_equals_wmix_tpu_stored(monkeypatch):
    case = "16k_mono"
    freq, kw, n, _seed = ref.CASES[case]
    assert freq == FREQ
    mic, play = ref.audio(case)
    monkeypatch.setenv("WMIX_EXACT", "1")
    got, chain = _serve(mic, play, **kw)
    with np.load(ref.path_of(case)) as z:
        want = {k: z[k] for k in z.files}
    for name, g in zip(("origin", "pkg8k", "vflags"), got):
        assert g.shape[0] == n, name
        np.testing.assert_array_equal(g, want[name], err_msg=name)
    digests = [ref.leaf_digest(x.numpy()) for x in _leaves(chain.state)]
    bad = [str(nm) for nm, g, w in zip(want["leaf_names"], digests,
                                       want["leaf_sha256"]) if g != w]
    assert len(digests) == len(want["leaf_sha256"]) and not bad, bad


def test_served_exact_chain_equals_the_reference(spans, monkeypatch):
    n = 40
    mic, play = _traffic(3, n)
    monkeypatch.setenv("WMIX_EXACT", "1")
    got, served = _serve(mic, play, **CFG["chain"])
    counts = _by_name()
    ivs = trace.snapshot()["intervals"]
    per_tick = Counter(iv.req for iv in ivs if iv.name == "aec.block")
    window_reads = sum(iv.name == "turns.read" and
                       iv.parent == "ns.window_read" for iv in ivs)
    trace.disable()
    stepped, chain = _step(mic, play, **CFG["chain"])
    for name, g, w in zip(("origin", "pkg8k", "vad"), got, stepped):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for i, (a, b) in enumerate(zip(_leaves(served.state),
                                   _leaves(chain.state))):
        assert torch.equal(a, b), f"state leaf {i}"
    from wmix_tpu_torch.engine.aec_step import AecEngState
    assert isinstance(served.state.aec, AecEngState)    # never the kernel's
    cell = check.reference_outputs(CFG, mic, play, n)
    assert check.numbers(got, cell)["mismatches"] == 0
    assert np.abs(got[0]).max() > 100               # not silent
    assert not np.array_equal(got[0], mic)          # the chain worked on it
    # five 64-sample blocks a steady 20 ms package
    assert [per_tick[t] for t in range(STARTUP_PKGS, n)] == \
        [5] * (n - STARTUP_PKGS)
    assert counts["aec.block"] == sum(per_tick.values())
    # two 10 ms blocks a package: two window checks, each holding its
    # device read, and six transforms; no window ends in 40 packages
    assert counts["ns.window_read"] == window_reads == 2 * n
    assert counts["ns.rdft"] == 6 * n
    assert counts["ns.features"] == 0


@pytest.mark.parametrize("exact", [True, False])
def test_window_read_only_in_exact_mode(exact, spans, monkeypatch):
    n = 3
    mic, _ = _traffic(2, n)
    monkeypatch.setenv("WMIX_EXACT", "1" if exact else "0")
    chain = RecordChain(2, FREQ, device="cpu", **NS_ONLY)
    for t in range(n):
        chain.step(mic[t], mic[t])
    counts = _by_name()
    assert counts["ns.window_read"] == (2 * n if exact else 0)
    assert counts["ns.rdft"] == 6 * n
    assert counts["aec.block"] == 0
    # fast mode computes the extraction every block and selects it
    assert counts["ns.features"] == (0 if exact else 2 * n)


def test_exact_ns_window_fold_at_package_250(spans, monkeypatch):
    """The feature window's first end, its 500th block: the second block
    of package 249 (from 0).  The extraction runs there once, and the
    port's outputs and every NsState leaf stay bit-equal to wmix_tpu's
    exact NS (x64, jitted cores) through it."""
    from wmix_tpu.dsp import ns as J
    from wmix_tpu_torch.dsp import ns as T
    n, batch = 251, 2
    mic, _ = _traffic(batch, n)
    monkeypatch.setenv("WMIX_EXACT", "1")
    monkeypatch.setenv("WMIX_FAST", "0")
    monkeypatch.setattr(J, "analyze", jax.jit(J.analyze, static_argnums=2))
    monkeypatch.setattr(J, "process", jax.jit(J.process, static_argnums=2))
    jsts = [J.init_state(FREQ) for _ in range(batch)]
    tst = T.init_state(batch, FREQ, device="cpu")
    for t in range(n):
        want = []
        for b in range(batch):
            jsts[b], y = J.process_pkg(jsts[b], jnp.asarray(mic[t, b],
                                                            jnp.int32),
                                       1, FREQ)
            want.append(np.asarray(y))
        with trace.span("test.package", t):
            tst, got = T.process_pkg(tst, torch.from_numpy(mic[t]), 1, FREQ)
        np.testing.assert_array_equal(got.numpy(), np.stack(want),
                                      err_msg=f"package {t}")
    folds = [iv.req for iv in trace.snapshot()["intervals"]
             if iv.name == "ns.features"]
    assert folds == [249]
    assert tst.update_countdown.tolist() == [498, 498]
    for f in T.NsState._fields:
        np.testing.assert_array_equal(
            getattr(tst, f).numpy(),
            np.stack([np.asarray(getattr(st, f)) for st in jsts]),
            err_msg=f)
    assert np.abs(got.numpy()).max() > 100      # NS passed the signal
