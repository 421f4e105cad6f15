"""The port's tracer (`wmix_tpu_torch/utils/trace.py`) and its spans in
the program, on the CPU: nothing recorded while it is off, the chain's
results untouched by it, the chain's and the stream server's spans where
the benchmark's readers look for them, and the attribution of device
time to spans (`wbench/attribution.py`) on fixed events.  The one
`cuda` test checks on the card that the profiler's launch events share
the spans' clock."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wbench import attribution, harness  # noqa: E402
from wmix_tpu_torch.dsp import agc as agc_mod  # noqa: E402
from wmix_tpu_torch.engine.chain import RecordChain, _tree_zip  # noqa: E402
from wmix_tpu_torch.service.stream_server import StreamServer  # noqa: E402
from wmix_tpu_torch.utils import trace  # noqa: E402
from wmix_tpu_torch.utils.trace import Interval  # noqa: E402

FREQ = 16000
PKG = 320
STAGES = {"fast": ("chain.plan", "chain.ns", "chain.aec", "chain.agc",
                   "chain.vad"),
          "integer": ("chain.plan", "chain.nsx", "chain.aecm", "chain.agc",
                      "chain.vad")}
CHAINS = {"fast": {}, "integer": dict(aec_backend="aecm", ns_backend="nsx")}


@pytest.fixture
def tracer():
    """The tracer on and empty; off and empty again afterwards."""
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def _pcm(rng, n, scale=3000):
    return (rng.randn(n, 2, PKG) * scale).astype(np.int16)


def test_off_records_nothing():
    trace.disable()
    trace.reset()
    assert trace.span("a") is trace.span("b", 7)      # one shared object
    with trace.span("a", 1) as sp:
        with trace.span("b"):
            assert sp is None
    agc_mod.process_pkg(agc_mod.init_state(2, "cpu"),
                        torch.zeros(2, PKG, dtype=torch.int32), 1, FREQ, 5)
    snap = trace.snapshot()
    assert snap == {"intervals": [], "totals": {}}


_RUNS = {}


def _run_chain(kind: str, on: bool, n_pkgs: int = 7):
    """(outputs, final state, the tracer's snapshot) of a 2-slot chain
    over n_pkgs packages: start-up, the irregular package, and steady
    ones (the package body of the kernel, on the CPU)."""
    key = (kind, on)
    if key not in _RUNS:
        rng = np.random.RandomState(11)
        mic, play = _pcm(rng, n_pkgs), _pcm(rng, n_pkgs, 5000)
        chain = RecordChain(2, FREQ, device="cpu", **CHAINS[kind])
        trace.reset()
        (trace.enable if on else trace.disable)()
        try:
            outs = [chain.step(mic[k], play[k]) for k in range(n_pkgs)]
            snap = trace.snapshot()
        finally:
            trace.disable()
            trace.reset()
        _RUNS[key] = outs, chain.state, snap
    return _RUNS[key]


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_chain_is_bit_equal_with_tracing_on(kind):
    outs_off, st_off, snap_off = _run_chain(kind, False)
    outs_on, st_on, snap_on = _run_chain(kind, True)
    assert snap_off["intervals"] == [] and snap_on["intervals"]
    for a, b in zip(outs_off, outs_on):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    leaves = []

    def same(x, y):
        leaves.append(1)
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    _tree_zip(same, st_off, st_on)
    assert len(leaves) > 20


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_step_spans_nest_under_one_tick(kind):
    _, _, snap = _run_chain(kind, True)
    ivs = snap["intervals"]
    steps = [iv for iv in ivs if iv.name == "chain.step"]
    assert [iv.req for iv in steps] == list(range(7))
    assert all(iv.parent is None for iv in steps)
    for step in steps:
        kids = [iv for iv in ivs if iv.parent == "chain.step"
                and iv.req == step.req]
        assert tuple(iv.name for iv in kids) == STAGES[kind]
        for iv in kids:
            assert iv.thread == step.thread
            assert step.start_ns <= iv.start_ns <= iv.end_ns <= step.end_ns
    inner = {iv.name: iv.parent for iv in ivs
             if iv.name in ("agc.limiter", "turns.read")}
    assert inner == {"agc.limiter": "chain.agc", "turns.read": "agc.limiter"}


def test_limiter_and_read_spans_count_the_passes(tracer, monkeypatch):
    """Loud square waves make the limiter pass more than once a
    subpackage; one `agc.limiter` span a pass, one `turns.read` a read."""
    reads = []
    read_bool = agc_mod.read_bool

    def counted(t):
        reads.append(1)
        return read_bool(t)
    monkeypatch.setattr(agc_mod, "read_bool", counted)
    st = agc_mod.init_state(2, "cpu")
    square = torch.where(torch.arange(PKG) % 40 < 20, 32000, -32000)
    pkg = torch.stack([square, square // 3]).to(torch.int32)
    for _ in range(6):
        st, _ = agc_mod.process_pkg(st, pkg, 1, FREQ, 5)
    totals = tracer.snapshot()["totals"]
    assert len(reads) > 12          # two subpackages a package
    assert totals["agc.limiter"][1] == len(reads)
    assert totals["turns.read"][1] == len(reads)


def test_served_ticks_are_stamped_in_order(tracer):
    srv = StreamServer(2, FREQ, max_depth=2, device="cpu", ns_enable=False,
                       aec_enable=False)
    rng = np.random.RandomState(3)
    mic, play = _pcm(rng, 6), _pcm(rng, 6)
    srv.start_drain_thread()
    try:
        handles = [srv.open_stream() for _ in range(2)]
        got = 0
        for k in range(6):
            srv.feed_batch(handles, mic[k], play[k])
            srv.tick_pipelined(2)
            got += srv.read_batch(handles) is not None
        srv.flush_pipeline()
        while srv.read_batch(handles) is not None:
            got += 1
    finally:
        srv.stop_drain_thread()
    assert got == 6
    ivs = tracer.snapshot()["intervals"]
    ticks = {}
    for iv in ivs:
        if iv.name.startswith("stream_server.") and iv.req is not None:
            ticks.setdefault(iv.req, {})[iv.name] = iv
    assert sorted(ticks) == list(range(6))
    main = {iv.thread for iv in ivs if iv.name == "stream_server.feed"}
    for t, s in ticks.items():
        feed, pump = s["stream_server.feed"], s["stream_server.pump"]
        deliver, read = s["stream_server.deliver"], s["stream_server.read"]
        assert feed.end_ns <= pump.start_ns <= pump.end_ns <= \
            deliver.start_ns <= deliver.end_ns <= read.end_ns
        assert {feed.thread, pump.thread, read.thread} == main
        assert deliver.thread not in main
        assert sum(iv.name == "chain.step" and
                   pump.start_ns <= iv.start_ns <= pump.end_ns
                   for iv in ivs) == 1

    # the benchmark's readers over the same spans, as one window
    ctx = type("Ctx", (), dict(window_end_epoch=time.time() + 1,
                               window_s=3600.0, window_pkgs=6))()
    layer = {n: harness.load_module("layers", n).read(ctx)
             for n in ("server.inflight_ms", "server.unread_ms",
                       "agc.limiter_passes", "chain.read_wait_ms",
                       "chain.self_ms")}

    def gap(a, b):
        return np.mean([(s[b].end_ns - s[a].end_ns) / 1e6
                        for s in ticks.values()])
    assert layer["server.inflight_ms"] == pytest.approx(
        gap("stream_server.pump", "stream_server.deliver"))
    assert layer["server.unread_ms"] == pytest.approx(
        gap("stream_server.deliver", "stream_server.read"))
    assert layer["agc.limiter_passes"] >= 2.0
    assert layer["chain.read_wait_ms"] > 0
    steps = [iv for iv in ivs if iv.name == "chain.step"]
    kids = [iv for iv in ivs if iv.parent == "chain.step"]
    assert layer["chain.self_ms"] == pytest.approx(
        (sum(iv.end_ns - iv.start_ns for iv in steps) -
         sum(iv.end_ns - iv.start_ns for iv in kids)) / 1e6 / 6)


# ------------------------------------------------ device time by span

def _iv(name, s, e, thread=7, parent=None):
    return Interval(name, s, e, thread, parent, None)


SPANS = [_iv("chain.step", 0, 100), _iv("chain.ns", 10, 40, 7, "chain.step"),
         _iv("chain.agc", 50, 90, 7, "chain.step"),
         _iv("agc.limiter", 60, 70, 7, "chain.agc"),
         _iv("stream_server.deliver", 0, 100, 8)]
# (name, start, end, correlation); a copy is not a kernel
DEVICE = [("k_step", 1000, 1010, 1), ("k_ns", 1010, 1040, 2),
          ("k_lim", 1040, 1045, 3), ("Memcpy DtoH", 1045, 1047, 4),
          ("k_late", 1050, 1060, 5), ("k_drain", 1060, 1061, 6),
          ("k_orphan", 1061, 1062, 9)]
# (start, end, thread, correlation) of the runtime calls
LAUNCHES = [(5, 6, 7, 1), (15, 16, 7, 2), (65, 66, 7, 3), (69, 70, 7, 4),
            (120, 121, 7, 5), (20, 21, 8, 6)]


def _same(got, want):
    """{span: [seconds, kernels]}: the same keys, kernels and (to the
    rounding of a sum) seconds."""
    assert sorted(got) == sorted(want)
    for k, (s, n) in want.items():
        assert got[k][1] == n and got[k][0] == pytest.approx(s), k


def test_device_by_span_is_exact():
    mine = attribution.device_by_span(DEVICE, LAUNCHES, SPANS)
    _same(mine, {"chain.step": [10e-9, 1], "chain.ns": [30e-9, 1],
                 "agc.limiter": [7e-9, 1], attribution.OUTSIDE: [10e-9, 1],
                 "stream_server.deliver": [1e-9, 1],
                 attribution.UNLINKED: [1e-9, 1]})
    assert sum(k for _, k in mine.values()) == 6     # the Memcpy is none
    mine = attribution.device_by_span(DEVICE, LAUNCHES, SPANS, 1005, 1042)
    _same(mine, {"chain.step": [5e-9, 1], "chain.ns": [30e-9, 1],
                 "agc.limiter": [2e-9, 1]})


def test_layer_files_leave_the_tracer_off_outside_the_benchmark():
    """Loading the layer files that read the program's spans turns the
    tracer on only in the benchmark's own process (`python3 -m
    wbench.run`), not in a test that loads them."""
    trace.disable()
    for m in harness.bench_spec()["per_layer"]:
        harness.load_module("layers", m["name"])
    assert trace.span("x") is trace.span("y")       # the off no-op
    with trace.span("x"):
        pass
    assert trace.snapshot()["intervals"] == []


@pytest.mark.cuda
def test_launches_lie_inside_their_span(tracer):
    """On the card: every runtime launch of a span's kernels lies inside
    that span on the spans' clock, and each kernel is attributed to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launch events come from the card")
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(1 << 20, device="cuda")
    (x * 2.0 + 1.0).sum()
    torch.cuda.synchronize()
    tracer.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            with tracer.span("probe", i):
                (x * 2.0 + 1.0).sum()
        torch.cuda.synchronize()
    device, launches = attribution.profile_rows(prof)
    probes = [iv for iv in tracer.snapshot()["intervals"]
              if iv.name == "probe"]
    kernels = [d for d in device if not d[0].startswith("Memcpy")]
    assert len(kernels) >= 40 and len(launches) >= len(kernels)
    for s, e, thread, _ in launches:
        assert any(p.start_ns <= s and e <= p.end_ns and
                   p.thread & attribution.THREAD_BITS == thread
                   for p in probes), (s, e, thread)
    mine = attribution.device_by_span(device, launches, probes)
    assert set(mine) == {"probe"}
