"""The harness's parts on the CPU: the call generator, the window
arithmetic, the roofline's counts and the profiled stretch's reduction."""
import math

import pytest
import torch

from wbench import harness, profiling
from wbench.drivers import served
from wbench.traffic import conversation


def _params():
    return harness.traffic("conversation.served")["params"]


def test_calls_repeat_for_a_seed_and_change_with_it():
    seed = 2 ** 31 + 12345           # more than 32 signed bits
    a = conversation.generate(16, 6, 16000, seed, _params(), "cpu")
    b = conversation.generate(16, 6, 16000, seed, _params(), "cpu")
    c = conversation.generate(16, 6, 16000, seed + 1, _params(), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    mic, play = a
    assert mic.dtype == torch.int16 and mic.shape == (6, 16, 320)


def _states(d, n_samples):
    n = torch.arange(n_samples, dtype=torch.float64)[None].expand(
        d["end"].shape[0], -1)
    idx = torch.searchsorted(d["end"], n.contiguous(), right=True)
    return d["state"].gather(1, idx.clamp(max=conversation.N_STATES - 1))


@pytest.mark.parametrize("seed", [1, 7, 2 ** 33])
def test_calls_hold_p59_shares_and_p56_levels(seed):
    """Over 256 calls of 10 s: double talk and mutual silence take P.59's
    shares of the time, each talker's active level is the P.56 level
    asked for, and the far talker is silent outside its turns."""
    p = _params()
    d, _ = conversation.draw_calls(256, 16000, seed, p, "cpu")
    assert float(d["end"][:, -1].min()) > 10 * 16000
    s = _states(d, 10 * 16000)
    share = [float((s == k).double().mean()) for k in range(4)]
    assert share[conversation.BOTH] == pytest.approx(
        p["double_talk"][1], abs=0.01)
    assert share[conversation.NEITHER] == pytest.approx(
        p["mutual_silence"][1], abs=0.02)
    mic, play = conversation.generate(256, 500, 16000, seed, p, "cpu")
    far = play.transpose(0, 1).reshape(256, -1).double()
    far_on = (s == conversation.FAR) | (s == conversation.BOTH)
    dbov = 20 * math.log10(float(far[far_on].pow(2).mean().sqrt()) / 32768)
    assert dbov == pytest.approx(p["speech_dbov"], abs=0.5)
    assert int(far[~far_on].abs().max()) == 0


def test_a_stall_lowers_streams_and_raises_the_tail():
    feed = [0.2 * j for j in range(200)]
    read = [f + 0.4 for f in feed]
    smooth = served.window_metrics(4096, feed, read, 0.0, feed[-1] + 0.4)
    # a 3 s stall at tick 100: every later tick is fed and read later
    stall = [f + (3.0 if j >= 100 else 0.0) for j, f in enumerate(feed)]
    late = [r + (3.0 if j >= 90 else 0.0) for j, r in enumerate(read)]
    stalled = served.window_metrics(4096, stall, late, 0.0, late[-1])
    assert stalled[0] < smooth[0]
    assert stalled[1] > smooth[1]
    assert smooth[0] == pytest.approx(4096 * 200 * 0.02 / 40.2)
    assert smooth[1] == pytest.approx(400.0)


def test_pct_is_the_sorted_sample():
    assert harness.pct(list(range(100)), 0.95) == 95
    assert harness.pct([3.0], 0.95) == 3.0


def test_roofline_counts_at_4096():
    roof = harness.load_module("layers", "aec_package_roofline")
    assert round(roof.package_bytes(4096) / 1e6, 2) == 220.99
    assert roof.package_flop(4096) == 4096 * 5 * (30 * (1920 + 910) + 25000)
    assert round(roof.package_flop(4096) / 1e9, 4) == 2.2508
    t, by = roof.package_bound_s(4096)
    assert by == "bytes" and round(t * 1e3, 3) == 0.066


def test_roofline_reads_nothing_without_its_kernel():
    roof = harness.load_module("layers", "aec_package_roofline")

    class Ctx:
        batch = 4096
        profile = {"kernels": {"elementwise": (10, 1.0)}}
    assert roof.read(Ctx) is None
    Ctx.profile = {"kernels": {"aec_package_kernel(Args)": (2, 2 * 66e-6)}}
    assert roof.read(Ctx) == pytest.approx(100 * 6.5967e-5 / 66e-6,
                                           rel=1e-3)


def test_stretch_reduction():
    ms = 1_000_000
    spans = [("agc", 10 * ms, 60 * ms), ("vad", 60 * ms, 90 * ms),
             ("step", 5 * ms, 95 * ms)]
    dev = [("k1", 0, 20 * ms), ("k1", 15 * ms, 30 * ms),
           ("Memcpy HtoD", 70 * ms, 80 * ms),
           ("k2", 95 * ms, 120 * ms)]             # cut at the stretch's end
    out = profiling.reduce_events(dev, spans, 0, 100 * ms)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.045)
    assert out["kernels"] == {"k1": (2, pytest.approx(0.035)),
                              "k2": (1, pytest.approx(0.005))}
    assert set(out["ops"]) == {"k1", "k2", "Memcpy HtoD"}
    idle = out["idle_by_span"]
    assert idle["agc"] == pytest.approx(0.03)        # 30..60
    assert idle["vad"] == pytest.approx(0.02)        # 60..70, 80..90
    assert idle["step"] == pytest.approx(0.005)      # 90..95
    assert "outside spans" not in idle
    assert sum(idle.values()) == pytest.approx(0.1 - out["busy_s"])


def test_device_idle_reads_the_window_not_the_stretch():
    idle = harness.load_module("layers", "device.idle")

    class Ctx:
        profile = {"busy_s": 0.25, "window_s": 5.0}
        profile_pkgs = 10
        window_pkgs = 200
        window_s = 40.0
    assert idle.read(Ctx) == pytest.approx(100 * (1 - 0.025 / 0.2))
