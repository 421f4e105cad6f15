"""wmix_tpu_torch at the geometries beyond 16 kHz mono: VAD, AGC, the zoom
pattern and the AEC planner against wmix_tpu.

VAD and AGC are integer code: at 8, 16 and 32 kHz, mono and stereo, the
outputs and every state leaf are bit-equal to the JAX functions on the
same seeded packages (B = 2 streams x 6 packages of 20 ms, amplitudes
switching between silence, speech level and near full scale, so that the
truncating stereo downmix sees both signs, the VAD flips and the limiter
engages).  The zoom index of every (freq, chn) the chain builds equals the
reference's.  The AEC planner is a copy: its plans equal the reference's
tick by tick at 8 and 16 kHz over start-up plus 100 packages (numpy only).
NS at these geometries is in test_torch_ns_geometries.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

B, P = 2, 6
GEOMETRIES = [(f, c) for f in (8000, 16000, 32000) for c in (1, 2)]


def packages(freq, chn, seed=11, n_pkgs=P, batch=B):
    """[P, B, 20 ms * chn] int32 holding int16 values, interleaved."""
    rng = np.random.RandomState(seed + freq // 1000 + chn)
    n = freq // 1000 * 20
    amp = rng.choice([0.0, 300.0, 3000.0, 30000.0], size=(n_pkgs, batch, 1, 1))
    amp[0] = 3000.0
    t = np.arange(n)[:, None] / freq
    tone = np.sin(2 * np.pi * rng.uniform(150, 3000,
                                          size=(n_pkgs, batch, 1, chn)) * t)
    x = amp * (0.6 * tone + 0.4 * rng.randn(n_pkgs, batch, n, chn))
    return np.clip(np.round(x), -32768, 32767).astype(np.int32).reshape(
        n_pkgs, batch, n * chn)


def assert_state_equal(port_st, jax_sts):
    """The port's batched state against the JAX states of its streams."""
    for f in type(port_st)._fields:
        want = np.stack([np.asarray(getattr(st, f)) for st in jax_sts])
        np.testing.assert_array_equal(getattr(port_st, f).numpy(), want,
                                      err_msg=f)


def run_both(jstep, jst0, tstep, tst, pkgs):
    """The packages through the JAX step, stream by stream, and through
    the port's batched step.  The JAX wrapper runs op by op; its core
    (one subpackage) is what the caller has jitted, one program per rate
    whatever the channel count."""
    jsts = [jst0] * pkgs.shape[1]
    jouts, touts = [], []
    for pkg in pkgs:
        ys = []
        for b in range(len(jsts)):
            jsts[b], y = jstep(jsts[b], jnp.asarray(pkg[b]))
            ys.append(np.asarray(y))
        jouts.append(np.stack(ys))
        tst, y = tstep(tst, torch.from_numpy(pkg))
        touts.append(y.numpy())
    return jsts, np.stack(jouts), tst, np.stack(touts)


@pytest.fixture(scope="module")
def jitted_cores():
    """`wmix_tpu`'s per-subpackage cores under `jax.jit` for the module's
    life, so that the wrappers around them (downmix, subpackage loop,
    mute, upmix), which are what changes with the geometry, can run
    eagerly.  Integer code: the results do not depend on where the jit
    boundary lies."""
    from wmix_tpu.dsp import agc, vad
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vad, "calc_vad", jax.jit(vad.calc_vad, static_argnums=2))
        mp.setattr(agc, "process_digital",
                   jax.jit(agc.process_digital, static_argnums=2))
        yield


@pytest.mark.parametrize("freq,chn", GEOMETRIES)
def test_vad_bit_equal(freq, chn, jitted_cores):
    from wmix_tpu.dsp import vad as J
    from wmix_tpu_torch.dsp import vad as T
    jsts, jout, tst, tout = run_both(
        lambda s, x: J.process(s, x, chn, freq), J.init_state(),
        lambda s, x: T.process(s, x, chn, freq),
        T.init_state(B, device="cpu"), packages(freq, chn))
    np.testing.assert_array_equal(tout, jout)
    assert_state_equal(tst, jsts)
    assert tout.shape[-1] == freq // 1000 * 20 * chn
    if chn == 2:        # the mono result goes to both channels
        np.testing.assert_array_equal(tout[..., 0::2], tout[..., 1::2])


@pytest.mark.parametrize("freq,chn", GEOMETRIES)
def test_agc_bit_equal(freq, chn, jitted_cores):
    from wmix_tpu.dsp import agc as J
    from wmix_tpu_torch.dsp import agc as T
    jsts, jout, tst, tout = run_both(
        lambda s, x: J.process_pkg(s, x, chn, freq, 5), J.init_state(),
        lambda s, x: T.process_pkg(s, x, chn, freq, 5),
        T.init_state(B, device="cpu"), packages(freq, chn))
    np.testing.assert_array_equal(tout, jout)
    assert_state_equal(tst, jsts)
    assert np.abs(tout).max() > 20000     # the loud packages reached AGC


def test_vad_short_package_passes_through():
    """A 10 ms package at 16 kHz is shorter than the wrapper's 20 ms
    subpackage: nothing runs, the package and the state come back as they
    were (the reference's behaviour, which the chain relies on)."""
    from wmix_tpu_torch.dsp import vad as T
    st = T.init_state(B, device="cpu")
    pkg = torch.from_numpy(packages(16000, 1)[0][:, :160])
    st2, out = T.process(st, pkg, 1, 16000)
    assert torch.equal(out, pkg)
    assert all(torch.equal(a, b) for a, b in zip(st2, st))


def test_downmix_truncates_toward_zero():
    from wmix_tpu_torch.dsp.intops import downmix
    x = torch.tensor([[-3, 0, 3, 0, -1, -2, 5, -2, -32768, -32768]],
                     dtype=torch.int32)
    assert downmix(x, 2).tolist() == [[-1, 1, -1, 1, -32768]]
    assert downmix(x, 1) is x


@pytest.mark.parametrize("freq,chn", GEOMETRIES)
@pytest.mark.parametrize("interval_ms", [10, 20])
def test_zoom_index_equal(freq, chn, interval_ms):
    from wmix_tpu.engine.chain import RecordChain as JaxChain
    from wmix_tpu_torch.engine.chain import RecordChain
    kw = dict(interval_ms=interval_ms, chn=chn, ns_enable=False,
              aec_enable=False, agc_enable=False, vad_enable=False)
    jc = JaxChain(1, freq, **kw)
    ch = RecordChain(1, freq, device="cpu", **kw)
    if jc.zoom_idx is None:
        assert ch.zoom_idx is None and (freq, chn) == (8000, 1)
        assert ch.n8k == ch.pkg_len
    else:
        np.testing.assert_array_equal(ch.zoom_idx.numpy(), jc.zoom_idx)
        assert ch.n8k == len(jc.zoom_idx) == 8 * interval_ms
    assert (ch.pkg_len, ch.fifo_pkgs, ch.sub_len) == \
        (jc.pkg_len, jc.fifo_pkgs, jc.sub_len)


@pytest.mark.parametrize("freq", [8000, 16000])
def test_planner_plans_equal_tick_by_tick(freq):
    from wmix_tpu.engine import aec_plan as J
    from wmix_tpu.engine import aec_step as JS
    from wmix_tpu_torch.engine import aec_plan as T
    from wmix_tpu_torch.engine import aec_step as TS
    jp, tp = J.AecPlanner(freq), T.AecPlanner(freq)
    assert (jp.mult, jp.nlp_mode) == (tp.mult, tp.nlp_mode)
    sigs = set()
    for tick in range(110):
        a, b = jp.plan_pkg(), tp.plan_pkg()
        assert a.signature() == b.signature(), tick
        sigs.add(b.signature())
        da, db = JS.pack_dyn(a, 64), TS.pack_dyn(b, 64)
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=f"{tick} {k}")
    assert len(sigs) > 2        # start-up, irregular and steady plans seen


@pytest.mark.parametrize("interval_ms,aec_interval_ms",
                         [(20, 400), (10, 400), (20, 0), (20, 100)])
def test_fifo_slots_equal(interval_ms, aec_interval_ms):
    """`_plan_tick`'s add and get slots over two turns of the FIFO."""
    from wmix_tpu.engine.chain import RecordChain as JaxChain
    from wmix_tpu_torch.engine.chain import RecordChain
    kw = dict(interval_ms=interval_ms, aec_interval_ms=aec_interval_ms,
              ns_enable=False, aec_enable=False, agc_enable=False,
              vad_enable=False)
    jc = JaxChain(1, 16000, **kw)
    ch = RecordChain(1, 16000, device="cpu", **kw)
    for tick in range(2 * ch.fifo_pkgs + 3):
        assert ch._plan_tick()[:2] == jc._plan_tick()[:2], tick
