"""wmix_tpu_torch's AECM (dsp/aecm.py, engine/aecm_step.py) bit-equal to
the reference.

Oracles: the numpy `AecmCore` and `AecmProcessor` of wmix_tpu/dsp/aecm.py
(held to the compiled C by tests/test_aecm.py, and the ones
tests/test_aecm_batch.py holds `aecm_jnp` to) need no compile; the jitted
`aecm_jnp.process_block` costs seconds.  The planner is held to
`wmix_tpu.engine.aecm_step.AecmPlanner` tick by tick.  The JAX `AecmBatch`
compiles one program per plan signature, minutes in all, so its live
comparison is marked `slow`; the stored chain references of
tests/test_torch_chain_int.py hold the same package body bit-equal in the
default run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu.dsp import aecm as H  # noqa: E402
from wmix_tpu.dsp.aec import _rand_u_array  # noqa: E402
from wmix_tpu_torch.dsp import aecm as P  # noqa: E402
from wmix_tpu_torch.engine import aecm_step  # noqa: E402


def _echo_streams(B, n, freq, seed=3):
    """The scene of tests/test_aecm_batch.py: a far tone per stream, its
    echo 10 ms later at half level, a gated near tone and noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / freq
    fars, nears = [], []
    for b in range(B):
        far = np.sin(2 * np.pi * (300 + 50 * b) * t) * 7000
        echo = np.zeros_like(far)
        d = freq // 100
        echo[d:] = far[:-d] * 0.5
        near = (echo + np.sin(2 * np.pi * 240 * t) * 3000 *
                (np.sin(2 * np.pi * 0.8 * t + b) > 0.3) +
                rng.randn(n) * 70)
        fars.append(np.clip(far, -32768, 32767).astype(np.int16))
        nears.append(np.clip(near, -32768, 32767).astype(np.int16))
    return np.stack(fars), np.stack(nears)


def test_fft_pair_equals_host():
    rng = np.random.RandomState(1)
    x = rng.randint(-32768, 32768, (6, 128)).astype(np.int32)
    ci = rng.randint(-3000, 3000, (6, 130)).astype(np.int32)
    ci[0] = 0
    ci[1] = rng.randint(-32768, 32768, 130)      # scales every stage
    re, im = P.real_forward_fft(torch.from_numpy(x))
    out, scale = P.real_inverse_fft(torch.from_numpy(ci[:, 0::2].copy()),
                                    torch.from_numpy(ci[:, 1::2].copy()))
    for b in range(6):
        want = H.real_forward_fft(x[b].astype(np.int64))
        np.testing.assert_array_equal(re[b].numpy(), want[0::2])
        np.testing.assert_array_equal(im[b].numpy(), want[1::2])
        w_out, w_scale = H.real_inverse_fft(ci[b].astype(np.int64))
        np.testing.assert_array_equal(out[b].numpy(), w_out)
        assert int(scale[b, 0]) == w_scale


def _host_fields(core):
    """The state leaves the host core keeps under the same name and in the
    same form; its x_buf holds other samples than the batched core's (the
    host core buffers its far frames another way), so it is left out."""
    st = P.make_init_state(1, 16000, "cpu")
    return [k for k in st if hasattr(core, k) and k != "x_buf"]


@pytest.mark.parametrize("freq", [16000, 8000])
def test_process_block_equals_host_core(freq):
    """60 blocks of an echo scene: the output and every state leaf the
    host core keeps under the same name, block by block."""
    core = H.AecmCore()
    core.init(freq)
    st = P.make_init_state(1, freq, "cpu")
    fields = _host_fields(core)
    assert len(fields) >= 25
    fars, nears = _echo_streams(1, 60 * 64, freq)
    for b in range(60):
        far = fars[0, b * 64:(b + 1) * 64].astype(np.int64)
        near = nears[0, b * 64:(b + 1) * 64].astype(np.int64)
        hist_pos = core.far_history_pos + 1
        if hist_pos >= H.MAX_DELAY:
            hist_pos = 0
        tot, nc = core.tot_count, core.noise_est_ctr < 100
        rand, _ = _rand_u_array(core.seed, 64)
        want = core.process_block(far, near)
        st, out = P.process_block(
            st, torch.from_numpy(far[None].astype(np.int32)),
            torch.from_numpy(near[None].astype(np.int32)),
            torch.from_numpy(P.comfort_tables(rand)), hist_pos, tot, nc,
            freq // 8000)
        np.testing.assert_array_equal(out[0].numpy(), want,
                                      err_msg=f"block {b}")
        for k in fields:
            np.testing.assert_array_equal(
                st[k][0].numpy().astype(np.int64),
                np.asarray(getattr(core, k)).astype(np.int64),
                err_msg=f"block {b} {k}")
    assert all(v.dtype == torch.int32 for v in st.values())


def test_process_block_equals_aecm_jnp():
    """The jitted `aecm_jnp.process_block` over B = 2 streams: every state
    leaf and the output, block by block, with the start-up counter moved
    past 512 and 1024 on the way."""
    import jax
    import jax.numpy as jnp
    from wmix_tpu.dsp import aecm_jnp
    freq, B, n = 16000, 2, 24
    step = jax.jit(lambda st, f, nr, r, hp, tc, nc: aecm_jnp.process_block(
        st, f, nr, r, hp, tc, nc, mult=2))
    jst = aecm_jnp.make_init_state(B, freq)
    st = P.make_init_state(B, freq, "cpu")
    fars, nears = _echo_streams(B, n * 64, freq, seed=4)
    seed = 666
    for b in range(n):
        far = fars[:, b * 64:(b + 1) * 64].astype(np.int32)
        near = nears[:, b * 64:(b + 1) * 64].astype(np.int32)
        rand, seed = _rand_u_array(seed, 64)
        tot = b if b < 8 else (510 + b if b < 16 else 1010 + b)
        hist_pos, nc = (3 * b) % 100, b < 12
        jst, jout = step(jst, jnp.asarray(far), jnp.asarray(near),
                         jnp.asarray(np.asarray(rand, np.int32)),
                         jnp.int32(hist_pos), jnp.int32(tot),
                         jnp.bool_(nc))
        st, out = P.process_block(
            st, torch.from_numpy(far), torch.from_numpy(near),
            torch.from_numpy(P.comfort_tables(rand)), hist_pos, tot, nc, 2)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout),
                                      err_msg=f"block {b}")
        for k in jst:
            np.testing.assert_array_equal(
                st[k].numpy().astype(np.int64),
                np.asarray(jst[k]).astype(np.int64),
                err_msg=f"block {b} {k}")


@pytest.mark.parametrize("freq", [16000, 8000])
def test_planner_equals_reference_tick_by_tick(freq):
    """Start-up and 100 packages: signature, every offset of every plan,
    and every planner field, tick by tick."""
    from wmix_tpu.engine import aecm_step as ref
    a, b = aecm_step.AecmPlanner(freq), ref.AecmPlanner(freq)
    startup = 0
    for tick in range(110):
        pa, pb = a.plan_pkg(), b.plan_pkg()
        assert pa.signature() == pb.signature(), tick
        da, db = aecm_step.pack_dyn(pa), ref.pack_dyn(pb)
        assert sorted(da) == sorted(db)
        for k in da:
            np.testing.assert_array_equal(da[k], db[k],
                                          err_msg=f"tick {tick} {k}")
            assert da[k].dtype == db[k].dtype, k
        startup += all(s.startup for s in pa.subs)
        va, vb = vars(a), vars(b)
        assert sorted(va) == sorted(vb)
        for k in va:
            if isinstance(va[k], aecm_step._AbsRing):
                assert (va[k].count, va[k].r, va[k].w) == \
                    (vb[k].count, vb[k].r, vb[k].w), (tick, k)
            else:
                assert va[k] == vb[k], (tick, k)
    assert 0 < startup < 10


@pytest.mark.parametrize("freq", [16000, 8000])
def test_batch_equals_host_processor(freq):
    """AecmBatch over B = 2 streams equals the daemon wrapper's
    AecmProcessor (aec_process2, AECM branch) per stream: start-up, the
    delay compensation and the channel arbitration, 30 packages."""
    pkg = freq // 1000 * 20
    B, n = 2, 30
    fars, nears = _echo_streams(B, n * pkg, freq)
    refs = [H.AecmProcessor(1, freq, 20) for _ in range(B)]
    eng = aecm_step.AecmBatch(B, freq, device="cpu")
    for i in range(n):
        sl = slice(i * pkg, (i + 1) * pkg)
        got = eng.step(fars[:, sl], nears[:, sl])
        assert got.dtype == torch.int32 and got.shape == (B, pkg)
        for b in range(B):
            want = refs[b].process2(fars[b, sl], nears[b, sl], 0)
            np.testing.assert_array_equal(
                got[b].numpy().astype(np.int64), want.astype(np.int64),
                err_msg=f"package {i} stream {b}")


@pytest.mark.slow
@pytest.mark.parametrize("freq", [16000, 8000])
def test_batch_equals_wmix_tpu_aecm_batch(freq):
    """The port's AecmBatch and wmix_tpu's, outputs and every state leaf
    in `jax.tree_util`'s order, over 12 packages."""
    import jax
    from wmix_tpu.engine.aecm_step import AecmBatch as JaxBatch
    from wmix_tpu_torch.engine.checkpoint import _leaves
    pkg = freq // 1000 * 20
    B, n = 2, 12
    fars, nears = _echo_streams(B, n * pkg, freq, seed=6)
    jb = JaxBatch(B, freq)
    pb = aecm_step.AecmBatch(B, freq, device="cpu")
    for i in range(n):
        sl = slice(i * pkg, (i + 1) * pkg)
        np.testing.assert_array_equal(pb.step(fars[:, sl], nears[:, sl]),
                                      np.asarray(jb.step(fars[:, sl],
                                                         nears[:, sl])))
    want = jax.tree_util.tree_leaves(jb.state)
    got = _leaves(pb.state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
