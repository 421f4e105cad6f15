"""wmix_tpu_torch AEC block math in exact mode against wmix_tpu's, bit for
bit.

At 16 kHz (mult 2) and 8 kHz (mult 1) the port's own fast-mode `AecBatch`
adapts a state over 22 packages of seeded far-end audio and a near end
that holds its echo; the state is carried to the JAX side by name.  From
it, `process_block_kernel` runs on both sides in exact mode (WMIX_EXACT=1,
x64 on the JAX side) with each flag combination the plans use after
start-up, two blocks in a row: the 64 output samples and every leaf of
`AecDev` are bit-equal.  `time_to_frequency_pair` is held the same way on
the far-end ring's content.  So the JAX side compiles one block program
per rate (flags traced), not a chain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

B = 2
N_ADAPT = 22
# (noise_sel_init, noise_gate_open, update_delay_idx) after start-up
FLAGS = [(1, 0, 0), (1, 1, 0), (1, 1, 1), (0, 1, 0), (0, 1, 1)]


def _audio(freq, seed=3):
    rng = np.random.RandomState(seed)
    n = freq // 1000 * 20
    far = rng.randn(N_ADAPT + 2, B, n) * 6000
    echo = 0.5 * np.roll(far, 37, axis=2) + 0.2 * np.roll(far, 90, axis=2)
    near = echo + rng.randn(N_ADAPT + 2, B, n) * 200
    cast = lambda x: np.clip(np.round(x), -32768, 32767).astype(np.float32)
    return cast(far), cast(near)


@pytest.fixture(scope="module", params=[16000, 8000])
def adapted(request):
    """The port's fast-mode AEC after N_ADAPT packages, the next package's
    plan, and the reference's block program in exact mode."""
    freq = request.param
    from wmix_tpu.dsp import aec as J
    from wmix_tpu_torch.engine import aec_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WMIX_EXACT", "0")
        a = aec_step.AecBatch(B, freq, device="cpu")
        assert a.exact is False
        far, near = _audio(freq)
        for k in range(N_ADAPT):
            a.step(torch.from_numpy(far[k]), torch.from_numpy(near[k]))
        dyn = aec_step.pack_dyn(a.planner.plan_pkg(), a.part_cap)
        mp.setenv("WMIX_EXACT", "1")
        mp.setenv("WMIX_FAST", "0")
        mult, nlp = a.planner.mult, a.planner.nlp_mode
        block = jax.jit(jax.vmap(
            lambda d, xf, xfw, ne, r, pos, f0, f1, f2:
            J.process_block_kernel(d, xf, xfw, ne, r, pos, mult, nlp,
                                   f0, f1, f2),
            in_axes=(0, 0, 0, 0, None, None, None, None, None)))
        ttf = jax.jit(jax.vmap(J.time_to_frequency_pair.__wrapped__))
        yield dict(freq=freq, mult=mult, nlp=nlp, state=a.state, dyn=dyn,
                   near=near, block=block, ttf=ttf)


def _jax_dev(dev):
    from wmix_tpu.dsp.aec import AecDev
    return AecDev(**{f: jnp.asarray(getattr(dev, f).numpy())
                     for f in AecDev._fields})


def test_adapted_state_is_not_trivial(adapted):
    dev = adapted["state"].dev
    assert adapted["mult"] == adapted["freq"] // 8000
    assert float(dev.wf_buf.abs().max()) > 1e-3       # the filter adapted
    assert float(dev.xfw_buf.abs().max()) > 0


def test_time_to_frequency_pair_bit_equal(adapted):
    from wmix_tpu_torch.dsp.aec import time_to_frequency_pair
    seg = adapted["state"].far_pre[:, 100:228].contiguous()
    assert float(seg.abs().max()) > 100
    want = adapted["ttf"](jnp.asarray(seg.numpy()))
    got = time_to_frequency_pair(seg, exact=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fast = time_to_frequency_pair(seg, exact=False)
    assert not torch.equal(fast[1], got[1])           # the modes differ


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join(map(str, f)))
def test_process_block_kernel_bit_equal(adapted, flags):
    from wmix_tpu_torch.dsp.aec import AecDev, process_block_kernel
    st, dyn = adapted["state"], adapted["dyn"]
    tdev, jdev = st.dev, _jax_dev(st.dev)
    f0, f1, f2 = (bool(v) for v in flags)
    rng = np.random.RandomState(sum(flags))
    for blk in range(2):
        slot = int(dyn["blk_far"][blk])
        pos = int(dyn["blk_xf"][blk])
        rand = np.asarray(dyn["blk_rand"][blk], np.int32)
        xf, xfw = st.far_parts[:, slot], st.farw_parts[:, slot]
        near = torch.from_numpy(
            adapted["near"][N_ADAPT, :, blk * 64:(blk + 1) * 64] +
            np.round(rng.randn(B, 64) * 50).astype(np.float32))
        jdev, jout = adapted["block"](
            jdev, jnp.asarray(xf.numpy()), jnp.asarray(xfw.numpy()),
            jnp.asarray(near.numpy()), jnp.asarray(rand), jnp.int32(pos),
            jnp.bool_(f0), jnp.bool_(f1), jnp.bool_(f2))
        tdev, tout = process_block_kernel(
            tdev, xf, xfw, near, rand, pos, adapted["mult"], adapted["nlp"],
            f0, f1, f2, exact=True)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout),
                                      err_msg=f"block {blk} output")
        for f in AecDev._fields:
            np.testing.assert_array_equal(
                getattr(tdev, f).numpy(), np.asarray(getattr(jdev, f)),
                err_msg=f"block {blk} {f}")
    assert float(tout.abs().max()) > 0
    if f2:
        assert tdev.delay_idx.tolist() == np.asarray(jdev.delay_idx).tolist()


def test_exact_and_fast_blocks_differ(adapted):
    """The two modes are not the same arithmetic: on the adapted state
    the error spectrum's filter update differs in the last places."""
    from wmix_tpu_torch.dsp.aec import process_block_kernel
    st, dyn = adapted["state"], adapted["dyn"]
    slot, pos = int(dyn["blk_far"][0]), int(dyn["blk_xf"][0])
    args = (st.dev, st.far_parts[:, slot], st.farw_parts[:, slot],
            torch.from_numpy(adapted["near"][N_ADAPT, :, :64]),
            np.asarray(dyn["blk_rand"][0], np.int32), pos, adapted["mult"],
            adapted["nlp"], True, True, True)
    de, _ = process_block_kernel(*args, exact=True)
    df, _ = process_block_kernel(*args, exact=False)
    assert not torch.equal(de.wf_buf, df.wf_buf)
    torch.testing.assert_close(de.wf_buf, df.wf_buf, rtol=1e-3, atol=1e-5)
