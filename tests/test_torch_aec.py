"""wmix_tpu_torch AEC against wmix_tpu: the host planner copy, the
exact-layout engine, the layout converter and the package body (the
kernel's plain version), on the `_drive` scene of test_aec_pallas.py.

The JAX side runs fast mode (WMIX_FAST=1) with the Pallas kernel in
interpret mode, as the JAX package's own tests run it on the CPU; one
module-scoped reference run is shared by the tests.  Tolerances:
start-up passthrough bit-identical, then rel <= 1e-4 per package (float32
reassociation, as test_aec_pallas.py:49-54); the converter only moves
data, so it is bit-equal.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

B, P = 2, 10
REL = 1e-4


def _drive(P, B, seed=42):
    rng = np.random.RandomState(seed)
    far = (rng.randn(P, B, 320) * 4000).astype(np.float32)
    near = (np.roll(far, 2, axis=0) * 0.3 +
            rng.randn(P, B, 320) * 800).astype(np.float32)
    return far, near


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _np_tree(x):
    return jax.tree_util.tree_map(lambda v: np.array(v), x)


@pytest.fixture(scope="module")
def ref():
    """wmix_tpu reference run: AecBatch (exact layout) and AecBatchPallas
    (kernel layout, interpret mode) over the scene, plus one more steady
    package worth of kernel inputs and the state before it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WMIX_FAST", "1")
        from wmix_tpu.engine.aec_step import AecBatch, pack_dyn
        from wmix_tpu.engine.aec_pallas import (
            AecBatchPallas, BLOCKS_PER_PKG, PART_LEN1, _far_fn_cached,
            _np_dyn, convert_eng_state, package_body_ref)

        far, near = _drive(P + 1, B)
        a = AecBatch(B, 16000)
        out_a, eng_states, dyns = [], [], []
        for p in range(P):
            # the state before package p, and package p's plan
            eng_states.append(_np_tree(a.state))
            dyns.append(pack_dyn(copy.deepcopy(a.planner).plan_pkg(),
                                 a.part_cap))
            out_a.append(np.asarray(a.step(jnp.asarray(far[p]),
                                           jnp.asarray(near[p]))))

        b = AecBatchPallas(B, 16000, tile=B, interpret=True)
        out_b = [np.asarray(b.step(far[p], near[p])) for p in range(P)]

        # the next steady package, by hand: far body, then the kernel in
        # interpret mode and the plain-jax reference from the same state
        plan = b.planner.plan_pkg()
        sig = plan.signature()
        dyn = pack_dyn(plan, b.part_cap)
        far_fn = _far_fn_cached(sig, b.sub_len)
        _pre, fp, fwp = far_fn(jnp.array(b.far_pre), jnp.array(b.far_parts),
                               jnp.array(b.farw_parts),
                               jnp.asarray(far[P]), _np_dyn(dyn))
        slots = jnp.asarray(dyn["blk_far"], jnp.int32)
        xf5 = np.asarray(jnp.take(fp, slots, axis=1))
        xfw5 = np.asarray(jnp.take(fwp, slots, axis=1))
        rand65 = np.concatenate([np.zeros((BLOCKS_PER_PKG, 1), np.int32),
                                 dyn["blk_rand"]], axis=1).astype(np.int32)
        flags = np.asarray(dyn["blk_flags"], np.int32)
        ins = (near[P], xf5[:, :, :PART_LEN1], xf5[:, :, PART_LEN1:],
               xfw5[:, :, :PART_LEN1], xfw5[:, :, PART_LEN1:], rand65, flags)
        pstate = _np_tree(b.pstate)
        k_state, k_out = b._pkg_fn(
            jax.tree_util.tree_map(jnp.array, pstate),
            *[jnp.asarray(v) for v in ins])
        r_state, r_out = package_body_ref(
            jax.tree_util.tree_map(jnp.array, pstate),
            *[jnp.asarray(v) for v in ins], mult=2, nlp_mode=2)

        # the converter at the first steady package (package 3)
        conv = _np_tree(convert_eng_state(
            jax.tree_util.tree_map(jnp.asarray, eng_states[3]), dyns[3]))
    return dict(far=far, near=near, out_a=out_a, out_b=out_b,
                eng_states=eng_states, dyns=dyns, conv=conv,
                pkg_state=pstate, pkg_ins=ins,
                k_state=_np_tree(k_state), k_out=np.asarray(k_out),
                r_state=_np_tree(r_state), r_out=np.asarray(r_out))


def test_planner_copy_equal():
    from wmix_tpu.engine.aec_plan import AecPlanner as J
    from wmix_tpu.engine.aec_step import pack_dyn as jdyn
    from wmix_tpu_torch.engine.aec_plan import AecPlanner as T
    from wmix_tpu_torch.engine.aec_step import pack_dyn as tdyn
    pj, pt = J(16000), T(16000)
    for tick in range(3 + 100):
        a, b = pj.plan_pkg(), pt.plan_pkg()
        assert a.signature() == b.signature(), tick
        da, db = jdyn(a, 64), tdyn(b, 64)
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(db[k], da[k],
                                          err_msg=f"tick {tick} {k}")


def test_exact_layout_matches(ref):
    from wmix_tpu_torch.engine.aec_step import AecBatch
    a = AecBatch(B, 16000, device="cpu")
    worst = 0.0
    for p in range(P):
        out = a.step(torch.from_numpy(ref["far"][p]),
                     torch.from_numpy(ref["near"][p])).numpy()
        if p < 3:       # startup passthrough
            np.testing.assert_array_equal(out, ref["out_a"][p])
        worst = max(worst, _rel(out, ref["out_a"][p]))
    assert worst <= REL, worst


def test_convert_eng_state_bit_equal(ref):
    from wmix_tpu_torch.dsp.aec import AecDev
    from wmix_tpu_torch.engine.aec_package import (STATE_FIELDS,
                                                   convert_eng_state)
    from wmix_tpu_torch.engine.aec_step import AecEngState
    src = ref["eng_states"][3]
    eng = AecEngState(
        dev=AecDev(**{f: torch.from_numpy(np.array(getattr(src.dev, f)))
                      for f in AecDev._fields}),
        **{f: torch.from_numpy(np.array(getattr(src, f)))
           for f in AecEngState._fields if f != "dev"})
    got = convert_eng_state(eng, ref["dyns"][3])
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), ref["conv"][k],
                                      err_msg=k)


def test_package_body_matches_reference_kernel(ref):
    """One steady package from the adapted state carried over from the
    JAX run (>= 5 steady packages in), against the Pallas kernel in
    interpret mode and against package_body_ref."""
    from wmix_tpu_torch.engine.aec_package import STATE_FIELDS, package_body
    state = {k: torch.from_numpy(np.array(v))
             for k, v in ref["pkg_state"].items()}
    ins = [torch.from_numpy(np.ascontiguousarray(v))
           for v in ref["pkg_ins"]]
    st, out = package_body(state, *ins, mult=2, nlp_mode=2)
    assert np.abs(ref["pkg_state"]["wf_re"]).max() > 0   # adapted filter
    for name, want_st, want_out in (("kernel", ref["k_state"], ref["k_out"]),
                                    ("ref", ref["r_state"], ref["r_out"])):
        assert _rel(out.numpy(), want_out) <= REL, name
        for k in STATE_FIELDS:
            r = _rel(st[k].numpy(), want_st[k])
            assert r <= REL, (name, k, r)


def test_package_path_matches_and_cancels_echo(ref):
    """The port's AecBatchPackage (plain version on the CPU) on the scene:
    within rel 1e-4 of the reference's AecBatchPallas per package, and
    the echo guard of test_aec_pallas.py:57-59."""
    from wmix_tpu_torch.engine.aec_package import AecBatchPackage
    b = AecBatchPackage(B, 16000, device="cpu")
    worst = 0.0
    for p in range(P):
        out = b.step(torch.from_numpy(ref["far"][p]),
                     torch.from_numpy(ref["near"][p])).numpy()
        worst = max(worst, _rel(out, ref["out_b"][p]))
    assert worst <= REL, worst
    near_e = float((ref["near"][P - 1] ** 2).mean())
    out_e = float((out ** 2).mean())
    assert out_e < near_e


# The kernel's FFT form (warp-level 64-point complex FFT plus split/merge,
# `kernel_rfft_ref` / `kernel_irfft_ref`) against the `_dft_mats` products
# of `package_body`, one case per transform the kernel runs.  Seeded numpy
# input; rel <= 1e-5 of the largest value (float32, two summation orders).
FFT_REL = 1e-5


def _fft_case(kind):
    from wmix_tpu_torch.engine import aec_package as ap
    c = ap._mats_on("cpu")
    rng = np.random.RandomState(5)
    n = 7

    def t(*shape, scale=3000.0):
        return torch.from_numpy((rng.randn(n, *shape) * scale).astype(
            np.float32))
    zeros = torch.zeros(n, 64)
    P1 = 65
    if kind in ("forward_full", "forward_windowed"):
        x = t(128)
        col = 0 if kind == "forward_full" else 2 * P1
        if kind == "forward_windowed":
            win = torch.cat([c["win_a"], c["win_b"]], dim=1)
            got = ap.kernel_rfft_ref(x * win)
        else:
            got = ap.kernel_rfft_ref(x)
        want = x @ c["m128"][:, col:col + 2 * P1]
        return torch.cat(got, dim=1), want
    if kind == "forward_zero_e":
        e = t(64)
        return (torch.cat(ap.kernel_rfft_ref(torch.cat([zeros, e], 1)), 1),
                e @ c["m64"])
    if kind == "forward_h_zero":
        h = t(64, scale=1e-3)
        want = h @ c["mf64"]
        want[:, P1:] *= c["imask"]
        return (torch.cat(ap.kernel_rfft_ref(torch.cat([h, zeros], 1)), 1),
                want)
    re, im = t(P1), t(P1)
    if kind == "inverse_lower_half":
        want = re @ c["mab"][:, :64] + im @ c["mab"][:, 64:]
        return ap.kernel_irfft_ref(re, im)[:, :64], want
    if kind == "inverse_upper_half":
        return (ap.kernel_irfft_ref(re, im)[:, 64:],
                torch.cat([re, im], 1) @ c["mgy"])
    assert kind == "output_inverse_neg_im"
    want = re @ c["mgo"][:, :128] - im @ c["mgo"][:, 128:]
    return ap.kernel_irfft_ref(re, im, negate_im=True), want


@pytest.mark.parametrize("kind", [
    "forward_full", "forward_windowed", "forward_zero_e", "forward_h_zero",
    "inverse_lower_half", "inverse_upper_half", "output_inverse_neg_im"])
def test_kernel_fft_form_matches_dft_mats(kind):
    got, want = _fft_case(kind)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= FFT_REL * scale, kind


def test_kernel_fft_round_trip_is_identity():
    """inverse(forward(x)) returns x: the 2/128 scale and the packing of
    the two directions agree."""
    from wmix_tpu_torch.engine import aec_package as ap
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.randn(5, 128) * 1000).astype(np.float32))
    back = ap.kernel_irfft_ref(*ap.kernel_rfft_ref(x))
    assert float((back - x).abs().max()) <= FFT_REL * float(x.abs().max())
