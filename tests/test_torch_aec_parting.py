"""Where the fast AEC leaves `wmix_tpu`, held on the CPU.

  * The port's `package_body` divides a constant by a tensor in two places
    (ScaleErrorSignal's factor, the overdrive a fired minimum sets).  Each
    is one correctly rounded float32 division, as in the reference kernel,
    the port's exact-layout body and the CUDA kernel; torch's `c / x` is
    `reciprocal(x) * c`, two roundings.
  * While the echo filter is empty the divergence test `se_sum > sd_sum`
    is a tie under a float32 ulp.  `wmix_tpu`'s Pallas package body, as
    XLA compiles it on the CPU, takes the windowed transforms of bit-equal
    near and error buffers apart in their last bits and breaks it, and
    the divergence state's 1.05 hysteresis holds the flag until the echo
    arrives: the 245-1863 LSB of `PARITY_torch_cpu.json` `aec_only`.  Its
    plain-JAX fast path and the port keep the tie; the port's fast AEC is
    held to the plain-JAX path (`tools/aec_parting.py`).
"""
import numpy as np
import pytest
import torch

from wmix_tpu_torch import parity as tp
from wmix_tpu_torch.dsp.aec import MIN_OVERDRIVE, TARGET_SUPP
from wmix_tpu_torch.engine import aec_package

EPS = np.float32(1e-10)


def _abs_ef_inputs():
    """|ef| over the range ScaleErrorSignal sees, and its edges."""
    rng = np.random.RandomState(11)
    x = (10.0 ** rng.uniform(-12, 8, 1 << 20)).astype(np.float32)
    edge = np.array([0.0, 1e-10, 1.5e-6, 2e-6, 3.4e38], np.float32)
    return np.concatenate([x, edge])


@pytest.mark.parametrize("err_th", [1.5e-6, 2e-6])
def test_error_scale_is_one_division(err_th):
    x = _abs_ef_inputs()
    c = np.float32(err_th)
    want = c / (x + EPS)
    got = aec_package.error_scale(torch.from_numpy(x), float(c)).numpy()
    np.testing.assert_array_equal(got, want)
    # the form it replaced rounds twice
    old = (float(c) / (torch.from_numpy(x) + float(EPS))).numpy()
    assert np.mean(old != want) > 0.2


@pytest.mark.parametrize("nlp_mode", [0, 1, 2])
def test_overdrive_candidate_is_one_division(nlp_mode):
    rng = np.random.RandomState(12 + nlp_mode)
    h = np.concatenate([rng.uniform(0.0, 1.0, 1 << 20),
                        10.0 ** rng.uniform(-30, 0, 1 << 16)]) \
        .astype(np.float32)
    t = torch.from_numpy(h)
    den = (torch.log(t + float(EPS)) + float(EPS)).numpy()
    want = np.maximum(TARGET_SUPP[nlp_mode] / den, MIN_OVERDRIVE[nlp_mode])
    got = aec_package.overdrive_candidate(t, nlp_mode).numpy()
    np.testing.assert_array_equal(got, want)
    old = torch.clamp_min(float(TARGET_SUPP[nlp_mode]) / torch.from_numpy(
        den), float(MIN_OVERDRIVE[nlp_mode])).numpy()
    assert np.mean(old != want) > 0.05


# ------------------------------------------- the reference's broken tie

def _empty_filter_package(batch):
    """A package state whose near and error buffers are equal, with an
    empty filter, equal smoothed near and error spectra and a silent far
    end: every block's windowed transforms of the two buffers are of
    equal inputs, so C's divergence test reads se_sum == sd_sum."""
    rng = np.random.RandomState(0)
    st = {k: v.numpy() for k, v in
          aec_package.init_package_state(batch, "cpu").items()}
    d = (rng.randn(batch, 128) * 3000).astype(np.float32)
    st["d_buf"], st["e_buf"] = d, d.copy()
    st["vecs"][:, aec_package.V_SD] = 0.0
    near = (rng.randn(batch, 320) * 3000).astype(np.float32)
    far = [np.zeros((batch, 5, 65), np.float32) for _ in range(4)]
    rand = np.zeros((5, 65), np.int32)
    flags = np.zeros((5, 3), np.int32)
    flags[:, 1] = 1
    return st, (near, *far, rand, flags)


def _se_equals_sd(vecs):
    return [bool(np.array_equal(v[aec_package.V_SE], v[aec_package.V_SD]))
            for v in vecs]


def test_wmix_tpu_pallas_form_breaks_the_divergence_tie():
    """Shown on `wmix_tpu` alone, at two streams and one package: its
    Pallas package kernel (interpret mode) gives unequal spectra and sets
    the divergence flag; the same body run op by op, and the port's
    `package_body`, keep the spectra equal and the flag clear."""
    import jax.numpy as jnp

    from wmix_tpu.engine import aec_pallas
    st, ins = _empty_filter_package(2)
    jins = [jnp.asarray(x) for x in ins]
    pallas = aec_pallas.build_package_fn(2, 2, interpret=True)
    # the kernel's jit donates the state: a fresh copy each call
    p_st, _ = pallas({k: jnp.asarray(v) for k, v in st.items()}, *jins)
    e_st, _ = aec_pallas.package_body_ref(
        {k: jnp.asarray(v) for k, v in st.items()}, *jins, mult=2,
        nlp_mode=2)
    t_st, _ = aec_package.package_body(
        {k: torch.from_numpy(v) for k, v in st.items()},
        *(torch.from_numpy(x) for x in ins))
    assert _se_equals_sd(np.asarray(p_st["vecs"])) == [False, False]
    assert np.asarray(p_st["diverge"]).ravel().tolist() == [1, 1]
    assert _se_equals_sd(np.asarray(e_st["vecs"])) == [True, True]
    assert np.asarray(e_st["diverge"]).ravel().tolist() == [0, 0]
    assert _se_equals_sd(t_st["vecs"].numpy()) == [True, True]
    assert t_st["diverge"].ravel().tolist() == [0, 0]


# ----------------------------------------------- the package-20 event

N_SCENES, N_PKGS = 8, 25


def test_port_aec_only_within_1_lsb_of_wmix_tpu_plain():
    """Scenes 0-7, packages 0-24: the echo reaches the filter at package 20
    (400 ms), where `wmix_tpu`'s Pallas form leaves its plain-JAX form by
    273, 341 and 565 LSB on streams 1, 4 and 5.  The port stays within 1
    LSB of the plain-JAX form on every sample (the stored first second of
    tools/gen_torch_parity_ref.py's 64-stream run; the port's CPU outputs
    do not depend on the batch)."""
    n = N_PKGS * 320
    plays, mics, _ = tp.build_streams(N_SCENES, n, tp.FREQ)
    got, _ = tp.config_outputs("aec_only", plays, mics, device="cpu")
    with np.load(tp.PLAIN_1S_PATH) as z:
        want = z["out"][:N_SCENES, :n]
    err = np.abs(got.astype(np.int64) - want)
    assert err.max() <= tp.PLAIN_LSB
    # the echo streams carry the onset: their output after package 20 is
    # not the microphone
    assert (got[[1, 4, 5], 20 * 320:] != mics[[1, 4, 5], 20 * 320:]).any()


def test_stored_plain_reference():
    with np.load(tp.PLAIN_1S_PATH) as z:
        out = z["out"]
    assert out.dtype == np.int16 and out.shape == (64, tp.FREQ)
    plain = tp.load_json(tp.REF_PATH)["configs"]["aec_only"][
        "wmix_tpu_plain_digest"]
    # a digest's first entry covers the first second, whatever the length
    assert [row[0] for row in tp.digest(out)] == [row[0] for row in plain]
