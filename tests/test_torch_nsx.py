"""wmix_tpu_torch.dsp.nsx, the fixed-point noise suppressor, bit-equal to
the reference.

The oracle is the numpy `NoiseSuppressionFixed` of wmix_tpu/dsp/nsx.py,
the one tests/test_nsx_jnp.py holds `nsx_jnp` to bit for bit (itself held
to the compiled C by tests/test_nsx.py); it needs no compile.  Every
block's output and every state leaf must be equal, at 8, 16 and 32 kHz,
mono and stereo (the channels as bands), through start-up and zero-input
blocks; the start-up transitions and the 512-block histogram refresh are
reached by setting the same counters on both sides.

`nsx_jnp` itself is held to the port through the stored chain references
of tests/test_torch_chain_int.py; the direct comparison with
`nsx_jnp.process_pkg` (16 kHz, B = 2) costs its JAX program a CPU-minute
and more, so it is marked `slow`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu.dsp.nsx import NoiseSuppressionFixed  # noqa: E402
from wmix_tpu_torch.dsp import nsx  # noqa: E402


def _scene(blk, n_blocks, nb, seed, fs):
    """The scene of tests/test_nsx_jnp.py: a gated tone per band with
    noise, and three zero blocks on band 0."""
    rng = np.random.RandomState(seed)
    t = np.arange(blk * n_blocks) / fs
    sigs = []
    for c in range(nb):
        s = (np.sin(2 * np.pi * (300 + 120 * c) * t) * 2500 *
             (np.sin(2 * np.pi * 0.5 * t + c) > -0.3) +
             rng.randn(blk * n_blocks) * 400)
        sigs.append(np.clip(s, -32768, 32767).astype(np.int64))
    sigs[0][18 * blk:21 * blk] = 0
    return sigs


def _host_state(h) -> dict:
    """The numpy oracle's state in NsxState's layout, as int64 values
    (uint32 fields masked)."""
    ml, ana = h.magn_len, h.ana_len

    def m(x):
        return np.asarray(x, np.int64) & 0xFFFFFFFF
    out = {
        "analysis_buffer": h.analysis_buffer[:ana],
        "synthesis_buffer": h.synthesis_buffer[:ana],
        "data_buf_hb": h.data_buf_hb[:, :ana],
        "noise_est_quantile": h.noise_est_quantile[:ml],
        # the C indexes the estimate rows at s * magn_len
        "noise_est_log_quantile":
            h.noise_est_log_quantile[:3 * ml].reshape(3, ml),
        "noise_est_density": h.noise_est_density[:3 * ml].reshape(3, ml),
    }
    for name in nsx.NsxState._fields:
        if name not in out:
            v = getattr(h, name)
            out[name] = v[:ml] if isinstance(v, np.ndarray) and \
                v.shape == (129,) else v
    return {k: (m(v) if k in nsx.U32_FIELDS else np.asarray(v, np.int64))
            for k, v in out.items()}


def _check_state(st, host, where):
    hs = _host_state(host)
    for name in nsx.NsxState._fields:
        got = getattr(st, name)[0].numpy().astype(np.int64)
        np.testing.assert_array_equal(got, hs[name],
                                      err_msg=f"{where}: state {name}")


def _run(fs, nb, n_blocks, mode=2, surgery=None):
    host = NoiseSuppressionFixed(fs)
    host.set_policy(mode)
    st = nsx.init_state(1, fs, "cpu", mode)
    blk = host.block_len_10ms
    sigs = _scene(blk, n_blocks, nb, seed=fs % 97, fs=fs)
    for k in range(n_blocks):
        if surgery and k in surgery:
            st = surgery[k](host, st)
        bands = np.stack([s[k * blk:(k + 1) * blk] for s in sigs])
        outs_h = [np.zeros(blk, np.int64) for _ in range(nb)]
        host.process([b.copy() for b in bands], outs_h)
        st, out = nsx.process_block(
            st, torch.from_numpy(bands[None].astype(np.int32)), fs, mode,
            nb)
        assert out.dtype == torch.int32 and out.shape == (1, nb, blk)
        for c in range(nb):
            np.testing.assert_array_equal(
                out[0, c].numpy().astype(np.int64), outs_h[c],
                err_msg=f"fs={fs} band {c} block {k}")
        _check_state(st, host, f"fs={fs} block {k}")
    for name, x in zip(st._fields, st):
        assert x.dtype == (torch.int64 if name in nsx.U32_FIELDS
                           else torch.int32), name
    return st


@pytest.mark.parametrize("fs, nb, n_blocks", [(16000, 1, 40), (8000, 1, 40),
                                              (16000, 2, 30), (32000, 2, 30),
                                              (8000, 2, 25)])
def test_block_equals_numpy_oracle(fs, nb, n_blocks):
    _run(fs, nb, n_blocks)


def test_mode0_no_gain_map():
    _run(16000, 1, 30, mode=0)


def _set(**fields):
    """Set the same counters on the oracle and the port's state."""
    def fn(host, st):
        for k, v in fields.items():
            if isinstance(v, np.ndarray):
                getattr(host, k)[:len(v)] = v
                val = torch.from_numpy(v.astype(np.int32))[None]
            else:
                setattr(host, k, v)
                val = torch.full_like(getattr(st, k), v)
            st = st._replace(**{k: val})
        return st
    return fn


def test_startup_transitions_and_histogram_refresh():
    """Crosses END_STARTUP_SHORT (50) and END_STARTUP_LONG (200), then the
    512-block refresh of the feature thresholds from populated
    histograms, with the zero-input blocks in between."""
    rng = np.random.RandomState(5)

    def hist(peak):
        h = rng.randint(0, 4, 1000)
        h[peak - 3:peak + 4] += rng.randint(20, 90, 7)
        return h.astype(np.int64)

    surgery = {
        4: _set(block_index=46),
        12: _set(block_index=196),
        16: _set(cnt_thres_update=509, hist_lrt=hist(6),
                 hist_spec_flat=hist(40), hist_spec_diff=hist(25)),
        22: _set(cnt_thres_update=510, hist_lrt=hist(30),
                 hist_spec_flat=hist(12), hist_spec_diff=hist(500)),
    }
    st = _run(16000, 1, 28, surgery=surgery)
    assert int(st.block_index[0]) > 200


def test_batch_equals_per_stream():
    """A stream of a batch of three equals the stream alone, through start-up
    and a zero package."""
    fs, n_pkgs = 16000, 6
    rng = np.random.RandomState(12)
    pkgs = (rng.randn(n_pkgs, 3, 320) * 2500).astype(np.int16)
    pkgs[3, 2] = 0
    st = nsx.init_state(3, fs, "cpu")
    st1 = nsx.init_state(1, fs, "cpu")
    for k in range(n_pkgs):
        st, out = nsx.process_pkg(st, torch.from_numpy(pkgs[k]), 1, fs)
        st1, out1 = nsx.process_pkg(st1, torch.from_numpy(pkgs[k, 2:]), 1,
                                    fs)
        assert torch.equal(out[2:], out1)
    for name, a, c in zip(st._fields, st, st1):
        assert torch.equal(a[2:], c), name


@pytest.mark.slow
def test_batch_equals_per_stream_and_process_pkg_equals_nsx_jnp():
    """`nsx_jnp.process_pkg`, jitted and vmapped over B = 2 streams, and
    the port's `process_pkg` on the same 16 kHz packages: equal outputs and
    state leaves; and a stream of the batch equals the stream alone."""
    import jax
    import jax.numpy as jnp
    from wmix_tpu.dsp import nsx_jnp
    fs, B, n_pkgs = 16000, 2, 4
    rng = np.random.RandomState(11)
    pkgs = (rng.randn(n_pkgs, B, 320) * 2500).astype(np.int16)
    pkgs[2, 1] = 0
    fn = jax.jit(jax.vmap(lambda s, p: nsx_jnp.process_pkg(s, p, 1, fs)))
    jst = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) +
                                                            x.shape),
                                 nsx_jnp.init_state(fs))
    st = nsx.init_state(B, fs, "cpu")
    st1 = nsx.init_state(1, fs, "cpu")
    for k in range(n_pkgs):
        jst, jout = fn(jst, jnp.asarray(pkgs[k], jnp.int32))
        st, out = nsx.process_pkg(st, torch.from_numpy(pkgs[k]), 1, fs)
        st1, out1 = nsx.process_pkg(st1, torch.from_numpy(pkgs[k, 1:]), 1,
                                    fs)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert torch.equal(out[1:], out1)
    for name, a, b, c in zip(st._fields, st, jst, st1):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64),
                                      err_msg=name)
        assert torch.equal(a[1:], c), name
