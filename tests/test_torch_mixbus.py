"""wmix_tpu_torch mix bus: the cases of tests/test_mixbus.py against the
port on the CPU, with `wmix_tpu`'s host mixer (`ops.mixer.load_data`,
`build_contrib`) as the reference and, for `mix_waves` and `drain`, the
JAX MixBus on the same seeded input.  All integer: rings, PCM and cursors
must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wmix_tpu.config import EngineConfig as JaxConfig  # noqa: E402
from wmix_tpu.engine import mixbus as jax_mixbus  # noqa: E402
from wmix_tpu.ops import mixer as jax_mixer  # noqa: E402
from wmix_tpu_torch.config import EngineConfig  # noqa: E402
from wmix_tpu_torch.engine import mixbus  # noqa: E402
from wmix_tpu_torch.engine.mixbus import MixBus, TaskCursor  # noqa: E402
from wmix_tpu_torch.ops.mixer import device_mix  # noqa: E402


def _bus(batch, cfg):
    return MixBus(batch, cfg, device="cpu")


def _src(seed, n_bytes):
    return np.random.RandomState(seed).randint(
        -3000, 3000, n_bytes // 2).astype(np.int16).tobytes()


def test_mix_batched_vs_host_rings():
    """B=5 engines, mixed rates/channels/reduces/heads: every engine's
    ring equals the numpy reference ring bitwise."""
    cfg = EngineConfig()
    B = 5
    bus = _bus(B, cfg)
    rings = [np.zeros((cfg.ring_frames, cfg.chn), np.int16)
             for _ in range(B)]

    specs = [  # (engine, src_freq, src_chn, head_frame, reduce)
        (0, cfg.freq, cfg.chn, 0, 1),
        (1, 16000, 1, 37, 2),
        (2, 44100, 2, 100, 1),
        (3, 8000, 2, cfg.ring_frames - 5, 3),   # wraps
        (4, 32000, 1, 9, 4),
    ]
    for wave in range(3):
        slots, heads, contribs, rdces = [], [], [], []
        for i, (e, fr, ch, h0, rd) in enumerate(specs):
            src = _src(wave * 10 + i, 2000 + 400 * i)
            c = jax_mixer.build_contrib(JaxConfig(), src, fr, ch)
            slots.append(e)
            h = (h0 + wave * 57) % cfg.ring_frames
            heads.append(h)
            contribs.append(c)
            rdces.append(rd)
            # numpy reference: same scatter arithmetic per engine
            R = cfg.ring_frames
            for s in range(0, c.shape[0], R):
                blk = c[s:s + R]
                pos = (h + s + np.arange(blk.shape[0])) % R
                q = jax_mixer._trunc_div(blk, rd)
                rings[e][pos] = np.clip(
                    rings[e][pos].astype(np.int64) + q,
                    jax_mixer.I16_MIN, jax_mixer.I16_MAX).astype(np.int16)
        bus.mix(slots, heads, contribs, rdces)

    got = bus.ring.numpy()
    assert got.dtype == np.int16
    for e in range(B):
        np.testing.assert_array_equal(got[e], rings[e],
                                      err_msg=f"engine {e}")


def test_mix_longer_than_the_ring_is_chunked():
    """A contribution of more than a ring's frames wraps onto itself,
    chunk by chunk, as the JAX bus does it."""
    cfg, jcfg = EngineConfig(), JaxConfig()
    rng = np.random.RandomState(2)
    c = rng.randint(-20000, 20000, (cfg.ring_frames + 700, cfg.chn)).astype(
        np.int16)
    a, b = _bus(2, cfg), jax_mixbus.MixBus(2, jcfg)
    ha = a.mix([1], [cfg.ring_frames - 9], [c], [1])
    hb = b.mix([1], [cfg.ring_frames - 9], [c], [1])
    np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(a.ring.numpy(), np.asarray(b.ring))


def test_drain_copies_and_zeroes():
    cfg = EngineConfig()
    B = 3
    bus = _bus(B, cfg)
    c = jax_mixer.build_contrib(JaxConfig(), _src(7, 4 * cfg.pkg_size),
                                cfg.freq, cfg.chn)
    bus.mix([0, 1, 2], [0, 10, 20], [c, c, c], [1, 1, 1])
    before = bus.ring.numpy().copy()
    pcm = bus.drain(n_pkgs=2)
    assert pcm.dtype == np.int16
    n = 2 * cfg.frame_num
    pos = np.arange(n) % cfg.ring_frames    # play cursors start at 0
    for e in range(B):
        np.testing.assert_array_equal(pcm[e], before[e][pos])
    after = bus.ring.numpy()
    for e in range(B):
        assert not after[e][pos].any()
    # cursors advanced
    assert (bus.head_off == (n % cfg.ring_frames) * cfg.frame_size).all()
    assert (bus.tick == 2 * cfg.pkg_size).all()
    with pytest.raises(ValueError):
        bus.drain(mixbus.MAX_DRAIN_PKGS + 1)


def test_task_cursor_matches_load_data():
    """One engine driven through MixBus + TaskCursor equals
    wmix_tpu.ops.mixer.load_data (ring bitwise + cursor/tick)."""
    cfg, jcfg = EngineConfig(), JaxConfig()
    bus = _bus(2, cfg)
    cur = TaskCursor(cfg)
    ref_ring = np.zeros((cfg.ring_frames, cfg.chn), np.int16)
    ref_head, ref_tick = -1, 0
    eng_head_off, eng_tick = 0, 0
    for i in range(4):
        src = _src(100 + i, 3000)
        # reference path
        ref_head, ref_tick = jax_mixer.load_data(
            jcfg, ref_ring, ref_head, eng_head_off, eng_tick, 1,
            src, 16000, 1, 16, 0, ref_tick)
        # batched path (engine slot 1; slot 0 stays silent)
        c = jax_mixer.build_contrib(jcfg, src, 16000, 1)
        h = cur.place(eng_head_off, eng_tick)
        new_h = bus.mix([1], [h], [c], [1])[0]
        cur.advance(int(new_h), c.size * 2, eng_head_off, eng_tick)
        assert (cur.head_off, cur.tick) == (ref_head, ref_tick), i
    got = bus.ring.numpy()
    np.testing.assert_array_equal(got[1], ref_ring)
    assert not got[0].any()


def test_task_cursor_matches_wmix_tpu():
    """The copied TaskCursor walks like the original, late starts and
    ring wrap included."""
    cfg, jcfg = EngineConfig(chn=2, freq=44100), JaxConfig(chn=2, freq=44100)
    a, b = TaskCursor(cfg), jax_mixbus.TaskCursor(jcfg)
    rng = np.random.RandomState(4)
    eng_head, eng_tick = 0, 0
    for _ in range(40):
        assert a.place(eng_head, eng_tick) == b.place(eng_head, eng_tick)
        frame = int(rng.randint(0, cfg.ring_frames))
        written = int(rng.randint(1, 3000)) * cfg.frame_size
        a.advance(frame, written, eng_head, eng_tick)
        b.advance(frame, written, eng_head, eng_tick)
        assert (a.head_off, a.tick) == (b.head_off, b.tick)
        eng_tick += int(rng.randint(0, 3)) * cfg.pkg_size
        eng_head = (eng_head + cfg.pkg_size) % cfg.buff_size


def test_has_data_and_reset():
    cfg = EngineConfig()
    bus = _bus(3, cfg)
    c = jax_mixer.build_contrib(JaxConfig(), _src(9, 800), cfg.freq, cfg.chn)
    bus.mix([1], [0], [c], [1])
    flags = bus.has_data()
    assert flags.dtype == bool and list(flags) == [False, True, False]
    bus.head_off[:] = 160
    bus.tick[:] = 320
    bus.reset_slots([1])
    assert not bus.has_data().any()
    assert bus.head_off[1] == 0 and bus.tick[1] == 0
    assert bus.head_off[0] == 160  # untouched engines keep cursors


@pytest.mark.parametrize("chn, freq", [(1, 8000), (2, 16000)])
def test_mix_waves_matches_sequential_mix_and_wmix_tpu(chn, freq):
    """The S-wave call (mix_waves) must leave the ring byte-identical to
    S sequential mix() calls (the same saturating add order per engine)
    and to the JAX bus on the same input; loud waves, so sums saturate,
    and divisors up to 3 on negative samples, so the divide truncates."""
    cfg, jcfg = EngineConfig(chn=chn, freq=freq), JaxConfig(chn=chn,
                                                            freq=freq)
    B, S = 5, 3
    rng = np.random.RandomState(11)
    pkg = cfg.frame_num
    waves = rng.randint(-30000, 30000, (S, B, pkg, cfg.chn)).astype(
        np.int16)
    heads = rng.randint(0, cfg.ring_frames, (S, B)).astype(np.int64)
    heads[0, 0] = cfg.ring_frames - 3       # wraps
    heads[1:, 0] = heads[0, 0]              # and piles up
    lens = rng.randint(1, pkg + 1, (S, B)).astype(np.int32)
    lens[:, 1] = 0                          # an engine without a source
    rdces = rng.randint(1, 4, (S, B)).astype(np.int32)

    seq = _bus(B, cfg)
    slots = np.arange(B, dtype=np.int32)
    for s in range(S):
        # mask to the per-engine valid length like the dense lane does
        contribs = [waves[s, b, :lens[s, b]] for b in range(B)]
        seq.mix(slots, heads[s], contribs, rdces[s])

    dense = _bus(B, cfg)
    dense.mix_waves(heads, waves, lens, rdces)
    ref = jax_mixbus.MixBus(B, jcfg)
    ref.mix_waves(heads, waves, lens, rdces)

    np.testing.assert_array_equal(dense.ring.numpy(), seq.ring.numpy())
    np.testing.assert_array_equal(dense.ring.numpy(), np.asarray(ref.ring))
    assert np.abs(dense.ring.numpy().astype(np.int32)).max() == 32768 or \
        dense.ring.numpy().max() == 32767       # something saturated
    assert not dense.ring.numpy()[1].any()

    # and the drains of both buses agree, cursors included
    for n in (1, 2):
        np.testing.assert_array_equal(dense.drain(n), np.asarray(ref.drain(n)))
        np.testing.assert_array_equal(dense.head_off, ref.head_off)
        np.testing.assert_array_equal(dense.tick, ref.tick)
    np.testing.assert_array_equal(dense.ring.numpy(), np.asarray(ref.ring))
    np.testing.assert_array_equal(dense.has_data(), ref.has_data())


def test_drain_async_pipeline_matches_blocking_drain():
    cfg = EngineConfig()
    B = 3
    rng = np.random.RandomState(5)
    pkg = cfg.frame_num
    w = rng.randint(-2000, 2000, (1, B, pkg, cfg.chn)).astype(np.int16)
    hd = np.zeros((1, B), np.int64)
    ln = np.full((1, B), pkg, np.int32)
    rd = np.ones((1, B), np.int32)

    a, b = _bus(B, cfg), _bus(B, cfg)
    pend, outs_b = [], []
    for t in range(6):
        base = (t * pkg) % cfg.ring_frames
        a.mix_waves(hd + base, w, ln, rd)
        pend.append(a.drain_async(1))
        b.mix_waves(hd + base, w, ln, rd)
        outs_b.append(b.drain(1))
    outs_a = [np.asarray(p) for p in pend]
    for x, y in zip(outs_a, outs_b):
        assert x.shape == (B, pkg, cfg.chn) and x.any()
        np.testing.assert_array_equal(x, y)


def test_device_mix_matches_wmix_tpu():
    """`device_mix` against the original's, with negative contributions
    and rdce 2 (the truncation case), a wrap and saturation."""
    import jax.numpy as jnp
    R, chn = 400, 2
    rng = np.random.RandomState(8)
    ring0 = rng.randint(-32768, 32768, (R, chn)).astype(np.int16)
    contrib = rng.randint(-32768, 32768, (300, chn)).astype(np.int16)
    contrib[:4, 0] = (-3, -1, 3, 1)       # trunc: -1, 0, 1, 0; floor: -2, -1
    ring0[R - 2:, 0] = 0
    ring0[:2, 0] = 0
    for rdce in (1, 2, 3):
        want = np.asarray(jax_mixer.device_mix(
            jnp.asarray(ring0), jnp.int32(R - 2), jnp.asarray(contrib),
            jnp.int32(rdce)))
        ring = torch.from_numpy(ring0.copy())
        got = device_mix(ring, R - 2, torch.from_numpy(contrib), rdce)
        assert got is ring
        np.testing.assert_array_equal(ring.numpy(), want)
        if rdce == 2:
            assert ring[R - 2:, 0].tolist() + ring[:2, 0].tolist() == \
                [-1, 0, 1, 0]
    with pytest.raises(ValueError):
        device_mix(torch.zeros((4, 1), dtype=torch.int16), 0,
                   torch.zeros((5, 1), dtype=torch.int16), 1)


def test_mixbus_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MixBus(2, EngineConfig())
