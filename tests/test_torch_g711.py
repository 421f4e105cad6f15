"""wmix_tpu_torch G.711 and EngineConfig against wmix_tpu's: the tables,
every int16 input and every code through the four device functions, and
every derived size of the config copy.  Integer code: all equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from wmix_tpu import config as jax_config  # noqa: E402
from wmix_tpu.ops import g711 as jax_g711  # noqa: E402
from wmix_tpu_torch import config  # noqa: E402
from wmix_tpu_torch.ops import g711  # noqa: E402

ALL_PCM = np.arange(-32768, 32768, dtype=np.int16)
ALL_CODES = np.arange(256, dtype=np.uint8)


def test_tables_equal():
    got, want = g711.tables(), jax_g711.tables()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("law", ["alaw", "ulaw"])
def test_encode_all_inputs(law):
    import jax.numpy as jnp
    want = np.asarray(getattr(jax_g711, f"encode_{law}")(
        jnp.asarray(ALL_PCM)))
    pcm = torch.from_numpy(ALL_PCM.copy()).reshape(256, 256)
    got = getattr(g711, f"encode_{law}")(pcm)
    assert got.dtype == torch.uint8 and got.shape == (256, 256)
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)
    np.testing.assert_array_equal(
        getattr(g711, f"np_encode_{law}")(ALL_PCM), want)
    with pytest.raises(ValueError):
        getattr(g711, f"encode_{law}")(pcm.to(torch.int32))


@pytest.mark.parametrize("law", ["alaw", "ulaw"])
def test_decode_all_codes(law):
    import jax.numpy as jnp
    want = np.asarray(getattr(jax_g711, f"decode_{law}")(
        jnp.asarray(ALL_CODES)))
    got = getattr(g711, f"decode_{law}")(torch.from_numpy(ALL_CODES.copy()))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        getattr(g711, f"np_decode_{law}")(ALL_CODES), want)
    with pytest.raises(ValueError):
        getattr(g711, f"decode_{law}")(torch.zeros(4, dtype=torch.int16))


_PROPS = ("frame_size", "frame_num", "pkg_size", "buff_size", "ring_frames",
          "play_correct", "aec_fifo_pkgs")


@pytest.mark.parametrize("make", [
    lambda m: m.EngineConfig(),
    lambda m: m.EngineConfig(chn=2, freq=44100),
    lambda m: m.EngineConfig.t31(),
    lambda m: m.EngineConfig(chn=1, freq=16000, interval_ms=10,
                             aec_backend="aecm", ns_backend="nsx"),
], ids=["default", "stereo44k1", "t31", "int_chain_10ms"])
def test_engine_config_copy_equal(make):
    got, want = make(config), make(jax_config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    props = [n for n, v in vars(jax_config.EngineConfig).items()
             if isinstance(v, property)]
    assert sorted(props) == sorted(_PROPS)
    for name in props:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("bad", [dict(sample=8), dict(interval_ms=15),
                                 dict(chn=3), dict(aec_backend="x"),
                                 dict(ns_backend="x")])
def test_engine_config_rejects_what_the_original_rejects(bad):
    with pytest.raises(ValueError):
        jax_config.EngineConfig(**bad)
    with pytest.raises(ValueError):
        config.EngineConfig(**bad)
