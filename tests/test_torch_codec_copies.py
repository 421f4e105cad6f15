"""The host codec modules, tables and C front-ends that wmix_tpu_torch
keeps as copies of wmix_tpu's, held to their originals: every table equal
element for element and dtype for dtype, every module's and C source's
text equal but for the lines that name the package (and the reference
checkout's absolute path in two comments), and the copies' behaviour
equal on the streams stored under tests/data (made by
`tools/gen_torch_codec_streams.py`).
"""
import importlib
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

TABLES = ["_mp3_tables", "_aac_tables", "_sbr_tables", "_mp3_l12_tables"]
MODULES = [f"codecs/{m}.py" for m in TABLES + ["mp3", "aac", "sbr", "ps",
                                                "adts", "mp3fe", "aacfe"]] + \
    ["native/gen_mp3fe_tables.py", "native/gen_aacfe_tables.py"]
C_FILES = ["native/mp3fe.c", "native/aacfe.c", "native/mp3fe_tables.h",
           "native/aacfe_tables.h"]


def _stream(name):
    with open(os.path.join(DATA, "torch_codec_" + name), "rb") as f:
        return f.read()


def _normalize(line: str) -> str:
    """An original line as the copy must read it: the package renamed,
    the reference checkout's absolute path dropped."""
    line = re.sub(r"\bwmix_tpu\b", "wmix_tpu_torch", line)
    return re.sub(r"/\w+/reference/", "", line)


def _texts(rel):
    with open(os.path.join(REPO, "wmix_tpu", rel)) as f:
        orig = f.read()
    with open(os.path.join(REPO, "wmix_tpu_torch", rel)) as f:
        copy = f.read()
    return orig, copy


def _assert_copy(rel):
    orig, copy = _texts(rel)
    o, c = orig.splitlines(), copy.splitlines()
    assert len(o) == len(c), rel
    changed = 0
    for i, (a, b) in enumerate(zip(o, c)):
        if a != b:
            changed += 1
            assert _normalize(a) == b, f"{rel}:{i + 1}"
    assert copy.endswith("\n") == orig.endswith("\n")
    return changed


def _equal_values(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_values(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal_values(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal(name):
    orig = importlib.import_module(f"wmix_tpu.codecs.{name}")
    copy = importlib.import_module(f"wmix_tpu_torch.codecs.{name}")
    names = [n for n in vars(orig) if not n.startswith("_") and
             not callable(getattr(orig, n)) and
             not isinstance(getattr(orig, n), type(np))]
    assert names
    assert sorted(names) == sorted(
        n for n in vars(copy) if not n.startswith("_") and
        not callable(getattr(copy, n)) and
        not isinstance(getattr(copy, n), type(np)))
    for n in names:
        _equal_values(getattr(orig, n), getattr(copy, n), f"{name}.{n}")


@pytest.mark.parametrize("rel", MODULES)
def test_module_text_equal_but_the_package_name(rel):
    changed = _assert_copy(rel)
    if rel.startswith("codecs/_") and rel != "codecs/_mp3_dct32.py":
        assert changed == 0


@pytest.mark.parametrize("rel", C_FILES)
def test_c_sources_equal(rel):
    _assert_copy(rel)


def test_dct32_equal_but_its_torch_branch():
    """The SSA statements, MUL and SHIFT are the reference's; only the
    branch that converts a non-numpy input differs (torch for jax)."""
    orig, copy = _texts("codecs/_mp3_dct32.py")
    code = lambda s: s[s.index("import numpy as np"):]   # noqa: E731
    want = _normalize(code(orig))
    for a, b in [("        import jax.numpy as jnp\n"
                  "        x = x.astype(jnp.int32)\n"
                  "        stack = lambda rows: jnp.stack(rows)\n",
                  "        import torch\n"
                  "        x = x.to(torch.int32)\n"
                  "        stack = lambda rows: torch.stack(rows)\n"),
                 ("native to numpy and jax alike", "native to numpy and "
                  "torch alike")]:
        assert a in want
        want = want.replace(a, b)
    assert code(copy) == want


def test_native_mp3_front_end_equal():
    """(header, sbsample) of every Layer III frame from the port's C
    front-end and from the reference's."""
    from wmix_tpu.codecs import mp3fe as ref
    from wmix_tpu_torch.codecs import mp3fe
    data = _stream("mp3_l3.mp3")
    want = list(ref.frames_sbsample(data))
    got = list(mp3fe.frames_sbsample(data))
    assert len(got) == len(want) == 80
    for i, ((hw, sw), (hg, sg)) in enumerate(zip(want, got)):
        assert [getattr(hg, k) for k in hg.__slots__] == \
            [getattr(hw, k) for k in hw.__slots__], f"frame {i}"
        np.testing.assert_array_equal(sg, sw, err_msg=f"frame {i}")
    with pytest.raises(mp3fe.UnsupportedLayer):
        list(mp3fe.frames_sbsample(_stream("mp3_l2.mp3")))


@pytest.mark.parametrize("name", ["aac_44k_stereo.aac", "aac_32k_mono.aac"])
def test_native_aac_front_end_equal(name):
    """(jobs, nch, freq, emit) of every frame from the port's C front-end
    and from the reference's; the spectra bit for bit."""
    from wmix_tpu.codecs import aacfe as ref
    from wmix_tpu_torch.codecs import aacfe
    data = _stream(name)
    a, b = ref.NativeAacFront(data), aacfe.NativeAacFront(data)
    n = 0
    while True:
        want, got = a.next_frame(), b.next_frame()
        if want is None:
            assert got is None
            break
        (jw, *mw), (jg, *mg) = want, got
        assert mg == mw, f"frame {n}"
        assert [j[:3] for j in jg] == [j[:3] for j in jw], f"frame {n}"
        for x, y in zip(jg, jw):
            np.testing.assert_array_equal(x[3].view(np.uint32),
                                          y[3].view(np.uint32))
        n += 1
    assert n > 50
    with pytest.raises(aacfe.Unsupported):
        aacfe.NativeAacFront(_stream("aac_8k_mono.aac")).next_frame()


@pytest.mark.parametrize("name", ["mp3_l3.mp3", "mp3_l2.mp3"])
def test_python_mp3_front_end_equal(name):
    """The copied Python decoder: subband samples and PCM of every frame
    as the reference's."""
    from wmix_tpu.codecs.mp3 import Mp3Decoder as Ref
    from wmix_tpu_torch.codecs.mp3 import Mp3Decoder
    data = _stream(name)
    want = list(Ref().frames(data, 24))
    got = list(Mp3Decoder().frames(data, 24))
    assert len(got) == len(want) == 24
    for i, ((pw, rw, cw), (pg, rg, cg)) in enumerate(zip(want, got)):
        assert (rg, cg) == (rw, cw)
        np.testing.assert_array_equal(pg, pw, err_msg=f"frame {i}")


@pytest.mark.parametrize("name,frames", [("aac_32k_mono.aac", 20),
                                         ("aac_8k_mono.aac", 4)])
def test_python_aac_decoder_equal(name, frames):
    """The copied AacDecoder frame for frame as the reference's; at 8 kHz
    it upsamples through the copied SBR path (implicit signalling)."""
    from wmix_tpu.codecs.aac import AacDecoder as Ref
    from wmix_tpu_torch.codecs.aac import AacDecoder
    data = _stream(name)
    ref, port = Ref(), AacDecoder()
    pos = 0
    for i in range(frames):
        want = ref.decode(data[pos:])
        got = port.decode(data[pos:])
        assert got[1:] == want[1:], f"frame {i}"
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"frame {i}")
        pos += want[1]
    assert port.force_up == (name == "aac_8k_mono.aac")


@pytest.mark.slow
def test_stored_streams_regenerate():
    """tools/gen_torch_codec_streams.py makes the stored streams again,
    byte for byte."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import gen_torch_codec_streams as gen
    for name, make in gen.STREAMS.items():
        assert make() == _stream(name), name
