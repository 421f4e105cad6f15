"""wmix_tpu_torch.dsp.intops: the integer helpers of NSX and AECM against
wmix_tpu.dsp.intops, and the port's copies of the NSX and AECM constants
and tables against their originals.

Inputs are seeded full-range int32 and uint32 values plus the edges:
zero denominators, INT32_MIN, 0xFFFFFFFF, and shift counts -32..40.  The
port holds uint32 values in int64; results are compared as values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from wmix_tpu.dsp import intops as J  # noqa: E402
from wmix_tpu_torch.dsp import intops as P  # noqa: E402

I32_EDGES = [0, 1, -1, 2, -2, 7, -7, 0x7FFFFFFF, -0x80000000, -0x7FFFFFFF,
             32767, -32768, 32768, -32769, 65535, 65536, -65536, 65537,
             0x40000000, -0x40000000]
U32_EDGES = [0, 1, 2, 3, 25, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
             0x80000001, 0xFFFFFFFE, 0xFFFFFFFF]
N = 4000


def _i32(seed):
    rng = np.random.RandomState(seed)
    full = rng.randint(-2 ** 31, 2 ** 31, N, dtype=np.int64)
    small = rng.randint(-40000, 40000, N, dtype=np.int64)
    return np.concatenate([I32_EDGES, full, small]).astype(np.int32)


def _u32(seed):
    rng = np.random.RandomState(seed)
    full = rng.randint(0, 2 ** 32, N, dtype=np.int64)
    small = rng.randint(0, 70000, N, dtype=np.int64)
    return np.concatenate([U32_EDGES, full, small]).astype(np.uint32)


def _pairs(a, b):
    """Every edge against every edge, then the seeded values pairwise."""
    ne_a = len(I32_EDGES) if a.dtype == np.int32 else len(U32_EDGES)
    ne_b = len(I32_EDGES) if b.dtype == np.int32 else len(U32_EDGES)
    ea, eb = np.meshgrid(a[:ne_a], b[:ne_b], indexing="ij")
    n = min(len(a), len(b))
    return (np.concatenate([ea.ravel(), a[:n]]),
            np.concatenate([eb.ravel(), b[:n]]))


def _t(x):
    """numpy -> the port's carrier: int32 stays, uint32 goes to int64."""
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                            else x)


def _same(got, want):
    got = got.numpy().astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    bad = np.nonzero(got != want)[0]
    assert not len(bad), f"{len(bad)} differ, first at {bad[:5]}: " \
        f"{got[bad[:5]]} != {want[bad[:5]]}"


SHIFTS = np.arange(-32, 41, dtype=np.int32)


def test_shr_u32():
    x, n = _pairs(_u32(1), SHIFTS)
    _same(P.shr_u32(_t(x), _t(n)),
          J.shr_u32(jnp.asarray(x), jnp.asarray(n.astype(np.uint32))))


def test_shift_w32():
    x, n = _pairs(_i32(2), SHIFTS)
    _same(P.shift_w32(_t(x), _t(n)), J.shift_w32(x, n))


def test_shift_u32():
    x, n = _pairs(_u32(3), SHIFTS)
    _same(P.shift_u32(_t(x), _t(n)), J.shift_u32(x, n))


@pytest.mark.parametrize("kind", ["i32", "u32"])
def test_norm_w16_and_popcount32(kind):
    x = _i32(4) if kind == "i32" else _u32(4)
    xi = x.astype(np.int32) if kind == "i32" else x
    if kind == "i32":
        _same(P.norm_w16(_t(xi)), J.norm_w16(xi))
    _same(P.popcount32(_t(x)), J.popcount32(x))


def test_mul_16_u16():
    a, b = _pairs(_i32(5), _u32(6))
    _same(P.mul_16_u16(_t(a), _t(b)), J.mul_16_u16(a, b))


@pytest.mark.parametrize("zero_result", [0xFFFFFFFF, 0, 1000, 0x7FFFFFFF])
def test_div_u32_u32(zero_result):
    num, den = _pairs(_u32(7), _u32(8))
    _same(P.div_u32_u32(_t(num), _t(den), zero_result=zero_result),
          J.div_u32_u32(num, den, zero_result=zero_result))


def test_div_w32_w16_exact():
    num, den = _pairs(_i32(9), _i32(10))
    _same(P.div_w32_w16_exact(_t(num), _t(den)),
          J.div_w32_w16_exact(num, den))


def test_div_w32_w32_exact():
    num, den = _pairs(_i32(11), _i32(12))
    got = P.div_w32_w32_exact(_t(num), _t(den))
    _same(got, J.div_w32_w32_exact(num, den))
    # INT32_MIN / -1 wraps to INT32_MIN; x / 0 is 0x7FFFFFFF
    edge = P.div_w32_w32_exact(torch.tensor([-2 ** 31, 5], dtype=torch.int32),
                               torch.tensor([-1, 0], dtype=torch.int32))
    assert edge.tolist() == [-2 ** 31, 0x7FFFFFFF]


def test_tables_equal_the_originals():
    """Every constant and table the port copied equals the original."""
    from wmix_tpu.dsp import _nsx_tables, _spl_tables
    from wmix_tpu.dsp import aecm as ref_aecm
    from wmix_tpu.dsp import nsx as ref_nsx
    from wmix_tpu_torch.dsp import _aecm_tables, _nsx_tables as port_nsx_t

    def names(mod):
        return [n for n in vars(mod) if n.isupper() or n == "_SAT_MAX"]

    checked = 0
    for port_mod in (port_nsx_t, _aecm_tables):
        for name in names(port_mod):
            got = getattr(port_mod, name)
            want = None
            for ref in (ref_nsx, _nsx_tables, ref_aecm, _spl_tables):
                if hasattr(ref, name):
                    want = getattr(ref, name)
                    break
            assert want is not None, name
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=name)
            checked += 1
    assert checked >= 90
    np.testing.assert_array_equal(_aecm_tables.K_SQRT_HANNING,
                                  _spl_tables.AECM_SQRT_HANNING)
    for stages in (7, 8):
        np.testing.assert_array_equal(_aecm_tables.bit_reverse_perm(stages),
                                      ref_aecm._bit_reverse_perm(stages))
