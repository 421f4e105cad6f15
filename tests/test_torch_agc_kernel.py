"""The AGC kernel `csrc/agc.cu` (`dsp/agc.py` `process_pkg` on CUDA
tensors) against the plain version `process_pkg_body`.

On the card (marked `cuda`; run there with `python -m pytest --noconftest
-m cuda tests/test_torch_agc_kernel.py`): outputs and every state leaf
bit-equal over 50 packages at each (freq, chn, B), with the plain
version's limiter driven past one pass, one launch a package, and
geometries without a kernel refused.  On the CPU: the per-(stream,
subframe) limiter loop the kernel runs against the batch-wide loop, the
kernel's state buffer as an AgcState, and the CPU path launching
nothing."""
import math

import numpy as np
import pytest
import torch

from wmix_tpu_torch import kernels
from wmix_tpu_torch.dsp import agc

GAIN = 5                 # RecordChain's default agc_gain_db
N_PKGS = 50


def _i32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _trunc(n: int, d: int) -> int:
    q = abs(n) // abs(d)
    return -q if (n < 0) != (d < 0) else q


def _norm_w32(a: int) -> int:
    if a == 0:
        return 0
    v = ~a if a < 0 else a
    return 32 - v.bit_length() - 1


def _limit_one(g: int, e: int):
    """One (stream, subframe) of the limiter as the kernel loops it, on
    Python ints with int32 wrap: (gain, shrinks)."""
    z = 16 - _norm_w32(g) if g > 47453132 else 10
    lim_sh = 2 * (11 - z)
    lim = 32767 << lim_sh if lim_sh >= 0 else 32767 >> -lim_sh
    e12 = (e >> 12) + 1
    shrinks = 0
    while True:
        g32 = _i32((g >> z) + 1)
        b = _i32(g32 * g32)
        limited = _i32(_i32((b >> 13) * e12) +
                       (_i32((b & 0x1FFF) * e12) >> 13))
        if limited <= lim:
            return g, shrinks
        g = _i32(_trunc(g, 256) * 253) if g > 8388607 else \
            _trunc(_i32(g * 253), 256)
        shrinks += 1


def _loud_pkgs(n_pkgs: int, batch: int, frames: int, seed: int):
    """Packages whose rows range from silence to full-scale squares."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames)
    out = np.zeros((n_pkgs, batch, frames), np.int64)
    for b in range(batch):
        for k in range(n_pkgs):
            amp = [0, 300, 8000, 20000, 32767][(b + k) % 5]
            if b % 3 == 0:
                x = np.where(t % (20 + b) < 10 + b // 2, amp, -amp)
            elif b % 3 == 1:
                x = rng.randn(frames) * amp
            else:
                x = amp * np.sin(2 * np.pi * (150 + 40 * b) * t / 16000)
            out[k, b] = np.clip(np.round(x), -32768, 32767)
    return torch.from_numpy(out).to(torch.int32)


# ------------------------------------------------------------ on the CPU

def test_limiter_per_row_loop_equals_batch_loop(monkeypatch):
    """The kernel's limiter, a loop per (stream, subframe) until that
    subframe is under its limit, equals `process_digital`'s batch-wide
    loop on the gains and envelopes of loud packages."""
    calls = []
    batch_loop = agc._limiter

    def recorded(g, env):
        out = batch_loop(g, env)
        calls.append((g.clone(), env.clone(), out.clone()))
        return out
    monkeypatch.setattr(agc, "_limiter", recorded)
    st = agc.init_state(6, "cpu")
    for pkg in _loud_pkgs(4, 6, 320, seed=11):
        st, _ = agc.process_pkg(st, pkg, 1, 16000, GAIN)
    assert len(calls) == 8                  # two subpackages a package
    shrinks = []
    for g, env, want in calls:
        for b in range(g.shape[0]):
            for k in range(10):
                got, n = _limit_one(int(g[b, k]), int(env[b, k]))
                assert got == int(want[b, k]), (b, k)
                shrinks.append(n)
    # some subframes shrink many times, others not at all: the rows leave
    # the batch-wide loop at different passes
    assert max(shrinks) > 1 and min(shrinks) == 0


def test_state_views_match_init_state():
    """The kernel's state buffer, the leaves flattened in field order,
    hands back leaves of init_state's shapes, dtypes and values, as views
    of the one buffer."""
    for batch in (1, 5, 1000):
        want = agc.init_state(batch, "cpu")
        buf = torch.cat([leaf.reshape(-1) for leaf in want])
        assert buf.shape == ((agc._N_SCALAR + 8) * batch,)
        got = agc._state_views(buf, batch)
        assert type(got) is agc.AgcState
        for name, g, w in zip(agc.AgcState._fields, got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert torch.equal(g, w), name
            assert g.is_contiguous(), name
            assert g.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr(), name


def test_cpu_process_pkg_launches_nothing():
    """On the CPU `process_pkg` is the plain version: no launch counted,
    the same outputs and state as `process_pkg_body`."""
    before = dict(kernels.launches)
    pkgs = _loud_pkgs(2, 3, 640, seed=5)
    st1 = st2 = agc.init_state(3, "cpu")
    for pkg in pkgs:
        st1, out1 = agc.process_pkg(st1, pkg, 2, 16000, GAIN)
        st2, out2 = agc.process_pkg_body(st2, pkg, 2, 16000, GAIN)
        assert torch.equal(out1, out2)
        assert all(torch.equal(a, b) for a, b in zip(st1, st2))
    assert dict(kernels.launches) == before
    if not torch.cuda.is_available():
        assert kernels.launched("agc") == 0


@pytest.mark.parametrize("freq,chn,n", [(48000, 1, 480), (16000, 3, 960),
                                        (16000, 1, 300), (16000, 2, 321),
                                        (8000, 1, 0)])
def test_kernel_refuses_geometries_it_has_no_kernel_for(freq, chn, n):
    """The kernel's wrapper raises on what the kernel does not take,
    before building or launching anything."""
    st = agc.init_state(2, "cpu")
    with pytest.raises(ValueError):
        agc._kernel_pkg(st, torch.zeros((2, n), dtype=torch.int32), chn,
                        freq, GAIN)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the AGC kernel has no CPU mode")
    return torch.device("cuda")


def _card_package(k: int, batch: int, freq: int, chn: int, dev):
    """Package k of a seeded mix on the card: noise, full-scale squares,
    tones and silence, each row at its own level package by package."""
    frames = freq // 50
    gen = torch.Generator(device=dev)
    gen.manual_seed(1_000_003 * k + 7 * freq + chn)
    rows = torch.arange(batch, device=dev)[:, None]
    t = torch.arange(frames, device=dev)[None, :]
    levels = torch.tensor([0.0, 40.0, 400.0, 4000.0, 16000.0, 32767.0],
                          device=dev)
    amp = levels[torch.randint(0, 6, (batch, 1), generator=gen, device=dev)]
    noise = torch.randn((batch, frames), generator=gen, device=dev) * amp
    square = torch.where((t + rows) % (20 + rows % 23) < 10, 32767.0,
                         -32768.0)
    tone = amp * torch.sin(2 * math.pi * (100 + rows % 300) * t / freq)
    kind = rows % 4
    x = torch.where(kind == 0, noise, torch.where(
        kind == 1, square, torch.where(kind == 2, tone,
                                       noise * (k % 3 != 0))))
    x = x.round().clamp(-32768, 32767)
    if chn == 2:
        right = (x * 0.75 + torch.randn((batch, frames), generator=gen,
                                        device=dev) * 200)
        x = torch.stack([x, right.round().clamp(-32768, 32767)], dim=2)
    return x.reshape(batch, frames * chn).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 1000, 4096])
@pytest.mark.parametrize("chn", [1, 2])
@pytest.mark.parametrize("freq", [8000, 16000, 32000])
def test_kernel_equals_body_on_card(cuda_device, freq, chn, batch,
                                    monkeypatch):
    """50 packages through the kernel and through the plain version on the
    card: the outputs and all 14 state leaves bit-equal, one launch a
    package, and the plain version's limiter past one pass."""
    reads = []
    read_bool = agc.read_bool

    def counted(t):
        reads.append(1)
        return read_bool(t)
    monkeypatch.setattr(agc, "read_bool", counted)
    st_k = st_b = agc.init_state(batch, cuda_device)
    launches = kernels.launched("agc")
    for k in range(N_PKGS):
        pkg = _card_package(k, batch, freq, chn, cuda_device)
        st_b, out_b = agc.process_pkg_body(st_b, pkg, chn, freq, GAIN)
        n_reads = len(reads)
        st_k, out_k = agc.process_pkg(st_k, pkg, chn, freq, GAIN)
        assert len(reads) == n_reads            # the kernel reads nothing
        torch.cuda.synchronize()
        assert out_k.dtype == out_b.dtype and out_k.shape == out_b.shape
        assert torch.equal(out_k, out_b), f"package {k}"
        assert torch.equal(out_k, out_k.to(torch.int16).to(torch.int32))
        for name, a, b in zip(agc.AgcState._fields, st_k, st_b):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.equal(a, b), f"package {k}: {name}"
    assert kernels.launched("agc") - launches == N_PKGS
    subpkgs = N_PKGS * (freq // 50) // (80 if freq == 8000 else 160)
    assert len(reads) > subpkgs, "the limiter never ran a second pass"


@pytest.mark.cuda
@pytest.mark.parametrize("freq,chn,n", [(48000, 1, 960), (16000, 3, 960),
                                        (16000, 1, 300)])
def test_kernel_refuses_on_card(cuda_device, freq, chn, n):
    st = agc.init_state(2, cuda_device)
    launches = kernels.launched("agc")
    with pytest.raises(ValueError):
        agc.process_pkg(st, torch.zeros((2, n), dtype=torch.int32,
                                        device=cuda_device), chn, freq, GAIN)
    assert kernels.launched("agc") == launches
