"""The VAD kernel `csrc/vad.cu` (`dsp/vad.py` `process` on CUDA tensors)
against the plain version `process_body`.

On the card (marked `cuda`; run there with `python -m pytest --noconftest
-m cuda tests/test_torch_vad_kernel.py`): outputs and every state leaf
bit-equal over 60 packages at each (freq, chn, interval_ms, B) on speech,
silence and full-scale packages from a start state whose minimum tables
are about to age out, one launch a package, a short package passed
through, and an unsupported rate refused before any launch.  On the CPU:
the kernel's per-stream minimum tracking, transcribed, against the tensor
`_find_minimum`; the kernel's per-stream code above its `__global__`
function built for the host with a C++ compiler and run against
`process_body`; the kernel's state buffer as a VadState; the CPU path
launching nothing."""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from wmix_tpu_torch import kernels
from wmix_tpu_torch.dsp import vad

N_PKGS = 60
CU = os.path.join(os.path.dirname(vad.__file__), os.pardir, "csrc", "vad.cu")


def _aged_state(batch: int, seed: int, device="cpu") -> vad.VadState:
    """init_state, with the even rows' minimum tables full of ties and
    their ages at 95-100, so that values age out within a few packages;
    frame counters 0-4 and means of their own."""
    rng = np.random.RandomState(seed)
    st = vad.init_state(batch, device="cpu")
    rows = np.arange(0, batch, 2)
    vals = st.low_value_vector.numpy().copy()
    ages = st.index_vector.numpy().copy()
    vals[rows] = np.sort(rng.choice([300, 500, 500, 800, 1200, 1200, 2000],
                                    size=(len(rows), 6, 16)), axis=2)
    ages[rows] = rng.randint(95, 101, size=(len(rows), 6, 16))
    fc = st.frame_counter.numpy().copy()
    fc[rows] = rng.randint(0, 5, size=len(rows))
    mean = st.mean_value.numpy().copy()
    mean[rows] = rng.randint(400, 2400, size=(len(rows), 6))
    st = st._replace(low_value_vector=torch.from_numpy(vals),
                     index_vector=torch.from_numpy(ages),
                     frame_counter=torch.from_numpy(fc),
                     mean_value=torch.from_numpy(mean))
    return vad.VadState(*(t.to(device) for t in st))


def _package(k: int, batch: int, freq: int, chn: int, interval_ms: int,
             seed: int) -> np.ndarray:
    """Package k of a seeded mix, int32 [batch, frames * chn]: each row
    speech-like (harmonics of a pitch under a syllable envelope, over
    noise, at its own level), all zero or full scale (squares and random
    signs holding -32768), the kind changing with the row and package."""
    rng = np.random.RandomState((seed * 7919 + k) % 2 ** 31)
    frames = freq // 1000 * interval_ms
    t = (k * frames + np.arange(frames))[None, :] / freq
    rows = np.arange(batch)[:, None]
    pitch = 100 + 7 * (rows % 17)
    env = np.maximum(np.sin(2 * np.pi * (3 + rows % 4) * t), 0) ** 2
    voice = sum(np.sin(2 * np.pi * h * pitch * t) / h for h in range(1, 9))
    level = 10.0 ** rng.uniform(1.5, 4.2, size=(batch, 1))
    speech = level * env * voice + rng.randn(batch, frames) * level * 0.05
    square = np.where((np.arange(frames) // (7 + rows % 13)) % 2, 32767,
                      -32768)
    signs = np.where(rng.rand(batch, frames) < 0.5, -32768, 32767)
    kind = (rows + k // 3) % 6
    x = np.where(kind < 3, speech, np.where(
        kind == 3, 0, np.where(kind == 4, square, signs)))
    x = np.clip(np.round(x), -32768, 32767).astype(np.int32)
    if chn == 2:
        right = np.clip(x * 0.5 + rng.randn(batch, frames) * 300, -32768,
                        32767).astype(np.int32)
        x = np.stack([x, right], axis=2).reshape(batch, frames * 2)
    return x


# ------------------------------------------------------------ on the CPU

def _find_minimum_walk(v, g, mean: int, fc: int, feature: int):
    """One band of the kernel's `find_minimum`, on Python ints in
    vad_sp.c's order: each entry ages, an entry of age 100 is removed and
    the larger ones move down, then the feature goes in before the first
    larger value; returns (values, ages, mean)."""
    v, g = list(v), list(g)
    for i in range(16):
        if g[i] != 100:
            g[i] += 1
        else:
            v[i:15], g[i:15] = v[i + 1:16], g[i + 1:16]
            v[15], g[15] = 10000, 101
    pos = sum(x <= feature for x in v)
    if pos < 16:
        v[pos + 1:], g[pos + 1:] = v[pos:15], g[pos:15]
        v[pos], g[pos] = feature, 1
    median = v[2] if fc > 2 else v[0] if fc > 0 else 1600
    alpha = (6553 if median < mean else 32439) if fc > 0 else 0
    t = (alpha + 1) * mean + (32767 - alpha) * median + 16384
    return v, g, ((t >> 15) + 32768) % 65536 - 32768


def test_find_minimum_walk_equals_tensor_form():
    """The kernel's sequential minimum tracking equals the tensor form's
    masked rolls on random states: sorted tables with ties, ages at 100
    (one or several to remove, adjacent too), features equal to entries."""
    rng = np.random.RandomState(3)
    B = 160
    vals = np.sort(rng.choice([150, 400, 400, 700, 700, 700, 1500, 10000],
                              size=(B, 6, 16)), axis=2).astype(np.int32)
    ages = np.where(rng.rand(B, 6, 16) < 0.4, 100,
                    rng.randint(1, 102, size=(B, 6, 16))).astype(np.int32)
    feature = np.where(rng.rand(B, 6) < 0.5,
                       vals[np.arange(B)[:, None], np.arange(6)[None],
                            rng.randint(0, 16, size=(B, 6))],
                       rng.randint(100, 2000, size=(B, 6))).astype(np.int32)
    feature[0] = 20000                      # above every entry: no insert
    mean = rng.randint(300, 3000, size=(B, 6)).astype(np.int32)
    fc = rng.randint(0, 5, size=B).astype(np.int32)
    got_v, got_g, got_m = vad._find_minimum(
        *(torch.from_numpy(a) for a in (vals, ages, mean, fc, feature)))
    removed = 0
    for b in range(B):
        for ch in range(6):
            v, g, m = _find_minimum_walk(vals[b, ch], ages[b, ch],
                                         int(mean[b, ch]), int(fc[b]),
                                         int(feature[b, ch]))
            assert got_v[b, ch].tolist() == v, (b, ch)
            assert got_g[b, ch].tolist() == g, (b, ch)
            assert int(got_m[b, ch]) == m, (b, ch)
            removed += int((ages[b, ch] == 100).sum())
    assert removed > 500


_SHIMS = """
#include <stdint.h>
#include <algorithm>
#define __host__
#define __device__
#define __forceinline__ inline
#define __constant__
static inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
}
using std::max;
using std::min;
"""

# a stream at a time, as a thread of the kernel walks it: stage the first
# subpackage and the minimum tables in a row, walk, store, pass the rest
_HOST_RUNNER = """
}  // namespace

template <int NB>
static void run(const Args& a, int batch, int frames, int chn, int ds) {
  const int seg = NB << ds, tables = tables_at(NB, ds);
  const int passes = frames / seg, staged = passes > 0 ? seg : 0;
  const int row_len = frames * chn;
  int32_t row[tables_at(160, 1) + 2 * MIN_W];
  for (int b = 0; b < batch; ++b) {
    const int32_t* in = a.in + static_cast<size_t>(b) * row_len;
    for (int m = 0; m < staged; ++m) row[m] = downmix(in, m, chn);
    for (int j = 0; j < MIN_W; ++j) {
      row[tables + j] = a.leaf[L_LOW][b * MIN_W + j];
      row[tables + MIN_W + j] = a.leaf[L_IDX][b * MIN_W + j];
    }
    State s;
    load_state(s, a, b);
    vad_stream<NB>(s, row, ds, passes);
    store_state(s, a.state, b, batch);
    for (int j = 0; j < MIN_W; ++j) {
      a.state[O_LOW * batch + b * MIN_W + j] = row[tables + j];
      a.state[O_IDX * batch + b * MIN_W + j] = row[tables + MIN_W + j];
    }
    int32_t* out = a.out + static_cast<size_t>(b) * row_len;
    for (int j = 0; j < row_len; ++j) {
      const int m = j / chn;
      out[j] = w16(m < staged ? row[m] : downmix(in, m, chn));
    }
  }
}

template <int LEN>
static int32_t energy(const int32_t* x, int32_t offset, int32_t* total) {
  return log_energy<LEN, 1>(x, offset, *total);
}

extern "C" int32_t vad_host_log_energy(const int32_t* x, int len,
                                       int32_t offset, int32_t* total) {
  return len == 5 ? energy<5>(x, offset, total)
         : len == 10 ? energy<10>(x, offset, total)
         : len == 20 ? energy<20>(x, offset, total)
                     : energy<40>(x, offset, total);
}

extern "C" int vad_host(void* const* ptrs, int batch, int frames, int chn,
                        int freq, int sub_len) {
  Args a;
  void** dst = reinterpret_cast<void**>(&a);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];
  const int ds = freq == 8000 ? 0 : freq == 16000 ? 1 : 2;
  if ((sub_len >> ds) == 80) run<80>(a, batch, frames, chn, ds);
  else run<160>(a, batch, frames, chn, ds);
  return kNumPtrs;
}
"""


@pytest.fixture(scope="module")
def host_vad(tmp_path_factory):
    """The part of vad.cu above the kernel, built for the host, with a
    runner that walks each stream as a thread of the kernel does."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or \
        shutil.which("c++")
    if not cxx:
        pytest.skip("no C++ compiler to build the kernel's code for the host")
    src = open(CU).read()
    body = src.split("// ------------------------------------------------"
                     "------ the kernel")[0]
    body = re.sub(r"#include <cuda_runtime.h>\n", "", body)
    d = tmp_path_factory.mktemp("vadhost")
    cpp, lib = d / "vad_host.cpp", d / "libvad_host.so"
    cpp.write_text(_SHIMS + body + _HOST_RUNNER)
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-o",
                    str(lib), str(cpp)], check=True)
    return ctypes.CDLL(str(lib))


def _host_process(fn, st, pkg, chn, freq, interval_ms):
    """`process` through the host build: (state, out) as the kernel's
    wrapper returns them."""
    sub_ms = (20 if interval_ms % 20 == 0 else 10) if freq <= 16000 else 10
    B, n = pkg.shape
    x = pkg.to(torch.int32).contiguous()
    leaves = [t.contiguous() for t in st]
    out = torch.empty((B, n), dtype=torch.int32)
    buf = torch.empty((268 * B,), dtype=torch.int32)
    ptrs = [x.data_ptr(), *(t.data_ptr() for t in leaves), out.data_ptr(),
            buf.data_ptr()]
    n_ptrs = fn.vad_host((ctypes.c_void_p * len(ptrs))(*ptrs), B, n // chn,
                         chn, freq, freq // 1000 * sub_ms)
    assert n_ptrs == len(ptrs)
    return vad._state_views(buf, B), out


@pytest.mark.parametrize("freq,chn,interval_ms", [
    (8000, 1, 10), (8000, 2, 20), (16000, 1, 20), (16000, 2, 10),
    (16000, 1, 40), (32000, 1, 20), (32000, 2, 10)])
def test_host_build_equals_body(host_vad, freq, chn, interval_ms):
    """The kernel's per-stream code, built for the host, equals
    `process_body` in the output and every state leaf over 8 packages of
    speech, silence and full scale from an aged start state."""
    B = 6
    start = st_h = st_b = _aged_state(B, seed=freq + chn + interval_ms)
    for k in range(8):
        pkg = torch.from_numpy(_package(k, B, freq, chn, interval_ms, 5))
        st_b, out_b = vad.process_body(st_b, pkg, chn, freq, interval_ms)
        st_h, out_h = _host_process(host_vad, st_h, pkg, chn, freq,
                                    interval_ms)
        assert torch.equal(out_h, out_b), f"package {k}"
        for name, a, b in zip(vad.VadState._fields, st_h, st_b):
            assert a.shape == b.shape and torch.equal(a, b), \
                f"package {k}: {name}"
    # the tables were walked: values aged out and the models moved
    assert not torch.equal(st_b.index_vector, start.index_vector)
    assert not torch.equal(st_b.noise_means, start.noise_means)


@pytest.mark.parametrize("length", [5, 10, 20, 40])
def test_host_build_log_energy_equals_body(host_vad, length):
    """The kernel's `log_energy` on bands that the packages above never
    produce: -32768 beside smaller values (`sabs` wraps it, so it never
    wins the max), nothing but -32768, silence, energies small enough to
    shift up, full scale; totals on both sides of MIN_ENERGY."""
    rng = np.random.RandomState(length)
    B = 200
    x = rng.randint(-32768, 32768, size=(B, length))
    x[:40] = (x[:40] >> rng.randint(0, 16, size=(40, 1)))
    x[40:80, rng.randint(0, length)] = -32768
    x[80:90] = -32768
    x[90:100] = 0
    x[100:130] = rng.randint(-3, 4, size=(30, length))
    x[130:140, 0] = -32768
    x[130:140, 1:] = rng.randint(-2, 3, size=(10, length - 1))
    x = x.astype(np.int32)
    total = rng.randint(-5, 30, size=B).astype(np.int32)
    offset = [176, 272, 368][length % 3]
    want, want_total = vad._log_of_energy(torch.from_numpy(x), length,
                                          offset, torch.from_numpy(total))
    fn = host_vad.vad_host_log_energy
    fn.restype = ctypes.c_int32
    for b in range(B):
        t = ctypes.c_int32(int(total[b]))
        row = np.ascontiguousarray(x[b])
        got = fn(row.ctypes.data_as(ctypes.c_void_p), length, offset,
                 ctypes.byref(t))
        assert (got, t.value) == (int(want[b]), int(want_total[b])), b


def test_host_build_short_package_passes_through(host_vad):
    """A package shorter than the wrapper's subpackage: the state copied,
    the package downmixed and duplicated, as `process_body` returns it."""
    st = _aged_state(3, seed=1)
    pkg = torch.from_numpy(_package(0, 3, 16000, 2, 10, 2))
    want_st, want = vad.process_body(st, pkg, 2, 16000)   # 20 ms subpackage
    got_st, got = _host_process(host_vad, st, pkg, 2, 16000, 20)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_st, want_st))


def test_state_views_match_init_state():
    """The kernel's state buffer, the leaves flattened in field order,
    hands back leaves of init_state's shapes, dtypes and values, as views
    of the one buffer."""
    for batch in (1, 5, 1000):
        want = vad.init_state(batch, "cpu")
        buf = torch.cat([leaf.reshape(-1) for leaf in want])
        assert buf.shape == (268 * batch,)
        got = vad._state_views(buf, batch)
        assert type(got) is vad.VadState
        for name, g, w in zip(vad.VadState._fields, got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert torch.equal(g, w), name
            assert g.is_contiguous(), name
            assert g.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr(), name


def test_cpu_process_launches_nothing():
    """On the CPU `process` is the plain version: no launch counted, the
    same outputs and state as `process_body`."""
    before = dict(kernels.launches)
    st1 = st2 = _aged_state(3, seed=4)
    for k in range(2):
        pkg = torch.from_numpy(_package(k, 3, 16000, 2, 20, 9))
        st1, out1 = vad.process(st1, pkg, 2, 16000)
        st2, out2 = vad.process_body(st2, pkg, 2, 16000)
        assert torch.equal(out1, out2)
        assert all(torch.equal(a, b) for a, b in zip(st1, st2))
    assert dict(kernels.launches) == before
    if not torch.cuda.is_available():
        assert kernels.launched("vad") == 0


@pytest.mark.parametrize("freq,chn,n", [(48000, 1, 960), (44100, 1, 882),
                                        (16000, 2, 321), (16000, 0, 320)])
def test_kernel_refuses_what_it_has_no_kernel_for(freq, chn, n):
    """The kernel's wrapper raises ValueError on another rate (as
    `calc_vad` does) and on a package that is not whole frames, before
    building or launching anything."""
    st = vad.init_state(2, "cpu")
    with pytest.raises(ValueError):
        vad._kernel_process(st, torch.zeros((2, n), dtype=torch.int32),
                            chn, freq, 20)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the VAD kernel has no CPU mode")
    return torch.device("cuda")


def _run_on_card(dev, batch, freq, chn, interval_ms, n_pkgs, seed):
    """n_pkgs packages through the kernel and through the plain version
    on the card from the aged start state: outputs and all 15 state
    leaves bit-equal, one launch a package."""
    st_k = st_b = _aged_state(batch, seed, dev)
    launches = kernels.launched("vad")
    flags = 0
    for k in range(n_pkgs):
        pkg = torch.from_numpy(_package(k, batch, freq, chn, interval_ms,
                                        seed)).to(dev)
        st_b, out_b = vad.process_body(st_b, pkg, chn, freq, interval_ms)
        st_k, out_k = vad.process(st_k, pkg, chn, freq, interval_ms)
        torch.cuda.synchronize()
        assert out_k.dtype == out_b.dtype and out_k.shape == out_b.shape
        assert torch.equal(out_k, out_b), f"package {k}"
        for name, a, b in zip(vad.VadState._fields, st_k, st_b):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.equal(a, b), f"package {k}: {name}"
        flags += int((st_b.reduce < 4).sum())
    assert kernels.launched("vad") - launches == n_pkgs
    return flags


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 1000])
@pytest.mark.parametrize("interval_ms", [10, 20, 40])
@pytest.mark.parametrize("chn", [1, 2])
@pytest.mark.parametrize("freq", [8000, 16000, 32000])
def test_kernel_equals_body_on_card(cuda_device, freq, chn, interval_ms,
                                    batch):
    speech = _run_on_card(cuda_device, batch, freq, chn, interval_ms,
                          N_PKGS, seed=freq + 10 * chn + interval_ms)
    assert speech > 0, "no package was ever judged speech"


@pytest.mark.cuda
def test_kernel_equals_body_on_card_4096(cuda_device):
    assert _run_on_card(cuda_device, 4096, 16000, 1, 20, N_PKGS,
                        seed=2 ** 31 + 5) > 0


@pytest.mark.cuda
def test_short_package_passes_through_on_card(cuda_device):
    """A 10 ms package at 16 kHz under the 20 ms subpackage: one launch,
    the package back as it came, the state unchanged."""
    st = _aged_state(5, 8, cuda_device)
    pkg = torch.from_numpy(_package(0, 5, 16000, 1, 10, 3)).to(cuda_device)
    launches = kernels.launched("vad")
    st2, out = vad.process(st, pkg, 1, 16000)
    torch.cuda.synchronize()
    assert kernels.launched("vad") - launches == 1
    assert torch.equal(out, pkg)
    assert all(torch.equal(a, b) for a, b in zip(st2, st))


@pytest.mark.cuda
@pytest.mark.parametrize("freq", [48000, 44100, 11025])
def test_kernel_refuses_on_card(cuda_device, freq):
    st = vad.init_state(2, cuda_device)
    launches = kernels.launched("vad")
    with pytest.raises(ValueError, match="fs must be"):
        vad.process(st, torch.zeros((2, freq // 50), dtype=torch.int32,
                                    device=cuda_device), 1, freq)
    assert kernels.launched("vad") == launches
