"""Build, load and launch the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a
plain C entry point, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  The build goes to `build/wmix_tpu_torch/` at the root of
the checkout (git-ignored) on first use, and again whenever a source in
`csrc/` is newer than the library.  Nothing is built on import.

Every entry point has one shape,

    int wmix_<name>_launch(void *const *ptrs, int n_ptrs, int ..., int device,
                           void *stream)

the tensors' data pointers, the kernel's integer arguments, the device
index and its stream, returning a CUDA error code that the library's
`wmix_cuda_error_string` names; `launch` is the one caller of them all.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from wmix_tpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wmix_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()     # the libraries and the launch counter
_libs: dict = {}
build_log: dict = {}        # name -> {"seconds": s, "built": bool, "log": str}
launches = collections.Counter()    # (name, "cuda:N") -> launches


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build on a machine with the CUDA toolkit")


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def build(name: str) -> str:
    """Compile csrc/<name>.cu for sm_90a if the library is missing or
    older than the sources; returns the library path."""
    src = os.path.join(CSRC, name + ".cu")
    lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    t0 = time.perf_counter()
    if not _stale(lib_path):
        build_log[name] = {"seconds": 0.0, "built": False, "log": ""}
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, lib_path)
    build_log[name] = {"seconds": time.perf_counter() - t0, "built": True,
                       "log": res.stdout + res.stderr}
    return lib_path


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            lib.wmix_cuda_error_string.argtypes = [ctypes.c_int]
            lib.wmix_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, args: dict, ints, span: str = None) -> None:
    """One launch of csrc/<name>.cu's `wmix_<name>_launch`.

    `args` maps each tensor argument's name, in the entry point's order,
    to (tensor, shape, dtype); every tensor must have its shape and dtype,
    be contiguous and lie on one device, else ValueError, raised before
    anything is built.  `ints` are the kernel's integer arguments.  The
    kernel runs on the current stream of the tensors' device, whatever
    device is current in this thread (the library makes that device
    current in its own runtime and restores the previous one); `span`, if
    given, is the program span (`utils/trace.py`) around the launch alone.
    A failed launch raises RuntimeError.  Every launch is counted in
    `launches` under (name, device)."""
    dev = first = None
    for arg, (t, shape, dtype) in args.items():
        if dev is None:
            dev, first = t.device, arg
        if t.device != dev:
            raise ValueError(f"{name} kernel: {arg} is on {t.device}, "
                             f"{first} on {dev}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} kernel: {arg} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {arg} is not contiguous")
    ptrs = [t.data_ptr() for t, _, _ in args.values()]
    lib = load(name)
    fn = getattr(lib, f"wmix_{name}_launch")
    if getattr(fn, "argtypes", ()) is None:     # first call (not a fake)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       *[ctypes.c_int] * len(ints), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    call = ((ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs), *ints,
            dev.index, ctypes.c_void_p(
                torch.cuda.current_stream(dev).cuda_stream))
    with trace.span(span) if span else contextlib.nullcontext():
        rc = fn(*call)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.wmix_cuda_error_string(rc).decode()})")
    with _lock:         # shards launch from threads of their own
        launches[(name, str(dev))] += 1


def launched(name: str) -> int:
    """Launches of csrc/<name>.cu so far, on every device together."""
    with _lock:
        return sum(n for (k, _), n in launches.items() if k == name)
