"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a
plain C entry point, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  The build goes to `build/wmix_tpu_torch/` at the root of
the checkout (git-ignored) on first use, and again whenever a source in
`csrc/` is newer than the library.  Nothing is built on import.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wmix_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}        # name -> {"seconds": s, "built": bool, "log": str}


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
            _declare(lib)
            _libs[name] = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    fn = getattr(lib, "wmix_aec_package_launch", None)
    if fn is not None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = getattr(lib, "wmix_cuda_error_string", None)
    if err is not None:
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
