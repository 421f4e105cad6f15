"""ctypes wrapper over the native AAC-LC front-end (aacfe.c).

Produces per-frame filterbank jobs in the same form AacDecoder's
decode_deferred yields — (ch, window_sequence, window_shape,
spec_f32[1024]) — so the batched device filterbank (aac_batch.py) can
consume either front-end.  HE-AAC streams (SBR/PS fill elements or
implicit upsampling at <= 24 kHz) raise ``Unsupported`` so the caller
falls back to the Python front-end for the whole stream.
"""
from __future__ import annotations

import ctypes as C
import os
from pathlib import Path

import numpy as np

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_HDR = _NATIVE / "aacfe_tables.h"
_lib = None


class Unsupported(Exception):
    pass


def _ensure_lib():
    global _lib
    if _lib is not None:
        return _lib
    tables_src = Path(__file__).resolve().parent / "_aac_tables.py"
    if not _HDR.exists() or \
            _HDR.stat().st_mtime < tables_src.stat().st_mtime:
        from wmix_tpu_torch.native.gen_aacfe_tables import generate
        generate(str(_HDR))
    from wmix_tpu_torch import native
    # strict binary32: no FMA contraction (the TNS/PNS float loops must
    # round each op exactly like the numpy front-end), no fast-math
    _lib = native.load("aacfe", cflags=("-ffp-contract=off",),
                       deps=(str(_HDR),))
    _lib.aacfe_new.restype = C.c_void_p
    _lib.aacfe_new.argtypes = [C.POINTER(C.c_uint8), C.c_int64]
    _lib.aacfe_free.argtypes = [C.c_void_p]
    _lib.aacfe_frame.restype = C.c_int
    _lib.aacfe_frame.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                                 C.POINTER(C.c_int32),
                                 C.POINTER(C.c_int32)]
    return _lib


def available() -> bool:
    if os.environ.get("WMIX_AACFE", "") == "0":
        return False
    try:
        _ensure_lib()
        return True
    except Exception:
        return False


class NativeAacFront:
    """Streaming front-end over a complete ADTS buffer; next_frame()
    mirrors one decode_deferred() call."""

    def __init__(self, data: bytes):
        lib = _ensure_lib()
        self._lib = lib
        self._buf = np.frombuffer(bytes(data), np.uint8)
        self._fe = lib.aacfe_new(
            self._buf.ctypes.data_as(C.POINTER(C.c_uint8)),
            self._buf.size)
        if not self._fe:
            raise MemoryError("aacfe_new")
        self._spec = np.zeros((2, 1024), np.float32)
        self._meta = np.zeros(6, np.int32)
        self._jobmeta = np.zeros((2, 3), np.int32)

    def __del__(self):
        try:
            if self._fe:
                self._lib.aacfe_free(self._fe)
                self._fe = None
        except Exception:
            pass

    def next_frame(self):
        """Returns (jobs, nch, freq, emit) or None at end of stream.
        jobs = [(ch, window_sequence, window_shape, spec_f32), ...]."""
        rc = self._lib.aacfe_frame(
            self._fe,
            self._spec.ctypes.data_as(C.POINTER(C.c_float)),
            self._jobmeta.ctypes.data_as(C.POINTER(C.c_int32)),
            self._meta.ctypes.data_as(C.POINTER(C.c_int32)))
        if rc == 0:
            return None
        if rc == 2:
            raise Unsupported("HE-AAC/profile — use the Python front-end")
        n_jobs, nch, freq, _consumed, emit, _fr = (int(v)
                                                   for v in self._meta)
        jobs = [(int(self._jobmeta[j, 0]), int(self._jobmeta[j, 1]),
                 int(self._jobmeta[j, 2]), self._spec[j].copy())
                for j in range(n_jobs)]
        return jobs, nch, freq, bool(emit)
