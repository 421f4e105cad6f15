"""ctypes wrapper over the native MP3 Layer III front-end (mp3fe.c).

Presents the same generator interface as ``Mp3Decoder._frames_sbsample``
(header, sbsample[2,36,32] int32 per frame) so the batched device
synthesis (mp3_batch.py) can consume either front-end.  Layer I/II
streams fall back to the Python front-end (the C port covers Layer III,
the daemon's actual MP3 play format — wmixTask.c:2022-2102 mmap path).

The constant header (mp3fe_tables.h) is regenerated from the shared
_mp3_tables.py whenever it is stale, so the two front-ends can never
drift numerically.
"""
from __future__ import annotations

import ctypes as C
import os
from pathlib import Path

import numpy as np

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_HDR = _NATIVE / "mp3fe_tables.h"
_lib = None


def _ensure_lib():
    global _lib
    if _lib is not None:
        return _lib
    tables_src = Path(__file__).resolve().parent / "_mp3_tables.py"
    if not _HDR.exists() or \
            _HDR.stat().st_mtime < tables_src.stat().st_mtime:
        from wmix_tpu_torch.native.gen_mp3fe_tables import generate
        generate(str(_HDR))
    from wmix_tpu_torch import native
    # -fwrapv: the Q28 pipeline relies on int32 wraparound (as libmad's
    # build does); without it signed overflow is UB
    _lib = native.load("mp3fe", cflags=("-fwrapv",), deps=(str(_HDR),))
    _lib.mp3fe_new.restype = C.c_void_p
    _lib.mp3fe_new.argtypes = [C.POINTER(C.c_uint8), C.c_int64]
    _lib.mp3fe_free.argtypes = [C.c_void_p]
    _lib.mp3fe_next.restype = C.c_int
    _lib.mp3fe_next.argtypes = [C.c_void_p, C.POINTER(C.c_int32),
                                C.POINTER(C.c_int32)]
    return _lib


def available() -> bool:
    if os.environ.get("WMIX_MP3FE", "") == "0":
        return False
    try:
        _ensure_lib()
        return True
    except Exception:
        return False


class _Hdr:
    """Header view with the attributes mp3_batch.tick() consumes."""
    __slots__ = ("layer", "nchannels", "nbsamples", "samplerate",
                 "bitrate")

    def __init__(self, info):
        self.layer = int(info[0])
        self.nchannels = int(info[1])
        self.nbsamples = int(info[2])
        self.samplerate = int(info[3])
        self.bitrate = int(info[4])


def frames_sbsample(data: bytes):
    """Yield (header, sbsample [2,36,32] int32) per Layer III frame.

    Raises ``UnsupportedLayer`` on the first non-III frame so the caller
    can restart the stream on the Python front-end."""
    lib = _ensure_lib()
    buf = np.frombuffer(bytes(data), np.uint8)
    if buf.size == 0:
        return
    fe = lib.mp3fe_new(buf.ctypes.data_as(C.POINTER(C.c_uint8)),
                       buf.size)
    if not fe:
        raise MemoryError("mp3fe_new")
    try:
        sb = np.zeros((2, 36, 32), np.int32)
        info = np.zeros(6, np.int32)
        while True:
            rc = lib.mp3fe_next(
                fe, sb.ctypes.data_as(C.POINTER(C.c_int32)),
                info.ctypes.data_as(C.POINTER(C.c_int32)))
            if rc == 0:
                return
            if rc == 2:
                raise UnsupportedLayer(int(info[0]))
            yield _Hdr(info), sb.copy()
    finally:
        lib.mp3fe_free(fe)


class UnsupportedLayer(Exception):
    pass
