"""Exact reproduction of the reference's float32 "div-step" rate patterns.

Both the standalone resampler (wmix_pcm_zoom, src/wmix.c:139)
and the mixer's on-the-fly conversion (wmix_load_data, src/wmix.c:1703-1940)
pace their input/output cursors with a float32 accumulator:

    divStep += div;  if (divStep >= 1.0) { <advance/emit/insert>; divStep -= 1.0; }

The skip/insert pattern this produces is data-independent — it depends only
on the rate pair and length — but it IS sensitive to float32 rounding, so a
closed-form ``floor(i*ratio)`` resampler would place skips at different
offsets and lose bit-parity.  The accumulator orbit generally does NOT
cycle (float32 rounding makes it drift), so patterns are generated by
direct sequential simulation in native code (wmix_tpu_torch/native/stepper.c) at
~1e8 steps/s, cached per (rates, length), and consumed by vectorized
numpy/JAX gathers.  A slow pure-Python float32 simulation backs it up when
no C toolchain is available.
"""
from __future__ import annotations

import ctypes as C
import functools

import numpy as np

F32 = np.float32
ONE = F32(1.0)

_COPY = 0
_INSERT = 1


def _native():
    try:
        from wmix_tpu_torch import native
        lib = native.load("stepper")
        # every argument typed: an untyped Python int goes as a 32-bit int,
        # and in a stack slot (load_insert_events' `cap`, its 8th argument)
        # the upper half of the int64 the C reads is left undefined, so the
        # call may return no events at all
        i32, i64 = C.c_int32, C.c_int64
        flags = [i32, i32, i64, C.POINTER(C.c_uint8)]
        lib.zoom_up_indices.argtypes = [i32, i32, i64, C.POINTER(i64), i64]
        lib.zoom_up_flags.argtypes = flags
        lib.zoom_down_flags.argtypes = flags
        lib.load_insert_events.argtypes = [
            i32, i32, i64, C.POINTER(C.c_int8), C.POINTER(i64),
            C.POINTER(i32), C.POINTER(i32), i64]
        lib.load_skip_flags.argtypes = flags
        lib.zoom_up_indices.restype = C.c_int64
        lib.load_insert_events.restype = C.c_int64
        return lib
    except Exception:
        return None


@functools.lru_cache(maxsize=1)
def _lib():
    return _native()


def _p(a, t):
    return a.ctypes.data_as(C.POINTER(t))


# --------------------------------------------------------------------------
# wmix_pcm_zoom patterns (src/wmix.c:139-222)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def zoom_src_index_cached(in_freq: int, out_freq: int, in_frames: int):
    return _zoom_src_index(in_freq, out_freq, in_frames)


def zoom_src_index(in_freq: int, out_freq: int, in_frames: int) -> np.ndarray:
    """Source-frame index per output frame for wmix_pcm_zoom."""
    return zoom_src_index_cached(in_freq, out_freq, int(in_frames))


def _zoom_src_index(in_freq, out_freq, in_frames):
    if in_frames <= 0:
        return np.zeros(0, np.int64)
    lib = _lib()
    if in_freq < out_freq:
        cap = in_frames * (-(-out_freq // in_freq) + 1) + 16
        idx = np.zeros(cap, np.int64)
        if lib is not None:
            n = lib.zoom_up_indices(in_freq, out_freq, in_frames,
                                    _p(idx, C.c_int64), cap)
            return idx[:n].copy()
        # fallback: pure float32 simulation
        div = F32(F32(in_freq) / F32(out_freq))
        d = F32(0.0)
        i = 0
        t = 0
        while i < in_frames:
            idx[t] = i
            t += 1
            d = F32(d + div)
            if int(d) > 0:
                i += 1
                d = F32(d - ONE)
        return idx[:t].copy()
    else:
        flags = zoom_down_flags(in_freq, out_freq, in_frames)
        return np.nonzero(flags)[0].astype(np.int64)


@functools.lru_cache(maxsize=256)
def zoom_up_flags(in_freq: int, out_freq: int, n_slots: int) -> np.ndarray:
    """Advance flag per output slot (upsample length arithmetic)."""
    n_slots = int(n_slots)
    adv = np.zeros(n_slots, np.uint8)
    lib = _lib()
    if lib is not None:
        lib.zoom_up_flags(in_freq, out_freq, n_slots, _p(adv, C.c_uint8))
        return adv
    div = F32(F32(in_freq) / F32(out_freq))
    d = F32(0.0)
    for t in range(n_slots):
        d = F32(d + div)
        if int(d) > 0:
            adv[t] = 1
            d = F32(d - ONE)
    return adv


@functools.lru_cache(maxsize=256)
def zoom_down_flags(in_freq: int, out_freq: int, n_frames: int) -> np.ndarray:
    """Emit flag per input frame (downsample)."""
    n_frames = int(n_frames)
    emit = np.zeros(n_frames, np.uint8)
    lib = _lib()
    if lib is not None:
        lib.zoom_down_flags(in_freq, out_freq, n_frames, _p(emit, C.c_uint8))
        return emit
    div = F32(F32(out_freq) / F32(in_freq))
    d = F32(0.0)
    for t in range(n_frames):
        d = F32(d + div)
        if int(d) > 0:
            emit[t] = 1
            d = F32(d - ONE)
    return emit


# --------------------------------------------------------------------------
# wmix_load_data patterns (src/wmix.c:1703-1940)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def load_insert_pattern(stream_freq: int, engine_freq: int, src_frames: int):
    """Event pattern for wmix_load_data when stream_freq < engine_freq.

    Returns (kind, src_i, k, dc2) arrays, one entry per engine output frame:
    kind 0 = copy of src frame src_i (cursor advances after); kind 1 =
    repair interpolation between src frames src_i-1 and src_i with step
    index k of divisor dc2.  Trailing inserts after the final copy are
    dropped because the C loop's count only advances on copies
    (src/wmix.c:1908)."""
    src_frames = int(src_frames)
    cap = src_frames * (-(-engine_freq // stream_freq) + 1) + 16
    kind = np.zeros(cap, np.int8)
    si = np.zeros(cap, np.int64)
    k = np.zeros(cap, np.int32)
    dc2 = np.zeros(cap, np.int32)
    lib = _lib()
    if lib is not None:
        n = lib.load_insert_events(stream_freq, engine_freq, src_frames,
                                   _p(kind, C.c_int8), _p(si, C.c_int64),
                                   _p(k, C.c_int32), _p(dc2, C.c_int32), cap)
        return (kind[:n].copy(), si[:n].copy(), k[:n].copy(),
                dc2[:n].copy())
    div_pow = F32(F32(engine_freq - stream_freq) / F32(stream_freq))
    d = F32(0.0)
    i = 0
    t = 0
    kk = 0
    d2 = 1
    while i < src_frames:
        if d >= ONE:
            kind[t], si[t], k[t], dc2[t] = _INSERT, i, kk, d2
            t += 1
            d = F32(d - ONE)
            kk += 1
        else:
            kind[t], si[t] = _COPY, i
            t += 1
            i += 1
            d = F32(d + div_pow)
            if d >= ONE:
                d2 = int(d) + 1
                kk = 0
    return kind[:t].copy(), si[:t].copy(), k[:t].copy(), dc2[:t].copy()


@functools.lru_cache(maxsize=256)
def load_skip_pattern(stream_freq: int, engine_freq: int,
                      src_frames: int) -> np.ndarray:
    """Source-frame indices copied to the engine when stream_freq >
    engine_freq (one engine frame per kept src frame)."""
    src_frames = int(src_frames)
    emit = np.zeros(src_frames, np.uint8)
    lib = _lib()
    if lib is not None:
        lib.load_skip_flags(stream_freq, engine_freq, src_frames,
                            _p(emit, C.c_uint8))
        return np.nonzero(emit)[0].astype(np.int64)
    div_pow = F32(F32(stream_freq - engine_freq) / F32(engine_freq))
    d = F32(0.0)
    for t in range(src_frames):
        if d >= ONE:
            emit[t] = 0
            d = F32(d - ONE)
        else:
            emit[t] = 1
            d = F32(d + div_pow)
    return np.nonzero(emit)[0].astype(np.int64)
