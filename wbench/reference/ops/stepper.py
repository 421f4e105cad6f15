"""Exact reproduction of the reference's float32 "div-step" rate pattern
for the chain's 1x8000 copy.

The standalone resampler (wmix_pcm_zoom, src/wmix.c:139) paces its
cursors with a float32 accumulator:

    divStep += div;  if (divStep >= 1.0) { <emit>; divStep -= 1.0; }

The pattern this produces is data-independent — it depends only on the
rate pair and length — but it IS sensitive to float32 rounding, so a
closed-form ``floor(i*ratio)`` resampler would place the kept frames at
different offsets and lose bit-parity.  The port simulates it in native
code; this copy keeps its pure-Python float32 simulation, which gives the
same pattern, and only the downsampling the chain uses.
"""
from __future__ import annotations

import functools

import numpy as np

F32 = np.float32
ONE = F32(1.0)


@functools.lru_cache(maxsize=256)
def zoom_src_index_cached(in_freq: int, out_freq: int, in_frames: int):
    return _zoom_src_index(in_freq, out_freq, in_frames)


def zoom_src_index(in_freq: int, out_freq: int, in_frames: int) -> np.ndarray:
    """Source-frame index per output frame for wmix_pcm_zoom."""
    return zoom_src_index_cached(in_freq, out_freq, int(in_frames))


def _zoom_src_index(in_freq, out_freq, in_frames):
    if in_frames <= 0:
        return np.zeros(0, np.int64)
    if in_freq < out_freq:
        raise ValueError("the record chain's copy only downsamples")
    flags = zoom_down_flags(in_freq, out_freq, in_frames)
    return np.nonzero(flags)[0].astype(np.int64)


@functools.lru_cache(maxsize=256)
def zoom_down_flags(in_freq: int, out_freq: int, n_frames: int) -> np.ndarray:
    """Emit flag per input frame (downsample)."""
    n_frames = int(n_frames)
    emit = np.zeros(n_frames, np.uint8)
    div = F32(F32(out_freq) / F32(in_freq))
    d = F32(0.0)
    for t in range(n_frames):
        d = F32(d + div)
        if int(d) > 0:
            emit[t] = 1
            d = F32(d - ONE)
    return emit
