"""The 16 kHz -> 8 kHz zoom pattern of the record chain's second output.

Port of the downsampling half of `wmix_tpu/ops/stepper.py`: the
reference's `wmix_pcm_zoom` (src/wmix.c:139-222) paces its cursor with a
float32 accumulator, `divStep += div; if (divStep >= 1.0) {emit;
divStep -= 1.0;}`, so the pattern depends on float32 rounding and is
simulated step by step (the pure-Python float32 fallback of
`zoom_down_flags`), once per (rates, length).
"""
from __future__ import annotations

import functools

import numpy as np

F32 = np.float32
ONE = F32(1.0)


@functools.lru_cache(maxsize=64)
def zoom_down_flags(in_freq: int, out_freq: int,
                    n_frames: int) -> np.ndarray:
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
    emit.setflags(write=False)
    return emit


def zoom_src_index(in_freq: int, out_freq: int,
                   in_frames: int) -> np.ndarray:
    """Source-frame index per output frame of wmix_pcm_zoom, for
    in_freq >= out_freq (the record chain's zoom to 8 kHz)."""
    if in_freq < out_freq:
        raise NotImplementedError("wmix_tpu_torch zooms down only")
    if in_frames <= 0:
        return np.zeros(0, np.int64)
    flags = zoom_down_flags(in_freq, out_freq, in_frames)
    return np.nonzero(flags)[0].astype(np.int64)
