"""Bit-exact reimplementation of the reference's standalone resampler.

Covers wmix_pcm_zoom / wmix_len_of_out / wmix_len_of_in
(src/wmix.c:49-222), including their quirks:

  * rate pacing via a float32 accumulator (see wmix_tpu_torch.ops.stepper);
  * nearest-frame repeat/drop only — no interpolation;
  * channel modes: 1->1 copy, 1->2 duplicate, 2->1 take-left;
    the stereo->stereo branch tests `chnMode == 0x12` twice
    (src/wmix.c:178,212), so a 2->2 rate conversion emits NOTHING —
    reproduced faithfully;
  * lengths are counted in "advance units" exactly as the C loops do.

These functions are host-side (numpy); the device mix path uses the same
stepper patterns as gather indices.
"""
from __future__ import annotations

import numpy as np

from wmix_tpu_torch.ops import stepper


def _map_channels(frames: np.ndarray, in_chn: int, out_chn: int
                  ) -> np.ndarray | None:
    """Apply wmix_pcm_zoom's channel mode to gathered frames [n, in_chn].

    Returns [n, out_chn] or None for the dead stereo->stereo path."""
    mode = (in_chn << 4) | (out_chn & 0x0F)
    if mode == 0x11:
        return frames
    if mode == 0x12:
        return np.repeat(frames, 2, axis=1)
    if mode == 0x21:
        return frames[:, :1]
    # 0x22: both branches in the C switch test 0x12, so nothing is emitted
    return None


def pcm_zoom(in_chn: int, in_freq: int, data: bytes | np.ndarray,
             out_chn: int, out_freq: int) -> bytes:
    """wmix_pcm_zoom (src/wmix.c:139-222), bit-exact."""
    raw = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    if in_freq == out_freq and in_chn == out_chn:
        return raw.tobytes()
    pcm = raw[:raw.size // 2 * 2].view(np.int16)
    n_frames = pcm.size // in_chn
    frames = pcm[:n_frames * in_chn].reshape(n_frames, in_chn)
    idx = stepper.zoom_src_index(in_freq, out_freq, n_frames)
    out = _map_channels(frames[idx], in_chn, out_chn)
    if out is None:
        return b""
    return np.ascontiguousarray(out, np.int16).tobytes()


def len_of_out(in_chn: int, in_freq: int, in_len: int,
               out_chn: int, out_freq: int) -> int:
    """wmix_len_of_out (src/wmix.c:49-91), bit-exact length arithmetic."""
    if in_freq == out_freq and in_chn == out_chn:
        return in_len
    if in_freq < out_freq:
        # slot t runs while inChn * advances_before(t) < in_len
        bound = (in_len // in_chn + 2) * ((out_freq // in_freq) + 2)
        flags = stepper.zoom_up_flags(in_freq, out_freq, bound)
        before = np.concatenate([[0], np.cumsum(flags)[:-1]])
        t = int((before * in_chn < in_len).sum())
        return t * out_chn
    else:
        iters = -(-in_len // in_chn)  # while inCount < inLen, += inChn
        flags = stepper.zoom_down_flags(in_freq, out_freq, iters)
        return int(flags.sum()) * out_chn


def len_of_in(in_chn: int, in_freq: int, out_chn: int, out_freq: int,
              out_len: int) -> int:
    """wmix_len_of_in (src/wmix.c:94-136), bit-exact length arithmetic."""
    if in_freq == out_freq and in_chn == out_chn:
        return out_len
    if in_freq < out_freq:
        iters = -(-out_len // out_chn)  # while outCount < outLen, += outChn
        flags = stepper.zoom_up_flags(in_freq, out_freq, iters)
        return int(flags.sum()) * in_chn
    else:
        # iterate until emits*out_chn >= out_len; inCount += in_chn per iter
        need_emits = -(-out_len // out_chn)
        bound = (need_emits + 2) * ((in_freq // out_freq) + 2)
        flags = stepper.zoom_down_flags(in_freq, out_freq, bound)
        cum = np.cumsum(flags)
        iters = int(np.searchsorted(cum, need_emits, side="left")) + 1
        return iters * in_chn
