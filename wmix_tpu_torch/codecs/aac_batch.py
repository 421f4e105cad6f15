"""AAC-LC inverse filterbank on the device, batched over streams.

Port of `wmix_tpu/codecs/aac_batch.py`.  Huffman, requantization,
MS/IS/PNS and TNS stay on the host per stream (the C front-end `aacfe`,
else `aac.AacDecoder.decode_deferred`); the IMDCT and the window/overlap
filterbank run here as batched torch programs:

  * the IMDCT is the host decoder's dataflow (pre-twiddle, the radix-4/2
    pass sequence of cfft.c's cfftf1pos, post-twiddle, the output
    interleave as one gather) with a leading stream axis;
  * streams are grouped per tick by (window sequence, shape, previous
    shape) and each group runs as one call of `filterbank`;
  * the overlap (fb_intermed) lives on the device, [slots, 1024] float32,
    updated in place.

Bit-equal to the host numpy path in float32: in eager torch every
elementwise operation rounds on its own, on the CPU and on the card, so a
product followed by a sum is two roundings as in numpy.  Nothing here may
fuse a product into a sum (no `addcmul`, `addmm`, `lerp` or compiled
graph) or divide: the card's `tensor / c` multiplies by the reciprocal.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from wmix_tpu_torch.codecs import _aac_tables as T
from wmix_tpu_torch.codecs.aac import (EIGHT_SHORT_SEQUENCE,
                                       LONG_START_SEQUENCE,
                                       LONG_STOP_SEQUENCE,
                                       ONLY_LONG_SEQUENCE, _cfft_plan,
                                       to_pcm_16bit)
from wmix_tpu_torch.device import resolve_device

F32 = torch.float32


def _dev(a, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


# ------------------------------------------------------------------ cfft

def _passf2pos(ido, l1, cre, cim, w):
    """passf2pos (cfft.c:56-105) with a leading batch axis."""
    B = cre.shape[0]
    cc_re = cre.reshape(B, l1, 2, ido)
    cc_im = cim.reshape(B, l1, 2, ido)
    o0_re = cc_re[:, :, 0] + cc_re[:, :, 1]
    o0_im = cc_im[:, :, 0] + cc_im[:, :, 1]
    t2_re = cc_re[:, :, 0] - cc_re[:, :, 1]
    t2_im = cc_im[:, :, 0] - cc_im[:, :, 1]
    if ido == 1:
        o1_re, o1_im = t2_re, t2_im
    else:
        wre, wim = w[0]
        o1_im = t2_im * wre + t2_re * wim
        o1_re = t2_re * wre - t2_im * wim
    out_re = torch.stack([o0_re, o1_re], dim=1)
    out_im = torch.stack([o0_im, o1_im], dim=1)
    return out_re.reshape(B, -1), out_im.reshape(B, -1)


def _passf4pos(ido, l1, cre, cim, w):
    """passf4pos (cfft.c:334-430) with a leading batch axis."""
    B = cre.shape[0]
    cc_re = cre.reshape(B, l1, 4, ido)
    cc_im = cim.reshape(B, l1, 4, ido)
    t2_re = cc_re[:, :, 0] + cc_re[:, :, 2]
    t1_re = cc_re[:, :, 0] - cc_re[:, :, 2]
    t2_im = cc_im[:, :, 0] + cc_im[:, :, 2]
    t1_im = cc_im[:, :, 0] - cc_im[:, :, 2]
    t3_re = cc_re[:, :, 1] + cc_re[:, :, 3]
    t4_im = cc_re[:, :, 1] - cc_re[:, :, 3]
    t3_im = cc_im[:, :, 3] + cc_im[:, :, 1]
    t4_re = cc_im[:, :, 3] - cc_im[:, :, 1]

    o0_re = t2_re + t3_re
    o0_im = t2_im + t3_im
    c3_re = t2_re - t3_re
    c3_im = t2_im - t3_im
    c2_re = t1_re + t4_re
    c2_im = t1_im + t4_im
    c4_re = t1_re - t4_re
    c4_im = t1_im - t4_im
    if ido == 1:
        o1_re, o1_im = c2_re, c2_im
        o2_re, o2_im = c3_re, c3_im
        o3_re, o3_im = c4_re, c4_im
    else:
        (w1re, w1im), (w2re, w2im), (w3re, w3im) = w
        o1_im = c2_im * w1re + c2_re * w1im
        o1_re = c2_re * w1re - c2_im * w1im
        o2_im = c3_im * w2re + c3_re * w2im
        o2_re = c3_re * w2re - c3_im * w2im
        o3_im = c4_im * w3re + c4_re * w3im
        o3_re = c4_re * w3re - c4_im * w3im
    out_re = torch.stack([o0_re, o1_re, o2_re, o3_re], dim=1)
    out_im = torch.stack([o0_im, o1_im, o2_im, o3_im], dim=1)
    return out_re.reshape(B, -1), out_im.reshape(B, -1)


@functools.lru_cache(maxsize=8)
def _cfft_passes(n: int, device: str) -> tuple:
    """The pass sequence of the cfft plan of size n: (radix, ido, l1,
    twiddles) per pass, the twiddles ((re, im) per butterfly leg,
    [ido] each) on `device`."""
    ifac, wa_re, wa_im = _cfft_plan(n)
    passes = []
    l1 = 1
    iw = 0
    for ip in ifac:
        if ip not in (2, 4):
            raise ValueError(f"cfft radix {ip} not needed for LC")
        l2 = ip * l1
        ido = n // l2
        w = tuple((_dev(wa_re[iw + k * ido:iw + (k + 1) * ido], device),
                   _dev(wa_im[iw + k * ido:iw + (k + 1) * ido], device))
                  for k in range(ip - 1))
        passes.append((ip, ido, l1, w))
        l1 = l2
        iw += (ip - 1) * ido
    return tuple(passes)


def cfftb(n: int, re: torch.Tensor, im: torch.Tensor):
    """cfftb (cfft.c:858-861), the pass sequence of the host
    `aac.cfftb`, batched: re/im [B, n]."""
    for ip, ido, l1, w in _cfft_passes(n, str(re.device)):
        step = _passf4pos if ip == 4 else _passf2pos
        re, im = step(ido, l1, re, im, w)
    return re, im


# ----------------------------------------------------------------- imdct

@functools.lru_cache(maxsize=4)
def _imdct_interleave(N: int):
    """(src, sign): out[j] = sign[j] * concat(z_re, z_im)[src[j]],
    the output stores of mdct.c:168-230."""
    N2, N4, N8 = N // 2, N // 4, N // 8
    src = np.zeros(N, np.int64)
    sign = np.zeros(N, np.float32)
    k = np.arange(N8)
    IM = N4  # z_im offset in the concatenated [z_re | z_im] vector

    def put(sl, idx, sg):
        src[sl] = idx
        sign[sl] = sg

    put(np.arange(0, N4, 2), IM + N8 + k, 1.0)
    put(np.arange(1, N4, 2), N8 - 1 - k, -1.0)
    put(np.arange(N4, N2, 2), k, 1.0)
    put(np.arange(N4 + 1, N2, 2), IM + N4 - 1 - k, -1.0)
    put(np.arange(N2, N2 + N4, 2), N8 + k, 1.0)
    put(np.arange(N2 + 1, N2 + N4, 2), IM + N8 - 1 - k, -1.0)
    put(np.arange(N2 + N4, N, 2), IM + k, -1.0)
    put(np.arange(N2 + N4 + 1, N, 2), N4 - 1 - k, 1.0)
    return src, sign


@functools.lru_cache(maxsize=8)
def _imdct_tables(N: int, device: str) -> tuple:
    """(sc_re, sc_im [N/4], src [N], sign [N]) on `device`."""
    tab = np.asarray(T.MDCT_TAB_2048 if N == 2048 else T.MDCT_TAB_256,
                     np.float32)
    src, sign = _imdct_interleave(N)
    return (_dev(tab[:, 0], device), _dev(tab[:, 1], device),
            torch.from_numpy(src).to(device), _dev(sign, device))


def imdct(N: int, x_in: torch.Tensor) -> torch.Tensor:
    """faad_imdct (mdct.c:122-230) batched: x_in [B, N/2] -> [B, N]."""
    sc_re, sc_im, src, sign = _imdct_tables(N, str(x_in.device))
    N2 = N // 2
    x = x_in.to(F32)
    a = x[:, 0:N2:2]
    b = x[:, 1:N2:2].flip(1)               # x[N2-1], x[N2-3], ..., x[1]
    z_im = a * sc_re + b * sc_im
    z_re = b * sc_re - a * sc_im

    z_re, z_im = cfftb(N // 4, z_re, z_im)

    new_im = z_im * sc_re + z_re * sc_im
    new_re = z_re * sc_re - z_im * sc_im

    zcat = torch.cat([new_re, new_im], dim=1)
    return zcat[:, src] * sign


# ----------------------------------------------------------- filter bank

@functools.lru_cache(maxsize=8)
def _windows(device: str) -> dict:
    """The long and short windows of both shapes (0 sine, 1 KBD), and
    their reversals, on `device`."""
    long_w = [np.asarray(T.SINE_LONG_1024, np.float32),
              np.asarray(T.KBD_LONG_1024, np.float32)]
    short_w = [np.asarray(T.SINE_SHORT_128, np.float32),
               np.asarray(T.KBD_SHORT_128, np.float32)]
    return {"long": [_dev(w, device) for w in long_w],
            "short": [_dev(w, device) for w in short_w],
            "long_rev": [_dev(w[::-1], device) for w in long_w],
            "short_rev": [_dev(w[::-1], device) for w in short_w]}


def filterbank(window_sequence: int, window_shape: int,
               window_shape_prev: int, freq_in: torch.Tensor,
               overlap: torch.Tensor, frame_len: int = 1024):
    """ifilter_bank (filtbank.c:165-330) over G streams of one (sequence,
    shape, previous shape): freq_in [G, frame_len], overlap [G, frame_len]
    float32 -> (time_out, new_overlap), both [G, frame_len]."""
    nlong = frame_len
    nshort = frame_len // 8
    trans = nshort // 2
    nflat_ls = (nlong - nshort) // 2
    w = _windows(str(freq_in.device))
    window_long_prev = w["long"][window_shape_prev]
    window_short_prev = w["short"][window_shape_prev]
    ws = w["short"][window_shape]
    wl_rev = w["long_rev"][window_shape]
    ws_rev = w["short_rev"][window_shape]
    G = freq_in.shape[0]
    zeros = functools.partial(torch.zeros, dtype=F32, device=freq_in.device)

    if window_sequence == ONLY_LONG_SEQUENCE:
        transf = imdct(2 * nlong, freq_in)
        time_out = overlap + transf[:, :nlong] * window_long_prev
        new_overlap = transf[:, nlong:] * wl_rev
    elif window_sequence == LONG_START_SEQUENCE:
        transf = imdct(2 * nlong, freq_in)
        time_out = overlap + transf[:, :nlong] * window_long_prev
        new_overlap = torch.cat([
            transf[:, nlong:nlong + nflat_ls],
            transf[:, nlong + nflat_ls:nlong + nflat_ls + nshort] * ws_rev,
            zeros((G, nlong - nflat_ls - nshort))], dim=1)
    elif window_sequence == EIGHT_SHORT_SEQUENCE:
        # the 8 short IMDCTs folded into the batch axis: [G*8, 256]
        sub = freq_in.reshape(G * 8, nshort)
        transf = imdct(2 * nshort, sub).reshape(G, 16 * nshort)
        parts = [overlap[:, :nflat_ls],
                 overlap[:, nflat_ls:nflat_ls + nshort] +
                 transf[:, :nshort] * window_short_prev]
        for blk in range(1, 4):
            parts.append(
                overlap[:, nflat_ls + blk * nshort:
                        nflat_ls + (blk + 1) * nshort] +
                transf[:, (2 * blk - 1) * nshort:2 * blk * nshort] *
                ws_rev +
                transf[:, 2 * blk * nshort:(2 * blk + 1) * nshort] * ws)
        parts.append(
            overlap[:, nflat_ls + 4 * nshort:nflat_ls + 4 * nshort + trans] +
            transf[:, 7 * nshort:7 * nshort + trans] * ws_rev[:trans] +
            transf[:, 8 * nshort:8 * nshort + trans] * ws[:trans])
        time_out = torch.cat(parts, dim=1)

        ov = [transf[:, 7 * nshort + trans:8 * nshort] * ws_rev[trans:] +
              transf[:, 8 * nshort + trans:9 * nshort] * ws[trans:]]
        for blk in range(5, 8):
            ov.append(
                transf[:, (2 * blk - 1) * nshort:2 * blk * nshort] * ws_rev +
                transf[:, 2 * blk * nshort:(2 * blk + 1) * nshort] * ws)
        ov.append(transf[:, 15 * nshort:] * ws_rev)
        # [trans + 4*nshort, nlong) stays zero: nflat_ls samples
        new_overlap = torch.cat(ov + [zeros((G, nflat_ls))], dim=1)
    elif window_sequence == LONG_STOP_SEQUENCE:
        transf = imdct(2 * nlong, freq_in)
        time_out = torch.cat([
            overlap[:, :nflat_ls],
            overlap[:, nflat_ls:nflat_ls + nshort] +
            transf[:, nflat_ls:nflat_ls + nshort] * window_short_prev,
            overlap[:, nflat_ls + nshort:] +
            transf[:, nflat_ls + nshort:nlong]], dim=1)
        new_overlap = transf[:, nlong:] * wl_rev
    else:
        raise ValueError("bad window sequence")
    return time_out, new_overlap


class BatchedFilterbank:
    """The fb_intermed state of `slots` channel slots on the device, and
    one frame's filterbank jobs run as one call per (sequence, shape,
    previous shape) group.  `overlap` [slots, frame_len] float32 and
    `shape_prev` [slots] int32 are device tensors updated in place; a host
    copy of `shape_prev` groups the jobs without reading the device."""

    def __init__(self, slots: int, frame_len: int = 1024, device=None):
        self.slots = slots
        self.frame_len = frame_len
        self.device = resolve_device(device)
        self.overlap = torch.zeros((slots, frame_len), dtype=F32,
                                   device=self.device)
        self.shape_prev = torch.zeros(slots, dtype=torch.int32,
                                      device=self.device)
        self._prev = np.zeros(slots, np.int32)

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64).reshape(-1),
                               device=self.device)

    def reset(self, idx) -> None:
        i = self._index(idx)
        self.overlap[i] = 0.0
        self.shape_prev[i] = 0
        self._prev[np.asarray(idx)] = 0

    def load_state(self, overlap, shape_prev) -> None:
        """Take over a filterbank state, e.g. the arrays of
        `wmix_tpu.codecs.aac_batch.BatchedFilterbank` ([slots, frame_len]
        float32 and [slots]), copied into this one's tensors."""
        self.overlap.copy_(torch.from_numpy(np.array(overlap, np.float32)))
        self._prev[:] = np.asarray(shape_prev, np.int32)
        self.shape_prev.copy_(torch.from_numpy(self._prev.copy()))

    def _run(self, idx: np.ndarray, i: torch.Tensor, seq: int, shape: int,
             prev: int, freq: torch.Tensor) -> torch.Tensor:
        """One group: slots `idx` (`i` on the device), spectra `freq`."""
        time_out, new_ov = filterbank(seq, shape, prev, freq,
                                      self.overlap.index_select(0, i),
                                      self.frame_len)
        self.overlap.index_copy_(0, i, new_ov)
        self.shape_prev.index_fill_(0, i, shape)
        self._prev[idx] = shape
        return time_out

    def frame_stacked(self, idx, seq: int, shape: int, specs):
        """A frame whose `idx` slots share one (sequence, shape) and one
        previous shape; `specs` is a stacked [len(idx), frame_len] float32
        array or tensor.  Returns time_out [len(idx), frame_len] on the
        device."""
        idx = np.asarray(idx, np.int64)
        prev = int(self._prev[idx[0]])
        if not (self._prev[idx] == prev).all():
            raise ValueError("mixed shape_prev: use frame()")
        freq = torch.as_tensor(specs).to(self.device, F32)
        return self._run(idx, self._index(idx), int(seq), int(shape), prev,
                         freq)

    def frame(self, jobs):
        """jobs: [(slot, window_sequence, window_shape, spec_f32
        [frame_len]), ...], one per active channel slot.  Returns {slot:
        time_out np.float32 [frame_len]}: per group one copy to the device
        and one back."""
        groups = {}
        for slot, seq, shape, spec in jobs:
            key = (int(seq), int(shape), int(self._prev[slot]))
            groups.setdefault(key, []).append((slot, spec))
        out = {}
        n = self.frame_len
        for (seq, shape, prev), members in groups.items():
            idx = np.asarray([m[0] for m in members], np.int64)
            # spectra and slots in one copy: the slot rides as one more
            # int32 column beside the spectra's float32 bits
            packed = np.empty((len(members), n + 1), np.int32)
            packed[:, :n] = np.stack([m[1] for m in members]).astype(
                np.float32).view(np.int32)
            packed[:, n] = idx
            dev = torch.from_numpy(packed).to(self.device)
            t_np = self._run(idx, dev[:, n].long(), seq, shape, prev,
                             dev[:, :n].view(F32)).cpu().numpy()
            for j, (slot, _spec) in enumerate(members):
                out[slot] = t_np[j]
        return out


# --------------------------------------------------------------- decoder

class AacBatchDecoder:
    """N concurrent plain-LC AAC decodes: per-stream host front-ends (ADTS
    parse, Huffman, requantize, MS/IS/PNS, TNS) and batched device
    filterbank calls per tick, the AAC counterpart of
    `mp3_batch.Mp3BatchDecoder`.  Streams with SBR (HE-AAC) are rejected
    by `decode_deferred` and must use the host `aac.AacDecoder`."""

    MAX_CH = 2

    def __init__(self, batch: int, device=None):
        from wmix_tpu_torch.codecs.aac import AacDecoder
        self.batch = batch
        self.front = [AacDecoder() for _ in range(batch)]
        self.fb = BatchedFilterbank(batch * self.MAX_CH, device=device)
        self._bufs = [b""] * batch
        self._active = [False] * batch
        self._native = [None] * batch

    def start(self, b: int, data: bytes) -> None:
        """Begin decoding `data` on stream b.  The bitstream front-end is
        the native C decoder (`aacfe`); it raises Unsupported on non-LC
        streams, and the stream then restarts on the Python front-end."""
        from wmix_tpu_torch.codecs import aacfe
        from wmix_tpu_torch.codecs.aac import AacDecoder
        self.front[b] = AacDecoder()
        self.fb.reset([b * self.MAX_CH, b * self.MAX_CH + 1])
        self._bufs[b] = data
        self._active[b] = True
        self._native[b] = None
        if aacfe.available():
            try:
                self._native[b] = aacfe.NativeAacFront(data)
            except Exception:
                self._native[b] = None

    def _next_frame(self, b: int):
        """One frame of stream b from its front-end (the Python one once
        the native one refuses the stream): (jobs, nch, emit), or None at
        the end of the stream."""
        from wmix_tpu_torch.codecs import aacfe
        if self._native[b] is not None:
            try:
                r = self._native[b].next_frame()
            except aacfe.Unsupported:
                # the stream restarts on the Python front-end (the first
                # frame decides: LC streams never switch)
                self._native[b] = None
                return self._next_frame(b)
            if r is None:
                return None
            jobs, nch, _freq, emit = r
            return jobs, nch, emit
        buf = self._bufs[b]
        if len(buf) < 7:
            return None
        fjobs, consumed, nch, _freq, emit = \
            self.front[b].decode_deferred(buf)
        if consumed == 0:
            return None
        self._bufs[b] = buf[consumed:]
        return fjobs, nch, emit

    def tick(self):
        """Decode one ADTS frame on every active stream; returns ({stream:
        pcm int16 interleaved}, finished list).  A stream whose front-end
        raises ends in this tick."""
        jobs = []
        meta = {}
        done = []
        for b in range(self.batch):
            if not self._active[b]:
                continue
            try:
                r = self._next_frame(b)
            except Exception:
                r = None
            if r is None:
                self._active[b] = False
                done.append(b)
                continue
            fjobs, nch, emit = r
            slot_jobs = [(b * self.MAX_CH + ch, seq, shape, spec)
                         for ch, seq, shape, spec in fjobs]
            jobs.extend(slot_jobs)
            meta[b] = (nch, [sj[0] for sj in slot_jobs], emit)
        if not jobs:
            return {}, done
        outs = self.fb.frame(jobs)
        pcms = {}
        for b, (nch, slots, emit) in meta.items():
            if not emit:
                continue
            chans = [outs[s] for s in slots]
            if nch == 2 and len(chans) == 1:
                # a PS-capable build's mono upmatrix (decoder.c:1056-1063)
                chans = [chans[0], chans[0]]
            pcms[b] = to_pcm_16bit(chans)
        return pcms, done
