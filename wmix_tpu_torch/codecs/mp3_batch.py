"""MP3 polyphase synthesis on the device, batched over concurrent streams.

Port of `wmix_tpu/codecs/mp3_batch.py`.  The host front-end of each
stream (sync, Huffman, requantize, IMDCT: `mp3fe`, else the Python
`mp3.Mp3Decoder`) yields one frame's subband samples; the synthesis, the
transform math, runs as one batched torch program over B streams:

  * dct32: the shared SSA flow graph (`_mp3_dct32`) on int32 tensors,
    batched over [B * ns] slots;
  * the windowing MACs: the filter FIFO of synth.c only ever holds the
    dct outputs of the 16 most recent slots, so the frame is a
    sliding-window gather over the slot axis.  The bank entry at parity
    q & 1, column q >> 1 is the dct output from (p - q) mod 16 slots ago,
    p being the slot's phase; the carried state is the last 16 slots'
    dct outputs (`hist`) and the phase;
  * mad_scale (the daemon's rounding to int16) at the end.

Everything is int32 with wraparound, as the host `Synth` (bit-exact
against libmad): a product of int32 tensors wraps, `>>` is arithmetic,
and each sum (which torch returns as int64) is wrapped back to int32, so
the vectorized sums equal the C MACs in any order.  The per-phase tables
live on the device, built once per (device, ns).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from wmix_tpu_torch.codecs import _mp3_tables as T
from wmix_tpu_torch.codecs._mp3_dct32 import dct32
from wmix_tpu_torch.codecs.mp3 import _KOFFS, _ROWS
from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.intops import wrap32

I32 = torch.int32


@functools.lru_cache(maxsize=1)
def _d_tables():
    """Per-phase D-window gather tables, stacked over the 16 phases:
    (d0o, d0e [16, 8], dfo, dfe, dme, dmo [16, 15, 8], dlast [16, 8])."""
    D = T.D_TABLE
    d0o = np.zeros((16, 8), np.int32)
    d0e = np.zeros((16, 8), np.int32)
    dfo = np.zeros((16, 15, 8), np.int32)
    dfe = np.zeros((16, 15, 8), np.int32)
    dme = np.zeros((16, 15, 8), np.int32)
    dmo = np.zeros((16, 15, 8), np.int32)
    dlast = np.zeros((16, 8), np.int32)
    for phase in range(16):
        pe = phase & ~1
        po = ((phase - 1) & 0xF) | 1
        d0o[phase] = D[0 * 32 + po + _KOFFS]
        d0e[phase] = D[0 * 32 + pe + _KOFFS]
        dfo[phase] = D[_ROWS + po + _KOFFS]
        dfe[phase] = D[_ROWS + pe + _KOFFS]
        dme[phase] = D[_ROWS - pe + 31 - _KOFFS]
        dmo[phase] = D[_ROWS - po + 31 - _KOFFS]
        dlast[phase] = D[16 * 32 + po + _KOFFS]
    return (d0o, d0e, dfo, dfe, dme, dmo, dlast)


@functools.lru_cache(maxsize=1)
def _delta_tables():
    """Slot-distance tables [16, 8]: the bank entry at (parity q & 1,
    column q >> 1) holds the dct output from (p - q) mod 16 slots ago,
    where p is the current slot's phase."""
    d_same = np.zeros((16, 8), np.int32)
    d_opp = np.zeros((16, 8), np.int32)
    for p in range(16):
        pe = p & 1
        for c in range(8):
            d_same[p, c] = (p - (2 * c + pe)) % 16
            d_opp[p, c] = (p - (2 * c + 1 - pe)) % 16
    return d_same, d_opp


@functools.lru_cache(maxsize=16)
def _frame_tables(device: str, ns: int) -> dict:
    """The tables of one frame of ns slots, indexed by the frame's first
    phase, on `device`: the gather positions `idx_same`, `idx_opp`
    [16, ns, 8] into the 16 + ns slots of history and frame, and the
    D-window rows of each slot (`d0o` ... `dlast`, [16, ns, ...])."""
    d_same, d_opp = _delta_tables()
    phases = (np.arange(16)[:, None] + np.arange(ns)[None, :]) % 16
    pos = 16 + np.arange(ns)[None, :, None]
    tabs = {"idx_same": (pos - d_same[phases]).astype(np.int64),
            "idx_opp": (pos - d_opp[phases]).astype(np.int64)}
    names = ("d0o", "d0e", "dfo", "dfe", "dme", "dmo", "dlast")
    for name, tab in zip(names, _d_tables()):
        tabs[name] = tab[phases]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in tabs.items()}


def _sum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The int32 wraparound sum of an int32 tensor along `dim`."""
    return wrap32(x.sum(dim=dim))


def _synth_channel(hist_lo, hist_hi, lo_slots, hi_slots, phase0):
    """One channel over B streams, all ns slots at once: hist_lo/hist_hi
    [B, 16, 16] int32 (dct outputs of the 16 most recent slots, oldest
    first), lo/hi_slots [B, ns, 16], phase0 [B] (the first slot's
    phase) -> (hist_lo, hist_hi, pcm [B, ns, 32] int32)."""
    B, ns, _ = lo_slots.shape
    tabs = _frame_tables(str(lo_slots.device), ns)
    full_lo = torch.cat([hist_lo, lo_slots], dim=1)          # [B,16+ns,16]
    full_hi = torch.cat([hist_hi, hi_slots], dim=1)
    ph = phase0.long()
    idx_same = tabs["idx_same"][ph]                           # [B,ns,8]
    idx_opp = tabs["idx_opp"][ph]
    rows = torch.arange(B, device=lo_slots.device)[:, None, None]

    fe = full_lo[rows, idx_same]            # same-parity lo bank [B,ns,8,16]
    fx = full_lo[rows, idx_opp]             # opposite-parity lo bank
    fo = full_hi[rows, idx_opp]             # opposite-parity hi bank

    d0o, d0e, dlast = (tabs[k][ph] for k in ("d0o", "d0e", "dlast"))
    dfo, dfe, dme, dmo = (tabs[k][ph] for k in ("dfo", "dfe", "dme", "dmo"))

    d0 = _sum32(fe[:, :, :, 0] * d0e, 2) - _sum32(fx[:, :, :, 0] * d0o, 2)
    out0 = (d0 >> 2)[:, :, None]                              # [B,ns,1]
    fe_sb = fe.transpose(2, 3)                                # [B,ns,16,8]
    fo_sb = fo.transpose(2, 3)
    fwd = (_sum32(fe_sb[:, :, 1:] * dfe, 3) -
           _sum32(fo_sb[:, :, :15] * dfo, 3)) >> 2
    rev = (_sum32(fe_sb[:, :, 1:] * dme, 3) +
           _sum32(fo_sb[:, :, :15] * dmo, 3)) >> 2
    out16 = ((-_sum32(fo_sb[:, :, 15] * dlast, 2)) >> 2)[:, :, None]
    pcm = torch.cat([out0, fwd, out16, rev.flip(2)], dim=2)   # [B,ns,32]
    return full_lo[:, -16:], full_hi[:, -16:], pcm


def mad_scale(sample: torch.Tensor) -> torch.Tensor:
    """The daemon's mad_scale without int64: pre-clip so that the rounding
    add cannot overflow int32 (equal for every input)."""
    s = torch.clamp(sample, -(1 << 28) - 4096, (1 << 28) - 1) + 4096
    s = torch.clamp(s, -(1 << 28), (1 << 28) - 1)
    return (s >> (28 + 1 - 16)).to(torch.int16)


def synth_frame(hist, sbsample, phase0, nch: int, ns: int):
    """One frame of B streams: hist [B, 2, 2, 16, 16] int32 (channel,
    lo/hi, slot, subband), sbsample [B, 2, ns, 32] int32, phase0 [B] ->
    (new hist, pcm int16 [B, nch, 32 * ns])."""
    B = sbsample.shape[0]
    outs = []
    new_hist = []
    for ch in range(nch):
        # [B, ns, 32] -> [32, B*ns] subband rows for the shared SSA
        xt = sbsample[:, ch].permute(2, 0, 1).reshape(32, B * ns)
        HI, LO = dct32(xt)                                    # [16, B*ns]

        def resh(a):
            return a.reshape(16, B, ns).permute(1, 2, 0)      # [B, ns, 16]

        hlo, hhi, pcm = _synth_channel(hist[:, ch, 0], hist[:, ch, 1],
                                       resh(LO), resh(HI), phase0)
        new_hist.append(torch.stack([hlo, hhi], dim=1))
        outs.append(pcm.reshape(B, ns * 32))
    if nch == 1:
        hist = torch.stack([new_hist[0], hist[:, 1]], dim=1)
    else:
        hist = torch.stack(new_hist, dim=1)
    return hist, mad_scale(torch.stack(outs, dim=1))


class BatchedSynth:
    """B concurrent mad_synth instances with their filter FIFOs on the
    device: the batched counterpart of `mp3.Synth`.  State per stream:
    the dct outputs of the 16 most recent slots (`hist`, lo/hi halves)
    and the synthesis phase (`phase`), both device tensors updated in
    place."""

    def __init__(self, batch: int, device=None):
        self.batch = batch
        self.device = resolve_device(device)
        self.hist = torch.zeros((batch, 2, 2, 16, 16), dtype=I32,
                                device=self.device)
        self.phase = torch.zeros(batch, dtype=I32, device=self.device)

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64).reshape(-1),
                               device=self.device)

    def reset(self, idx) -> None:
        i = self._index(idx)
        self.hist[i] = 0
        self.phase[i] = 0

    def load_state(self, hist, phase) -> None:
        """Take over a synthesis state, e.g. the numpy arrays of
        `wmix_tpu.codecs.mp3_batch.BatchedSynth` ([B, 2, 2, 16, 16] int32
        and [B]), copied into this one's tensors."""
        self.hist.copy_(torch.from_numpy(np.array(hist, np.int32)))
        self.phase.copy_(torch.from_numpy(np.array(phase, np.int32)))

    def frame(self, sbsample, nch: int, ns: int) -> torch.Tensor:
        """sbsample [B, 2, >= ns, 32] int32 (numpy or tensor) -> pcm int16
        [B, nch, 32 * ns] on the device (already mad_scale'd)."""
        if isinstance(sbsample, np.ndarray):
            sbsample = torch.from_numpy(
                np.ascontiguousarray(sbsample[:, :, :ns], np.int32))
        sb = sbsample[:, :, :ns].to(self.device, I32)
        hist, pcm = synth_frame(self.hist, sb, self.phase, nch, ns)
        self.hist.copy_(hist)
        self.phase.add_(ns).remainder_(16)
        return pcm


class Mp3BatchDecoder:
    """N concurrent MP3 decodes: per-stream host front-ends (sync,
    Huffman, requantize, IMDCT) and one batched device synthesis per tick.

    Every stream of a tick is decoded with the geometry (nch, ns) of the
    first live stream, as the reference does: the daemon's concurrent mp3
    play tasks over files of one format."""

    def __init__(self, batch: int, device=None):
        from wmix_tpu_torch.codecs.mp3 import Mp3Decoder
        self.batch = batch
        self.front = [Mp3Decoder() for _ in range(batch)]
        self.synth = BatchedSynth(batch, device=device)
        self._gens = [None] * batch

    def start(self, b: int, data: bytes) -> None:
        """Begin decoding `data` on stream b.

        The bitstream front-end is the native C decoder (`mp3fe`); Layer
        I/II streams, `WMIX_MP3FE=0` and machines without a C compiler
        take the Python front-end."""
        from wmix_tpu_torch.codecs import mp3fe
        from wmix_tpu_torch.codecs.mp3 import Mp3Decoder
        self.synth.reset([b])
        if mp3fe.available():
            self._gens[b] = self._native_gen(data)
        else:
            self.front[b] = dec = Mp3Decoder()
            self._gens[b] = dec._frames_sbsample(data)

    @staticmethod
    def _native_gen(data: bytes):
        """Native front-end, restarting on the Python one for Layer I/II."""
        from wmix_tpu_torch.codecs import mp3fe
        from wmix_tpu_torch.codecs.mp3 import Mp3Decoder
        # bound before iterating: a generator finalized at interpreter
        # shutdown would otherwise look the exception up in a torn-down
        # module
        unsupported = mp3fe.UnsupportedLayer
        try:
            yield from mp3fe.frames_sbsample(data)
        except unsupported:
            # the whole stream restarts on the Python front-end (the first
            # frame decides)
            yield from Mp3Decoder()._frames_sbsample(data)

    def tick(self):
        """Decode one frame on every active stream; returns (pcm int16
        numpy [B, nch, n] or None, list of finished streams)."""
        headers = [None] * self.batch
        sbs = [None] * self.batch
        done = []
        for b, gen in enumerate(self._gens):
            if gen is None:
                continue
            try:
                h, sb = next(gen)
            except StopIteration:
                self._gens[b] = None
                done.append(b)
                continue
            headers[b] = h
            sbs[b] = sb
        live = [b for b in range(self.batch) if headers[b] is not None]
        if not live:
            return None, done
        h0 = headers[live[0]]
        nch, ns = h0.nchannels, h0.nbsamples
        sb_all = np.zeros((self.batch, 2, ns, 32), np.int32)
        for b in live:
            sb_all[b] = sbs[b][:, :ns]
        pcm = self.synth.frame(sb_all, nch, ns)
        return pcm.cpu().numpy(), done
