"""Batched play/mix engine: a [B_engines, R, chn] device-resident mix bus.

Port of `wmix_tpu/engine/mixbus.py`.  The reference's mixer hot loop
(`wmix_load_data`, src/wmix.c:1639-1957) mixes each playing stream into a
1-second int16 ring with a saturating add and a truncating
background-attenuation divide, and the play thread (`wmix_play_thread`,
src/wmix.c:1304-1516) drains up to 4 packages per 20 ms tick, zeroing the
drained region.  This module batches both over B concurrent engines:

  * ``mix``: one source-wave across all engines: saturating scatter-add
    of [B, T, chn] contributions at per-engine cursors, with per-engine
    reduce divides and a per-engine valid length (engines with no source
    this wave ride along with len 0).  An engine serving k sources runs
    k waves; the host groups the j-th source of every engine into wave j.
  * ``drain``: the play heartbeat: copy + zero K packages per engine at
    the per-engine play cursor (``wmix->head``), advance the cursor and
    the tick counter.

All integer, so the port is held bit-equal to the original and to the
single-engine host mixer (tests/test_torch_mixbus.py).  The ring is
updated in place.  Contribution frames come from the host mixer's
``build_contrib`` (the bit-exact rate/channel conversion of the C mixer).
"""
from __future__ import annotations

import numpy as np
import torch

from wmix_tpu_torch.config import EngineConfig
from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.ops.mixer import mix_frames
from wmix_tpu_torch.staging import Pending, PinnedRing

I16 = torch.int16
I32 = torch.int32

MAX_DRAIN_PKGS = 4      # the play thread drains at most 4 packages a tick
DRAIN_SLOTS = 8         # drains whose copy to the host may be in flight


def _positions(cursors: torch.Tensor, n: int, ring_frames: int):
    """Index pair (engine [B, 1], frame [B, n]) of n ring frames from each
    engine's cursor, wrapping."""
    dev = cursors.device
    pos = (cursors.to(torch.int64)[:, None] +
           torch.arange(n, device=dev)) % ring_frames
    return torch.arange(cursors.shape[0], device=dev)[:, None], pos


def _mix_wave_(ring, heads, contrib, lens, rdce) -> None:
    """ring [B,R,chn] i16, in place; heads [B] i32 (frame cursor); contrib
    [B,T,chn] i16; lens [B] i32 (valid frames); rdce [B] i32.  T <= R, so
    an engine's positions are distinct and the write is deterministic;
    frames beyond `lens` write back what was there."""
    T = contrib.shape[1]
    b_idx, pos = _positions(heads, T, ring.shape[1])
    cur = ring[b_idx, pos]
    mixed = mix_frames(cur, contrib, rdce[:, None, None])
    valid = (torch.arange(T, device=ring.device) < lens[:, None])[..., None]
    ring[b_idx, pos] = torch.where(valid, mixed, cur)


class MixBus:
    """B concurrent engines' mix rings + play cursors on the device (the
    card unless `device="cpu"` is asked for).

    Host-mirrored state: the play cursor (``wmix->head``) and tick per
    engine; per-task writer cursors live with the tasks, exactly as the
    reference keeps them in each task thread's locals."""

    def __init__(self, batch: int, cfg: EngineConfig = EngineConfig(),
                 device=None):
        self.device = resolve_device(device)
        self.batch = batch
        self.cfg = cfg
        self.R = cfg.ring_frames
        self.ring = torch.zeros((batch, self.R, cfg.chn), dtype=I16,
                                device=self.device)
        self.head_off = np.zeros(batch, np.int64)   # play cursor, bytes
        self.tick = np.zeros(batch, np.int64)       # bytes played
        self._drain_ring = PinnedRing(
            [((batch, MAX_DRAIN_PKGS * cfg.frame_num, cfg.chn), I16)],
            DRAIN_SLOTS, self.device)

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    # ------------------------------------------------------------- mix

    def mix(self, slots, head_frames, contribs, rdces) -> np.ndarray:
        """One source-wave: contribs[i] (int16 [T_i, chn]) mixes into
        engine slots[i] at frame cursor head_frames[i] with reduce
        divisor rdces[i].  Returns the new per-source frame cursors.

        Contributions longer than the ring are chunked exactly like the
        host mixer's load_data."""
        slots = np.asarray(slots, np.int32)
        head_frames = np.asarray(head_frames, np.int64).copy()
        rdces = np.asarray(rdces, np.int32)
        R = self.R
        remaining = [np.asarray(c, np.int16).reshape(-1, self.cfg.chn)
                     for c in contribs]
        offs = np.zeros(len(remaining), np.int64)
        while True:
            lens = np.array([min(c.shape[0] - o, R)
                             for c, o in zip(remaining, offs)], np.int32)
            if not (lens > 0).any():
                break
            T = int(lens.max())
            wave = np.zeros((self.batch, T, self.cfg.chn), np.int16)
            heads = np.zeros(self.batch, np.int32)
            wlens = np.zeros(self.batch, np.int32)
            wrd = np.ones(self.batch, np.int32)
            for i, s in enumerate(slots):
                if lens[i] <= 0:
                    continue
                o = offs[i]
                wave[s, :lens[i]] = remaining[i][o:o + lens[i]]
                heads[s] = (head_frames[i] + o) % R
                wlens[s] = lens[i]
                wrd[s] = rdces[i]
            _mix_wave_(self.ring, self._dev(heads, np.int32),
                       self._dev(wave, np.int16),
                       self._dev(wlens, np.int32), self._dev(wrd, np.int32))
            offs += np.maximum(lens, 0)
        return (head_frames + offs) % R

    def mix_waves(self, head_frames: np.ndarray, waves: np.ndarray,
                  lens: np.ndarray, rdces: np.ndarray) -> None:
        """Dense fast lane: S source-waves for ALL engines in one call
        (the per-tick shape of a full deployment: every engine's j-th
        source grouped into wave j, engines without one riding along with
        len 0).

        head_frames/lens/rdces: [S, B] int32; waves: [S, B, T, chn]
        int16 with T <= ring frames.  Wave order is the mix order: each
        wave saturates against what the last one left
        (src/wmix.c:1683-1691), so the waves run one after the other."""
        waves = self._dev(waves, np.int16)
        if waves.shape[2] > self.R:
            raise ValueError(f"a wave of {waves.shape[2]} frames exceeds "
                             f"the ring's {self.R}")
        heads = self._dev(np.asarray(head_frames, np.int32) % self.R,
                          np.int32)
        lens = self._dev(lens, np.int32)
        rdces = self._dev(rdces, np.int32)
        for s in range(waves.shape[0]):
            _mix_wave_(self.ring, heads[s], waves[s], lens[s], rdces[s])

    # ----------------------------------------------------------- drain

    def drain_async(self, n_pkgs: int = 1) -> Pending:
        """The play heartbeat without the device round trip: starts the
        copy+zero at the play cursor and STARTS the copy to a pinned host
        buffer, with an event behind it.  Returns the `Pending`:
        np.asarray() it a few ticks later (the realtime pump pattern,
        service/stream_server.py tick_pipelined).  At most DRAIN_SLOTS
        drains may be pending, of at most MAX_DRAIN_PKGS packages each."""
        if not 1 <= n_pkgs <= MAX_DRAIN_PKGS:
            raise ValueError(f"n_pkgs {n_pkgs} outside 1..{MAX_DRAIN_PKGS}")
        cfg = self.cfg
        n_frames = n_pkgs * cfg.frame_num
        tails = (self.head_off % cfg.buff_size) // cfg.frame_size
        b_idx, pos = _positions(self._dev(tails, np.int32), n_frames, self.R)
        pcm = self.ring[b_idx, pos]
        self.ring[b_idx, pos] = 0
        f0 = tails + n_frames
        self.head_off = (f0 % self.R) * cfg.frame_size
        self.tick = (self.tick + n_pkgs * cfg.pkg_size) & 0xFFFFFFFF
        return self._drain_ring.download([pcm])

    def drain(self, n_pkgs: int = 1) -> np.ndarray:
        """The play heartbeat: n_pkgs packages per engine, copied and
        zeroed at the play cursor; cursors/ticks advance.  Returns
        int16 [B, n_pkgs * frame_num, chn] (blocking form of
        drain_async)."""
        return self.drain_async(n_pkgs).result()[0]

    def has_data(self) -> np.ndarray:
        """[B] bool: per-engine idle detection input (the playRun
        arbitration, src/wmix.c:1229-1280)."""
        return (self.ring != 0).flatten(1).any(dim=1).cpu().numpy()

    def reset_slots(self, slots) -> None:
        """Idle reset (src/wmix.c:1246-1259): zero the ring and rewind
        the cursors of the given engines."""
        idx = np.atleast_1d(np.asarray(slots, np.int64))
        self.ring[self._dev(idx, np.int64)] = 0
        self.head_off[idx] = 0
        self.tick[idx] = 0


class TaskCursor:
    """Per play-task writer bookkeeping: the head-placement and tick
    rules of wmix_load_data (src/wmix.c:1666-1673,1942-1955), vectorized
    over nothing — one instance per (engine, task), as the reference
    keeps these in task-thread locals."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.head_off = -1
        self.tick = 0

    def place(self, engine_head_off: int, engine_tick: int) -> int:
        """Returns the frame cursor to write at; updates local state."""
        cfg = self.cfg
        if self.head_off < 0 or self.tick < engine_tick:
            self.head_off = engine_head_off + cfg.play_correct
            self.tick = engine_tick + cfg.play_correct
            if self.head_off >= cfg.buff_size:
                self.head_off = 0
        return self.head_off // cfg.frame_size

    def advance(self, new_head_frame: int, bytes_written: int,
                engine_head_off: int, engine_tick: int) -> None:
        cfg = self.cfg
        self.head_off = (new_head_frame * cfg.frame_size) % cfg.buff_size
        if self.tick < engine_tick:
            self.head_off = engine_head_off + bytes_written
            self.tick = bytes_written + engine_tick
            if self.head_off >= cfg.buff_size:
                self.head_off -= cfg.buff_size
        else:
            self.tick += bytes_written
