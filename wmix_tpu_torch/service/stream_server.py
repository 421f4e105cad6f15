"""Multi-stream record server: the batched engine behind a daemon-style
stream surface.

Port of `wmix_tpu/service/stream_server.py`.  The reference daemon runs
one record chain for its one sound card (wmix_shmem_write_circle,
src/wmix.c:528-872); this server is the product path for thousands of
concurrent record chains on one card: a fixed-capacity batch of stream
slots served by one `RecordChain.step` per tick, with a host front end
that admits and reaps client streams into slots.

Semantics against the reference (a documented deviation): slot admission
resets the slot's DSP state (NS quantiles, AEC partitions, AGC capacitors,
VAD GMM, far-end FIFO) but joins the batch-shared host cursor phase: every
slot advances through the same AEC buffer plan, because the plan does not
depend on the data and is the same for every stream that ticks once per
20 ms (engine/aec_plan.py).  A freshly admitted slot therefore behaves
like a chain whose adaptive state was zeroed mid-stream, not like one
cold-started through the 3-package start-up passthrough; its outputs are
bit-exact against a dedicated RecordChain at the same tick phase
(tests/test_torch_stream_server.py).  Cancellation (the reference's
generation counters, src/wmixConf.h:186-189) becomes slot masking plus
reinit.

Three serving shapes:
  * tick(): one chain step per 20 ms package over all B slots, blocking
    until that package's outputs are on the host; the simplest mode (tests
    and single-stream embedders).
  * tick_pipelined(): the real-time mode.  The heartbeat the reference
    keeps is "start one package of work every 20 ms"
    (src/wmix.c:1336-1345); what must fit in the 20 ms budget is the
    per-tick host work (gather, launching the step's kernels, starting the
    copies to the host, draining completed ticks), not the device round
    trip: the reference's own record path likewise runs behind a DMA ring
    and the 400 ms AEC FIFO (platform/alsa/plat.h:19).  The outputs are
    copied into pinned host buffers as the tick is started, with an event
    behind them, and scattered `depth` ticks later, so no tick blocks on a
    round trip; output latency = depth * 20 ms + residual fetch.
  * tick_chunk(): K packages per call for throughput-first deployments
    that can afford K*20 ms of latency.

Host and card.  A fast-lane block is copied into a pinned staging buffer
and sent without blocking (`staging.PinnedRing.upload`); a pipelined tick's
outputs come back through a ring of pinned buffers, one event each
(`download`), sized in `__init__` for the `2 * depth + 1` ticks that
back-pressure allows in flight.  All copies run on the pump thread's
stream, behind the tick that made their data.  On the CPU (`device="cpu"`,
which the caller asks for) there is nothing to pin and the copies are
plain ones.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from wmix_tpu_torch.engine.chain import RecordChain
from wmix_tpu_torch.staging import PinnedRing

UPLOAD_SLOTS = 4    # staging buffers of the fast lane; each is free again
                    # as soon as its copy to the card has run


class SlotClosed(Exception):
    pass


def _host(t: torch.Tensor) -> np.ndarray:
    """A device value as a numpy array of its own (blocking).  Every
    blocking device -> numpy conversion of the module goes through here;
    a CPU tensor is copied too, because the chain updates its state in
    place and the VAD flags are a leaf of it."""
    return t.cpu().numpy() if t.is_cuda else t.numpy().copy()


class StreamServer:
    """B-slot record-chain server.

    Thread-safe admission/feed; the chain runs in the caller's pump thread
    (tick()) so tests and embedders control pacing.  `device=None` (among
    `chain_kw`) passes through to the chain and means the card.
    `max_depth` is the largest `depth` that `tick_pipelined` will be given:
    the pinned output ring is allocated for it here, once."""

    def __init__(self, capacity: int, freq: int, max_depth: int = 12,
                 **chain_kw):
        self.capacity = capacity
        self.freq = freq
        self.pkg_len = freq // 1000 * 20
        self.chain = RecordChain(capacity, freq, **chain_kw)
        self.max_depth = max_depth
        dev = self.chain.device
        blk = ((capacity, self.pkg_len), torch.int16)
        self._in_ring = PinnedRing([blk, blk], UPLOAD_SLOTS, dev)
        self._out_ring = PinnedRing(
            [blk, ((capacity, self.chain.zoom_idx.shape[0]), torch.int16),
             ((capacity,), torch.int32)], 2 * max_depth + 2, dev)
        self._free = list(range(capacity))[::-1]
        # numpy so feed_batch can validate B handles vectorized
        self._gen = np.zeros(capacity, np.int64)  # per-slot generation
        self._active = np.zeros(capacity, bool)
        self._lock = threading.Lock()
        # slots admitted since the last tick; their DSP state resets are
        # applied by the PUMP thread at the next tick: the chain changes
        # its state in place and its kernels run asynchronously on the pump
        # thread's stream, so a reset made from a reader thread could
        # land in the middle of a step
        self._pending_reset: list = []
        # per-slot staging for the next tick and output queues
        self._mic_in: Dict[int, list] = {}
        self._play_in: Dict[int, list] = {}
        self._out: Dict[int, list] = {}
        self._zeros = np.zeros(self.pkg_len, np.int16)
        # pipelined realtime mode: in-flight (fed, pending download)
        # awaiting their copies to the host (tick_pipelined)
        self._inflight: deque = deque()
        # optional background drainer (start_drain_thread): moves the
        # wait for the copies and the scatter OFF the pump thread, so pump
        # work = gather + launching the step and its copies
        self._drainer: Optional[threading.Thread] = None
        self._drain_cv = threading.Condition()
        self._drain_stop = False
        self._drain_busy = False
        # whole-batch fast lane: when every slot is fed exactly once per
        # tick in slot order (the capture-DMA shape), packages travel as
        # [B, pkg] blocks and never touch per-slot Python queues; mixed
        # use spills blocks into the queues first, preserving order
        self._block_q: deque = deque()       # (mic_block, play_block)
        self._out_blocks: deque = deque()    # (origin, pkg8k, vad)
        self._pending_pkgs = 0               # per-slot queued packages
        self._fed_all = [(s, 1) for s in range(capacity)]
        self._slots_all = np.arange(capacity, dtype=np.int64)

    @property
    def pinned_bytes(self) -> int:
        """Page-locked host memory held by the staging rings."""
        return self._in_ring.nbytes + self._out_ring.nbytes

    # -- admission ----------------------------------------------------

    def open_stream(self) -> int:
        """Admit a stream; returns a handle (slot | gen<<16)."""
        with self._lock:
            if not self._free:
                raise RuntimeError("no free stream slots")
            # route queued fast-lane blocks to the OLD generations before
            # this slot's queues are reset (stale audio must not reach
            # the new stream)
            self._spill_blocks_locked()
            self._spill_out_blocks_locked()
            slot = self._free.pop()
            self._gen[slot] += 1
            self._active[slot] = True
            self._mic_in[slot] = []
            self._play_in[slot] = []
            self._out[slot] = []
            self._pending_reset.append(slot)
        return slot | (int(self._gen[slot]) << 16)

    def close_stream(self, handle: int) -> None:
        slot = handle & 0xFFFF
        with self._lock:
            if slot >= self.capacity or not self._active[slot] or \
                    self._gen[slot] != handle >> 16:
                return
            self._spill_blocks_locked()
            self._spill_out_blocks_locked()
            self._active[slot] = False
            self._mic_in.pop(slot, None)
            self._play_in.pop(slot, None)
            self._out.pop(slot, None)
            self._free.append(slot)

    def _check(self, handle: int) -> int:
        slot = handle & 0xFFFF
        if slot >= self.capacity or not self._active[slot] or \
                self._gen[slot] != handle >> 16:
            raise SlotClosed(f"stream {handle:#x} is closed")
        return slot

    # -- data plane ---------------------------------------------------

    def feed(self, handle: int, mic_pkg: np.ndarray,
             play_pkg: Optional[np.ndarray] = None) -> None:
        """Queue one 20 ms package for the stream (mic capture plus the
        far-end/speaker package for AEC; zeros when the client plays
        nothing)."""
        slot = self._check(handle)
        mic = np.asarray(mic_pkg, np.int16)
        play = self._zeros if play_pkg is None else \
            np.asarray(play_pkg, np.int16)
        if mic.shape != (self.pkg_len,) or play.shape != (self.pkg_len,):
            raise ValueError(f"a package is {self.pkg_len} int16 samples, "
                             f"got mic {mic.shape} play {play.shape}")
        with self._lock:
            self._spill_blocks_locked()
            self._mic_in[slot].append(mic)
            self._play_in[slot].append(play)
            self._pending_pkgs += 1

    def feed_batch(self, handles, mic_block: np.ndarray,
                   play_block: Optional[np.ndarray] = None) -> None:
        """Queue one 20 ms package for MANY streams in one call.

        mic_block/play_block: [len(handles), pkg_len] int16.  This is
        the capture-DMA shape: the reference's sound card delivers one
        interleaved block per period for all its channels at once
        (platform/alsa/plat.c:224-278); a front door that owns many
        client streams hands the engine the same thing, and per-slot
        Python bookkeeping (the feed() loop) has no place in a 20 ms
        budget at a large B."""
        mic_block = np.asarray(mic_block, np.int16)
        if play_block is None:
            play_block = np.zeros_like(mic_block)
        else:
            play_block = np.asarray(play_block, np.int16)
        h = np.asarray(handles, np.int64)
        want = (h.shape[0], self.pkg_len)
        if mic_block.shape != want or play_block.shape != want:
            raise ValueError(f"blocks must be {want} int16, got mic "
                             f"{mic_block.shape} play {play_block.shape}")
        slots = h & 0xFFFF
        if (slots >= self.capacity).any():
            raise SlotClosed("a handle names a slot beyond the capacity")
        ok = self._active[slots] & (self._gen[slots] == (h >> 16))
        if not ok.all():
            bad = int(h[np.argmin(ok)])
            raise SlotClosed(f"stream {bad:#x} is closed")
        with self._lock:
            if (self._pending_pkgs == 0 and
                    slots.shape[0] == self.capacity and
                    np.array_equal(slots, self._slots_all)):
                # capture-DMA fast lane: the whole batch in slot order.
                # Start the transfer to the card NOW, from pinned memory,
                # so it overlaps the rest of the tick; the caller's blocks
                # are pageable, hence the staging copy.
                self._block_q.append(
                    self._in_ring.upload((mic_block, play_block)))
                return
            self._spill_blocks_locked()
            for i in range(slots.shape[0]):
                s = int(slots[i])
                self._mic_in[s].append(mic_block[i])
                self._play_in[s].append(play_block[i])
            self._pending_pkgs += slots.shape[0]

    def _spill_blocks_locked(self) -> None:
        """Demote queued whole-batch blocks to the per-slot queues (slow
        path for mixed feed()/feed_batch() use; preserves order)."""
        while self._block_q:
            mic_b, play_b = self._block_q.popleft()
            # fast-lane blocks live on the device; per-slot queues are host
            mic_b, play_b = _host(mic_b), _host(play_b)
            for s in range(self.capacity):
                if self._active[s]:
                    self._mic_in[s].append(mic_b[s])
                    self._play_in[s].append(play_b[s])
                    self._pending_pkgs += 1

    def _spill_out_blocks_locked(self) -> None:
        """Demote whole-batch output blocks to the per-slot out queues
        (so read() sees fast-lane results)."""
        while self._out_blocks:
            origin, pkg8k, vad = self._out_blocks.popleft()
            for s in range(self.capacity):
                if s in self._out:
                    self._out[s].append((origin[s], pkg8k[s], vad[s]))

    def read(self, handle: int):
        """Pop one processed package (origin int16 [pkg], pkg8k int16,
        vad int32) or None if none pending."""
        slot = self._check(handle)
        with self._lock:
            self._spill_out_blocks_locked()
            if self._out[slot]:
                return self._out[slot].pop(0)
        return None

    def read_batch(self, handles):
        """Pop one processed package per handle, stacked: (origin
        [N, pkg] int16, pkg8k [N, n8k] int16, vad [N] int32), the
        fast-lane counterpart of feed_batch.  Returns None unless every
        handle has a package pending."""
        h = np.asarray(handles, np.int64)
        slots = h & 0xFFFF
        with self._lock:
            if (self._out_blocks and
                    slots.shape[0] == self.capacity and
                    np.array_equal(slots, self._slots_all) and
                    not any(self._out[s] for s in self._out)):
                return self._out_blocks.popleft()
            self._spill_out_blocks_locked()
            if any(not self._out.get(int(s)) for s in slots):
                return None
            picks = [self._out[int(s)].pop(0) for s in slots]
        return (np.stack([p[0] for p in picks]),
                np.stack([p[1] for p in picks]),
                np.stack([p[2] for p in picks]))

    # -- device pump ----------------------------------------------------

    def _gather_one(self):
        """One tick's input: (mic [B, pkg], play [B, pkg], fed).  The
        fast lane hands back the staged device block as it is, which
        `RecordChain.step` takes without a copy."""
        with self._lock:
            if self._block_q and self._pending_pkgs == 0:
                mic_b, play_b = self._block_q.popleft()
                return mic_b, play_b, self._fed_all
        mic, play, fed = self._gather(1)
        return mic[0], play[0], fed

    def _gather(self, n: int):
        with self._lock:
            self._spill_blocks_locked()
            mic = np.zeros((n, self.capacity, self.pkg_len), np.int16)
            play = np.zeros_like(mic)
            fed = []
            for slot in range(self.capacity):
                if not self._active[slot]:
                    continue
                q = self._mic_in[slot]
                take = min(len(q), n)
                for k in range(take):
                    mic[k, slot] = q[k]
                    play[k, slot] = self._play_in[slot][k]
                del q[:take], self._play_in[slot][:take]
                self._pending_pkgs -= take
                fed.append((slot, take))
        return mic, play, fed

    def _scatter(self, fed, origin, pkg8k, vad):
        """Deliver host arrays [K, B, ...] to the output queues."""
        with self._lock:
            if fed is self._fed_all:
                # fast lane: keep the tick's outputs as one block
                self._out_blocks.append((origin[0], pkg8k[0], vad[0]))
                return
            for slot, take in fed:
                if slot not in self._out:
                    continue
                for k in range(take):
                    self._out[slot].append(
                        (origin[k, slot], pkg8k[k, slot], vad[k, slot]))

    def _apply_pending_resets(self) -> None:
        with self._lock:
            slots, self._pending_reset = self._pending_reset, []
        if slots:
            self.chain.reset_slots(slots)

    def tick(self) -> None:
        """One 20 ms batch step over all slots (realtime mode).  Slots
        with no queued input process silence (their state still advances
        in lockstep, as the daemon's record heartbeat does when the mic
        delivers nothing, src/wmix.c:608-611).  Must be called from ONE
        pump thread: the chain state is owned by the caller."""
        self._apply_pending_resets()
        mic, play, fed = self._gather_one()
        origin, pkg8k, vad = self.chain.step(mic, play)
        self._scatter(fed, _host(origin)[None], _host(pkg8k)[None],
                      _host(vad)[None])

    def tick_pipelined(self, depth: int = 12) -> None:
        """One 20 ms batch step, realtime mode: start this tick's package
        and START its copies to the host, but only block on (and deliver)
        the tick started `depth` ticks ago, whose copies have had
        depth*20 ms to complete, so the pop costs next to nothing instead
        of a device round trip.  Per-tick host cost = gather + launching the
        step + drain; end-to-end output latency = depth ticks + residual
        fetch.  Call flush_pipeline() to drain at shutdown."""
        if depth > self.max_depth:
            raise ValueError(f"depth {depth} > max_depth {self.max_depth} "
                             "that the output ring was allocated for")
        self._apply_pending_resets()
        mic, play, fed = self._gather_one()
        pending = self._out_ring.download(self.chain.step(mic, play))
        if self._drainer is not None:
            with self._drain_cv:
                self._inflight.append((fed, pending))
                self._drain_cv.notify()
                # backpressure: a drainer that can't keep up means the
                # device can't sustain the tick rate; surface that as pump
                # time, not unbounded memory
                while len(self._inflight) > 2 * depth:
                    self._check_drainer()
                    self._drain_cv.wait(0.005)
            return
        self._inflight.append((fed, pending))
        while len(self._inflight) > depth:
            self._drain_one()

    def _deliver(self, fed, pending) -> None:
        origin, pkg8k, vad = pending.result()    # waits on the tick's event
        self._scatter(fed, origin[None], pkg8k[None], vad[None])

    def start_drain_thread(self) -> None:
        """Move output delivery off the pump thread: a daemon thread
        waits on each in-flight tick's event and scatters its host
        buffers, so tick_pipelined's own work is gather + launching the
        step and its copies.  The drainer touches events, host buffers and
        the output queues, never the chain, so the one-pump-thread
        ownership rule still holds."""
        if self._drainer is not None:
            return

        def loop() -> None:
            while True:
                with self._drain_cv:
                    while not self._inflight and not self._drain_stop:
                        self._drain_cv.wait(0.1)
                    if self._drain_stop and not self._inflight:
                        return
                    fed, pending = self._inflight.popleft()
                    self._drain_busy = True
                    self._drain_cv.notify()
                try:
                    self._deliver(fed, pending)
                finally:
                    with self._drain_cv:
                        self._drain_busy = False
                        self._drain_cv.notify_all()

        self._drainer = threading.Thread(target=loop, daemon=True,
                                         name="wmix-drain")
        self._drainer.start()

    def _check_drainer(self) -> None:
        """A drain thread that died of an error would leave its waiters
        waiting for ever."""
        if not self._drainer.is_alive():
            raise RuntimeError("the drain thread has died; see its "
                               "traceback")

    def stop_drain_thread(self) -> None:
        if self._drainer is None:
            return
        with self._drain_cv:
            self._drain_stop = True
            self._drain_cv.notify_all()
        self._drainer.join()
        self._drainer = None
        self._drain_stop = False

    def _drain_one(self) -> None:
        self._deliver(*self._inflight.popleft())

    def flush_pipeline(self) -> None:
        """Deliver every in-flight tick (blocking)."""
        if self._drainer is not None:
            while True:
                with self._drain_cv:
                    if not self._inflight and not self._drain_busy:
                        return
                    self._check_drainer()
                    self._drain_cv.wait(0.005)
        while self._inflight:
            self._drain_one()

    def tick_chunk(self, k_pkgs: int) -> None:
        """K packages in one call (throughput mode, +K*20 ms latency)."""
        self._apply_pending_resets()
        mic, play, fed = self._gather(k_pkgs)
        origin, pkg8k, vad = self.chain.run_chunk(mic, play)
        self._scatter(fed, _host(origin), _host(pkg8k), _host(vad))
