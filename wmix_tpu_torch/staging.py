"""Pinned host staging for the copies that cross between host and card on
every tick.

The serving path moves a block of packages to the card and three blocks
of results back every 20 ms (`service/stream_server.py`), and the mix bus
brings its drained packages to the host (`engine/mixbus.py`).  A copy to or
from pageable memory blocks the host; from page-locked (pinned) memory it
is queued on the stream and the host goes on.  Pinning is slow, so the
buffers are allocated once, as a ring of slots, and reused:

  * `upload`: the caller's numpy arrays are copied into a slot's pinned
    buffers and sent with `non_blocking=True`; an event recorded behind the
    copies says when the slot may be written again, and the next upload
    from that slot waits on it.
  * `download`: device tensors are copied into a slot's pinned buffers
    with `non_blocking=True` and an event is recorded behind them.  The
    `Pending` that comes back owns the slot; `result()` waits on the event
    (not on the whole stream), copies the buffers out as numpy arrays and
    only then hands the slot back.  A ring with no free slot raises: its
    size is the number of downloads that may be in flight.

All copies run on the caller's current stream, so a download queues behind
the kernels that made its data and needs no further ordering.  On the CPU
(`device="cpu"`, asked for by the caller) there is nothing to pin and
nothing to wait for: uploads and downloads are plain copies.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device

Spec = Tuple[Tuple[int, ...], torch.dtype]


class _Slot:
    def __init__(self, specs: Sequence[Spec]):
        self.bufs = tuple(torch.empty(shape, dtype=dtype, pin_memory=True)
                          for shape, dtype in specs)
        self.event = torch.cuda.Event()


class Pending:
    """A download in flight.  `result()` gives the numpy arrays, waiting
    for the copies if need be; `np.asarray(pending)` gives the first."""

    def __init__(self, ring: Optional["PinnedRing"], slot: Optional[_Slot],
                 shapes, arrays=None):
        self._ring, self._slot, self._shapes = ring, slot, shapes
        self._arrays = arrays

    def result(self) -> tuple:
        if self._arrays is None:
            self._slot.event.synchronize()
            self._arrays = tuple(
                buf.numpy().reshape(-1)[:int(np.prod(shape))]
                .reshape(shape).copy()
                for buf, shape in zip(self._slot.bufs, self._shapes))
            self._ring._give(self._slot)
            self._slot = None
        return self._arrays

    def __array__(self, dtype=None, copy=None):
        a = self.result()[0]
        return a if dtype is None else a.astype(dtype)


class PinnedRing:
    """`slots` sets of pinned host buffers, one buffer per (shape, dtype) of
    `specs`, each set with a CUDA event.  A download may fill less than a
    whole buffer (its leading elements)."""

    def __init__(self, specs: Sequence[Spec], slots: int, device=None):
        self.device = resolve_device(device)
        self.specs = tuple((tuple(shape), dtype) for shape, dtype in specs)
        self.nbytes = 0
        self._free: deque = deque()
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            self._free.extend(_Slot(self.specs) for _ in range(slots))
            self.nbytes = slots * sum(
                b.numel() * b.element_size() for b in self._free[0].bufs)

    def _take(self) -> _Slot:
        with self._lock:
            if not self._free:
                raise RuntimeError(
                    "staging ring exhausted: more copies in flight than "
                    "the ring has slots")
            return self._free.popleft()

    def _give(self, slot: _Slot) -> None:
        with self._lock:
            self._free.append(slot)

    def upload(self, arrays: Sequence[np.ndarray]) -> tuple:
        """The arrays as tensors on the device, without blocking the host
        on the transfer.  The caller may reuse its arrays at once."""
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(np.array(a)) for a in arrays)
        slot = self._take()
        try:
            slot.event.synchronize()     # the slot's last copy has run
            out = []
            for buf, a in zip(slot.bufs, arrays):
                buf.numpy()[...] = a
                out.append(buf.to(self.device, non_blocking=True))
            slot.event.record()
        finally:
            self._give(slot)             # the next taker waits on the event
        return tuple(out)

    def download(self, tensors: Sequence[torch.Tensor]) -> Pending:
        """Start copying the tensors to the host; the result is read from
        the `Pending` later."""
        shapes = [tuple(t.shape) for t in tensors]
        if self.device.type == "cpu":
            return Pending(None, None, shapes,
                           tuple(t.numpy().copy() for t in tensors))
        slot = self._take()
        for buf, t, shape in zip(slot.bufs, tensors, shapes):
            n = t.numel()
            if t.dtype != buf.dtype or n > buf.numel():
                self._give(slot)
                raise ValueError(f"download of {t.dtype} {shape} into a "
                                 f"{buf.dtype} buffer of {buf.numel()}")
            buf.view(-1)[:n].view(shape).copy_(t, non_blocking=True)
        slot.event.record()
        return Pending(self, slot, shapes)
