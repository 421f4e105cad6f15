"""Daemon-on-batched-engine bridge (VERDICT r3 next #8): N WmixDaemon
instances' record chains served by ONE StreamServer batch.

The reference daemon runs its record DSP inline in the play heartbeat
(wmix_shmem_write_circle, src/wmix.c:528-872).  Here, each bridged
daemon owns one slot of a shared device batch: the heartbeat feeds
(mic, play) packages into the slot; after the batch step the processed
package returns through ``deliver_record_pkg`` and fans out to the
daemon's shm rings / rw-test loopback exactly as the inline path would.

Pump contract: drive every bridged daemon's ``pump()`` for a tick, then
``bridge.tick()`` once.  Outputs land within the same 20 ms tick, so
play/record stay sample-synchronized (WMIX_RECORD_PLAY_SYNC semantics);
the far-end alignment quirk (playPkgBuff 400 ms FIFO, src/wmix.c:
487-526) is reproduced inside the batched chain per slot.

A daemon whose module switches diverge from the bridge's chain
configuration falls back to its inline processors automatically
(``accepts``) — runtime WMT_*_SW changes therefore keep reference
semantics at the cost of leaving the batch.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from wmix_tpu_torch.service.core import WR_AEC, WR_AGC, WR_NS, WR_VAD
from wmix_tpu_torch.service.stream_server import StreamServer


class EngineBridge:
    """One shared StreamServer batch serving many daemons' record
    chains."""

    def __init__(self, capacity: int, freq: int,
                 ns_enable: bool = True, aec_enable: bool = True,
                 agc_enable: bool = True, vad_enable: bool = True,
                 **chain_kw):
        self.freq = freq
        self.flags = (ns_enable, aec_enable, agc_enable, vad_enable)
        self.server = StreamServer(
            capacity, freq, ns_enable=ns_enable, aec_enable=aec_enable,
            agc_enable=agc_enable, vad_enable=vad_enable, **chain_kw)
        self._handles: Dict[int, int] = {}       # id(daemon) -> handle
        self._fed: List[Tuple[object, int]] = []  # (daemon, handle)

    # ------------------------------------------------------------ admin

    def attach(self, daemon) -> int:
        """Admit a daemon into the batch and point it at this bridge."""
        h = self.server.open_stream()
        self._handles[id(daemon)] = h
        daemon.dsp_bridge = self
        return h

    def detach(self, daemon) -> None:
        h = self._handles.pop(id(daemon), None)
        if h is not None:
            self.server.close_stream(h)
        if getattr(daemon, "dsp_bridge", None) is self:
            daemon.dsp_bridge = None

    def accepts(self, daemon) -> bool:
        """The daemon's geometry and module switches must match the
        batch program (one compiled chain serves every slot)."""
        if id(daemon) not in self._handles:
            return False
        if daemon.cfg.freq != self.freq or daemon.cfg.chn != 1:
            return False
        en = daemon.webrtc_enable
        want = (bool(en[WR_NS]), bool(en[WR_AEC]),
                bool(en[WR_AGC]), bool(en[WR_VAD]))
        return want == self.flags

    # ------------------------------------------------------- data plane

    def feed(self, daemon, mic_pkg: np.ndarray,
             play_pkg: np.ndarray) -> None:
        h = self._handles[id(daemon)]
        self.server.feed(h, mic_pkg, play_pkg)
        self._fed.append((daemon, h))

    def tick(self, max_steps: int = 4) -> int:
        """Run batch steps until every queued package is processed (the
        daemon heartbeat can feed up to 4 packages per pump,
        src/wmix.c:1347), delivering outputs to their daemons in order.
        Returns the number of device steps run."""
        steps = 0
        while self._fed and steps < max_steps:
            fed, self._fed = self._fed, []
            self.server.tick()
            still = []
            for daemon, h in fed:
                out = self.server.read(h)
                if out is None:          # queued behind another package
                    still.append((daemon, h))
                    continue
                origin, _pkg8k, _vad = out
                daemon.deliver_record_pkg(origin)
            # preserve order: unprocessed feeds go first next step
            self._fed = still + self._fed
            steps += 1
        return steps
