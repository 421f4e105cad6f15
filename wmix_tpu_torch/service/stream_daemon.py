"""Socket front door for the multi-stream record engine: external clients
stream 20 ms packages over a socket into StreamServer slots and read DSP
output back, pumped by a real-time thread with deadline accounting.

Port of `wmix_tpu/service/stream_daemon.py`; the wire protocol is the same
byte for byte, so either package's client talks to either daemon.

Reference analog: the daemon's stream fan-in/fan-out surfaces, FIFO PCM
record/play tasks (src/wmixTask.c:122-408) and the SysV shm rings
(src/wmixMem.c:121-168), inverted for the batch engine: instead of one
thread per stream copying through kernel FIFOs, one pump thread drives ONE
chain step per tick over all B slots, and per-connection reader threads
only marshal bytes into slot queues.

Wire protocol (framed, little-endian, SOCK_STREAM over a Unix socket or
TCP):

    frame   := type:u8  handle:u32  length:u32  payload[length]
    client->server:
      0x01 OPEN   payload ""            -> server replies OPENED
      0x02 FEED   payload mic:int16[pkg] [+ play:int16[pkg]]
                  (one 20 ms package; play is the far-end/speaker feed
                   for AEC, zeros when absent)
      0x03 CLOSE  payload ""
    server->client:
      0x81 OPENED handle=assigned stream handle
      0x82 PKG    payload origin:int16[pkg] + pkg8k:int16[n8k] + vad:i32
      0x7F ERR    payload utf-8 message (e.g. "no free stream slots")

Entry point: ``wmix-tpu-torch-stream`` (pyproject [project.scripts]), or
``python -m wmix_tpu_torch.service.stream_daemon``: serves on the card
(``--device cpu`` for the CPU) until SIGINT, then prints the tick-latency
summary (p50/p95 against the 20 ms budget, utils/trace.StepTimer).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np

from wmix_tpu_torch.service.stream_server import SlotClosed, StreamServer
from wmix_tpu_torch.utils.trace import StepTimer

T_OPEN = 0x01
T_FEED = 0x02
T_CLOSE = 0x03
T_OPENED = 0x81
T_PKG = 0x82
T_ERR = 0x7F

_HDR = struct.Struct("<BII")
# no frame of the protocol is longer than a FEED of two 20 ms packages
# (a few KB); a header that claims more than this is not obeyed
MAX_PAYLOAD = 1 << 16


def _send_frame(sock: socket.socket, typ: int, handle: int,
                payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(typ, handle, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket):
    """(type, handle, payload), or None when the peer closed or sent a
    header that no frame of the protocol has."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    typ, handle, length = _HDR.unpack(hdr)
    if length > MAX_PAYLOAD:
        return None
    payload = _recv_exact(sock, length) if length else b""
    if length and payload is None:
        return None
    return typ, handle, payload


class StreamDaemon:
    """Socket server + real-time pump over a StreamServer.

    * acceptor thread: accepts connections, spawns a reader per client;
    * reader threads: parse frames, stage packages into slot queues;
    * pump thread: every `interval_ms` of wall clock runs ONE batched
      chain step over all slots (`StreamServer.tick`) and pushes each
      fed slot's output package back to its connection.  In chunk mode
      (`chunk_pkgs` > 1) it runs every chunk_pkgs*interval_ms and makes
      one multi-package call (throughput mode, +chunk latency).

    Deadline accounting: a StepTimer with budget = the tick's audio
    duration; `stats()` returns p50/p95/max vs budget.  `chain_kw` goes to
    the chain; without a `device` among it the daemon runs on the card.
    """

    def __init__(self, address, capacity: int = 64, freq: int = 16000,
                 chunk_pkgs: int = 1, realtime: bool = True,
                 **chain_kw):
        self.address = address
        self.server = StreamServer(capacity, freq, **chain_kw)
        self.pkg_len = self.server.pkg_len
        self.n8k = 8000 // 1000 * 20
        self.interval_ms = 20
        self.chunk_pkgs = chunk_pkgs
        self.realtime = realtime
        self.timer = StepTimer(budget_ms=self.interval_ms * chunk_pkgs)
        self._conn_of: Dict[int, socket.socket] = {}   # handle -> conn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        if isinstance(address, tuple):
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        else:
            if os.path.exists(address):
                os.unlink(address)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(address)
        self._sock.listen(capacity + 8)

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        for fn in (self._accept_loop, self._pump_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        try:
            # wakes the acceptor parked in accept(); close alone does not
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        # unblock reader threads parked in recv()
        with self._lock:
            conns = set(self._conn_of.values())
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2)
        if isinstance(self.address, str) and os.path.exists(self.address):
            os.unlink(self.address)

    def stats(self) -> dict:
        s = self.timer.summary()
        s["capacity"] = self.server.capacity
        s["freq"] = self.server.freq
        s["chunk_pkgs"] = self.chunk_pkgs
        return s

    # -- socket side --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self, conn: socket.socket) -> None:
        handles = []
        try:
            while not self._stop.is_set():
                frame = _recv_frame(conn)
                if frame is None:
                    break
                typ, handle, payload = frame
                if typ == T_OPEN:
                    try:
                        h = self.server.open_stream()
                    except RuntimeError as e:
                        _send_frame(conn, T_ERR, 0, str(e).encode())
                        continue
                    handles.append(h)
                    with self._lock:
                        self._conn_of[h] = conn
                    _send_frame(conn, T_OPENED, h)
                elif typ == T_FEED:
                    n = self.pkg_len * 2
                    try:
                        mic = np.frombuffer(payload[:n], np.dtype("<i2"))
                        play = (np.frombuffer(payload[n:2 * n],
                                              np.dtype("<i2"))
                                if len(payload) >= 2 * n else None)
                        self.server.feed(handle, mic, play)
                    except (SlotClosed, ValueError) as e:
                        _send_frame(conn, T_ERR, handle,
                                    str(e).encode())
                elif typ == T_CLOSE:
                    self._close_handle(handle)
        except OSError:
            pass        # the peer went away, or stop() shut the socket
        finally:
            for h in handles:
                self._close_handle(h)
            try:
                conn.close()
            except OSError:
                pass

    def _close_handle(self, handle: int) -> None:
        self.server.close_stream(handle)
        with self._lock:
            self._conn_of.pop(handle, None)

    # -- pump side ----------------------------------------------------

    def _pump_loop(self) -> None:
        period = self.interval_ms * self.chunk_pkgs / 1000.0
        next_t = time.perf_counter()
        while not self._stop.is_set():
            with self.timer.step():
                self._pump_once()
            next_t += period
            if self.realtime:
                now = time.perf_counter()
                if now < next_t:
                    time.sleep(next_t - now)
                else:
                    # fell behind: re-anchor rather than burst-spin (the
                    # reference's self-clocking play loop does the same
                    # catch-up, src/wmix.c:1448-1455)
                    next_t = now

    def _pump_once(self) -> None:
        if self.chunk_pkgs == 1:
            self.server.tick()
        else:
            self.server.tick_chunk(self.chunk_pkgs)
        # push pending outputs to their connections
        with self._lock:
            targets = list(self._conn_of.items())
        for handle, conn in targets:
            while True:
                try:
                    item = self.server.read(handle)
                except SlotClosed:
                    break
                if item is None:
                    break
                origin, pkg8k, vad = item
                payload = (np.asarray(origin, "<i2").tobytes() +
                           np.asarray(pkg8k, "<i2").tobytes() +
                           struct.pack("<i", int(vad)))
                try:
                    _send_frame(conn, T_PKG, handle, payload)
                except OSError:
                    self._close_handle(handle)
                    break


class StreamSocketClient:
    """Client of the stream daemon's wire protocol (the rebuild analog
    of wmix_user's fifo_record path, srcMsg/wmix_user.c:403-452)."""

    def __init__(self, address):
        fam = socket.AF_INET if isinstance(address, tuple) \
            else socket.AF_UNIX
        self.sock = socket.socket(fam, socket.SOCK_STREAM)
        self.sock.connect(address)
        self.handle = None

    def open(self) -> int:
        _send_frame(self.sock, T_OPEN, 0)
        typ, handle, payload = self._next_frame()
        if typ == T_ERR:
            raise RuntimeError(payload.decode())
        if typ != T_OPENED:
            raise ConnectionError(f"OPEN answered with frame {typ:#x}")
        self.handle = handle
        return handle

    def feed(self, mic: np.ndarray, play: Optional[np.ndarray] = None):
        payload = np.asarray(mic, "<i2").tobytes()
        if play is not None:
            payload += np.asarray(play, "<i2").tobytes()
        _send_frame(self.sock, T_FEED, self.handle, payload)

    def read_pkg(self, timeout: Optional[float] = 10.0):
        """Blocking read of one processed package: (pcm int16, origin
        followed by the 8 kHz package; vad int), or None on timeout."""
        self.sock.settimeout(timeout)
        try:
            typ, handle, payload = self._next_frame()
        except socket.timeout:
            return None
        if typ == T_ERR:
            raise RuntimeError(payload.decode())
        if typ != T_PKG or handle != self.handle:
            raise ConnectionError(f"unexpected frame {typ:#x} for stream "
                                  f"{handle:#x}")
        vad = struct.unpack("<i", payload[-4:])[0]
        pcm = np.frombuffer(payload[:-4], np.dtype("<i2"))
        return pcm, vad

    def close(self):
        if self.handle is not None:
            try:
                _send_frame(self.sock, T_CLOSE, self.handle)
            except OSError:
                pass
        self.sock.close()

    def _next_frame(self):
        frame = _recv_frame(self.sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        return frame


def main(argv=None) -> None:
    """``wmix-tpu-torch-stream`` CLI: serve the batched record chain."""
    import argparse
    ap = argparse.ArgumentParser(
        description="wmix_tpu_torch multi-stream record server")
    ap.add_argument("--socket", default="/tmp/wmix_tpu_torch_stream.sock",
                    help="unix socket path, or host:port for TCP")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--freq", type=int, default=16000)
    ap.add_argument("--chunk", type=int, default=1,
                    help="packages per pump step (1 = realtime)")
    ap.add_argument("--stats-every", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the chain: the card, unless the "
                         "CPU is asked for with --device cpu")
    for mod in ("ns", "aec", "agc", "vad"):
        ap.add_argument(f"--no-{mod}", action="store_true",
                        help=f"disable {mod.upper()} in the chain")
    args = ap.parse_args(argv)
    addr = args.socket
    if ":" in addr and not addr.startswith("/"):
        host, port = addr.rsplit(":", 1)
        addr = (host, int(port))
    d = StreamDaemon(addr, capacity=args.capacity, freq=args.freq,
                     chunk_pkgs=args.chunk,
                     ns_enable=not args.no_ns,
                     aec_enable=not args.no_aec,
                     agc_enable=not args.no_agc,
                     vad_enable=not args.no_vad,
                     device=args.device)
    # Before clients are admitted: the first steady package is the fifth
    # tick, and that is where the AEC kernel would otherwise be compiled,
    # seconds of nvcc in the middle of service.  A failed build ends the
    # program here.
    t0 = time.time()
    chain = d.server.chain
    if chain.flags[1] and chain.device.type == "cuda":
        from wmix_tpu_torch import kernels
        print("wmix-tpu-torch-stream: building the AEC kernel...",
              flush=True)
        kernels.load("aec_package")
    d._pump_once()      # first-use costs of a step (allocator, tables)
    print(f"wmix-tpu-torch-stream: warm ({time.time() - t0:.1f}s)",
          flush=True)
    d.start()
    print(f"wmix-tpu-torch-stream: serving {args.capacity} slots @ "
          f"{args.freq} Hz on {args.socket} ({chain.device})", flush=True)
    try:
        while True:
            time.sleep(args.stats_every)
            print(json.dumps(d.stats()), flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        d.stop()
        print(json.dumps(d.stats()), flush=True)


if __name__ == "__main__":
    main()
