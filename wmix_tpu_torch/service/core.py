"""The daemon core: mix ring + play loop + record heartbeat + control
plane (src/wmix.c L2), re-hosted in Python around the bit-exact DSP and
mixer modules of the port.

Port of `wmix_tpu/service/core.py`.  Threading model vs the reference:
the reference runs three permanent detached pthreads (msg dispatcher
:874, play heartbeat :1304, watchdog :2015) plus one pthread per job.
Here the same roles are a msg thread, a play thread (only in realtime
mode — tests drive `pump()` manually, which runs the identical loop
body), and one Python thread per task.  The record path stays a
heartbeat function called once per package from the play loop
(WMIX_RECORD_PLAY_SYNC, src/wmixConf.h:144), keeping play and record
sample-synchronized for the AEC.

The record DSP runs on the daemon's device (`device`, the card unless
the caller asks for the CPU), through single-stream processors over the
port's batched modules at B = 1: `_NsProc`, `_AgcProc` and `_VadProc`
here, `dsp.aec.AecProcessor`, `dsp.nsx.NsxProcessor` and
`dsp.aecm.AecmProcessor`.  A heartbeat copies its mic package (and the
AEC's far-end package) to the device once and the processed package back
once; the stages pass device tensors.  The speex AEC is host numpy, so a
heartbeat that runs it copies around it.  Daemons attached to an
`EngineBridge` run their record chain as a slot of its batch instead.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from wmix_tpu_torch.config import EngineConfig
from wmix_tpu_torch.codecs import wav as wavc
from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp import aec as aec_mod
from wmix_tpu_torch.dsp import agc as agc_mod
from wmix_tpu_torch.dsp import ns as ns_mod
from wmix_tpu_torch.dsp import vad as vad_mod
from wmix_tpu_torch.dsp.floatops import is_exact
from wmix_tpu_torch.ops import mixer, resample
from wmix_tpu_torch.service import sysv
from wmix_tpu_torch.service.hal import Hal, NullHal
from wmix_tpu_torch.service.mem import MemWriter

# WMIX_MSG_TYPE (src/wmixConf.h:29-65)
WMT_VOLUME = 1
WMT_PLAY_MUTEX = 2
WMT_PLAY_MIX = 3
WMT_FIFO_PLAY = 4
WMT_RESET = 5
WMT_FIFO_RECORD = 6
WMT_RECORD_WAV = 7
WMT_CLEAN_LIST = 8
WMT_PLAY_FIRST = 9
WMT_PLAY_LAST = 10
WMT_RTP_SEND_PCMA = 11
WMT_RTP_RECV_PCMA = 12
WMT_RECORD_AAC = 13
WMT_MEM_SW = 14
WMT_WEBRTC_VAD_SW = 15
WMT_WEBRTC_AEC_SW = 16
WMT_WEBRTC_NS_SW = 17
WMT_WEBRTC_NS_PA_SW = 18
WMT_WEBRTC_AGC_SW = 19
WMT_RW_TEST = 20
WMT_VOLUME_MIC = 21
WMT_VOLUME_AGC = 22
WMT_RTP_SEND_AAC = 23
WMT_RTP_RECV_AAC = 24
WMT_CLEAN_ALL = 25
WMT_NOTE = 26
WMT_FFT = 27
WMT_FIFO_AAC = 28
WMT_FIFO_G711A = 29
WMT_LOG_SW = 100
WMT_INFO = 101
WMT_CONSOLE = 102

# webrtcEnable[] indices (src/wmix.h WR_*)
WR_VAD, WR_AEC, WR_NS, WR_NS_PA, WR_AGC = range(5)

VERSION = "wmix-tpu r1 (protocol V6.0 - 20210427)"


class _NsProc:
    """ns_process (src/webrtc.c:612-644) for one stream: `ns.process_pkg`
    at B = 1 on `device`, in the arithmetic mode of the moment it is
    built.  Packages are tensors [1, frames * chn] of int16 values (int32),
    in and out."""

    def __init__(self, chn, freq, device=None):
        self.chn, self.freq = chn, freq
        self.exact = is_exact()
        self.st = ns_mod.init_state(1, freq, device)

    def process(self, pkg: torch.Tensor) -> torch.Tensor:
        self.st, out = ns_mod.process_pkg(self.st, pkg, self.chn, self.freq,
                                          self.exact)
        return out


class _AgcProc:
    """agc_process for one stream: `agc.process_pkg` at B = 1."""

    def __init__(self, chn, freq, gain, device=None):
        self.chn, self.freq, self.gain = chn, freq, gain
        self.st = agc_mod.init_state(1, device)

    def process(self, pkg: torch.Tensor) -> torch.Tensor:
        self.st, out = agc_mod.process_pkg(self.st, pkg, self.chn,
                                           self.freq, self.gain)
        return out


class _VadProc:
    """vad_process (src/webrtc.c:91-151) for one stream: `vad.process` at
    B = 1, the package muted progressively."""

    def __init__(self, chn, freq, interval_ms, device=None):
        self.chn, self.freq, self.interval_ms = chn, freq, interval_ms
        self.st = vad_mod.init_state(1, device)

    def process(self, pkg: torch.Tensor) -> torch.Tensor:
        self.st, out = vad_mod.process(self.st, pkg, self.chn, self.freq,
                                       self.interval_ms)
        return out


def _to_device(pkgs: np.ndarray, device) -> torch.Tensor:
    """Host int16 packages [n, samples] as int32 on `device`: one copy."""
    return torch.from_numpy(pkgs).to(device).to(torch.int32)


def _to_host(pkg: torch.Tensor) -> np.ndarray:
    """A processed package [1, samples] as host int16 [samples]: one
    copy (the int16 cast wraps, as the reference's astype does)."""
    return pkg[0].to(torch.int16).cpu().numpy()


class _Queue:
    """wmix->queue + onPlayCount (play-order arbitration)."""

    def __init__(self):
        self.head = 0
        self.tail = 0
        self.on_play_count = 0


class WmixDaemon:
    """One daemon instance (the reference's single process).  Its record
    DSP runs on `device` (None means the card; without a CUDA device that
    raises, and the CPU is used only when asked for)."""

    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 hal: Optional[Hal] = None, realtime: bool = False,
                 msg_queue: bool = True, shmem: bool = True,
                 debug: bool = False, dsp_bridge=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hal = hal or NullHal()
        self.realtime = realtime
        self.debug = debug
        # batched-engine serving: when set (service/engine_bridge.py),
        # the record DSP chain runs as a slot of a shared device batch
        self.dsp_bridge = dsp_bridge

        R = cfg.buff_size // cfg.frame_size
        self.ring = np.zeros((R, cfg.chn), np.int16)
        self.head_off = 0          # wmix->head as byte offset
        self.tail_off = 0
        self.tick = 0              # wmix->tick (bytes played)

        self.run = True
        self.play_run = False
        self.record_run = False
        self.rw_test = False
        self.shmem_run = 0
        self.reduce_mode = 1
        self.loop_word = 0
        self.loop_word_record = 0
        self.loop_word_fifo = 0
        self.loop_word_rtp = 0
        self.thread_sys = 0
        self.thread_record = 0
        self.thread_play = 0
        self.queue = _Queue()
        self.volume = 10
        self.volume_mic = 10
        self.volume_agc = 5
        self.webrtc_enable = [0, 0, 0, 0, 0]
        self._webrtc = [None, None, None, None, None]
        self.note_path = ""
        self.note_fd = None

        self.obj_ao = self.hal.ao_init(cfg.chn, cfg.freq)
        self.obj_ai = None

        # AEC alignment FIFOs (src/wmix.c:433-526)
        self.fifo_pkgs = cfg.aec_interval_ms // cfg.interval_ms + 2
        self._play_fifo = np.zeros((self.fifo_pkgs, cfg.pkg_size), np.uint8)
        self._play_fifo_count = 0
        self._record_fifo = np.zeros_like(self._play_fifo)
        self._record_fifo_count = 0

        self._rw_head = -1
        self._rw_tick = 0

        self.mem_origin = MemWriter(sysv.MEM_AI_ORIGIN_CHAR) if shmem \
            else None
        self.mem_8k = MemWriter(sysv.MEM_AI_1X8000_CHAR) if shmem else None

        self._msg_fd = None
        self._threads = []
        self._lock = threading.RLock()
        if msg_queue:
            self._msg_setup()

    # ------------------------------------------------------------------
    # control plane (wmix_msg_thread, src/wmix.c:874-1300)
    # ------------------------------------------------------------------

    def _msg_setup(self):
        os.makedirs(sysv.MSG_PATH, exist_ok=True)
        os.chmod(sysv.MSG_PATH, 0o777)
        key = sysv.ftok(sysv.MSG_PATH, sysv.MSG_ID)
        try:
            old = sysv.msgget(key, 0o666)
            sysv.msgctl_rmid(old)
        except OSError:
            pass
        self._msg_fd = sysv.msgget(key, sysv.IPC_CREAT | 0o666)

    def msg_poll(self):
        """One msgrcv + dispatch round (nonblocking)."""
        if self._msg_fd is None:
            return False
        try:
            got = sysv.msgrcv(self._msg_fd)
        except OSError:
            self.run = False
            return False
        if got is None:
            return False
        mtype, value = got
        self.dispatch(mtype, value)
        return True

    def dispatch(self, mtype: int, value: bytes):
        t = mtype & 0xFF
        if t == WMT_VOLUME:
            self.volume = value[0]
            self.hal.ao_vol_set(self.obj_ao, value[0])
        elif t in (WMT_PLAY_MUTEX, WMT_PLAY_MIX, WMT_PLAY_FIRST,
                   WMT_PLAY_LAST):
            if t == WMT_PLAY_MUTEX:
                self.loop_word = (self.loop_word + 1) & 0xFF
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.load_task, mtype, value)
        elif t == WMT_FIFO_PLAY:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.fifo_pcm_play, mtype, value)
        elif t == WMT_RESET:
            self.loop_word = (self.loop_word + 1) & 0xFF
            self.run = False
        elif t == WMT_FIFO_RECORD:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.fifo_pcm_record, mtype, value)
        elif t == WMT_RECORD_WAV:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.record_wav, mtype, value)
        elif t == WMT_CLEAN_LIST:
            self.loop_word = (self.loop_word + 1) & 0xFF
        elif t == WMT_RTP_SEND_PCMA:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.rtp_send_pcma, mtype, value)
        elif t == WMT_RTP_RECV_PCMA:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.rtp_recv_pcma, mtype, value)
        elif t == WMT_MEM_SW:
            if value[0]:
                self.shmem_run += 1
            else:
                self.shmem_run = max(0, self.shmem_run - 1)
        elif t == WMT_WEBRTC_VAD_SW:
            self.webrtc_enable[WR_VAD] = 1 if value[0] else 0
        elif t == WMT_WEBRTC_AEC_SW:
            self.webrtc_enable[WR_AEC] = 1 if value[0] else 0
        elif t == WMT_WEBRTC_NS_SW:
            self.webrtc_enable[WR_NS] = 1 if value[0] else 0
        elif t == WMT_WEBRTC_NS_PA_SW:
            self.webrtc_enable[WR_NS_PA] = 1 if value[0] else 0
        elif t == WMT_WEBRTC_AGC_SW:
            self.webrtc_enable[WR_AGC] = 1 if value[0] else 0
        elif t == WMT_RW_TEST:
            self.rw_test = bool(value[0])
        elif t == WMT_VOLUME_MIC:
            if self.obj_ai:
                self.hal.ai_vol_set(self.obj_ai, value[0])
            self.volume_mic = min(value[0], 10)
        elif t == WMT_VOLUME_AGC:
            if self.webrtc_enable[WR_AGC]:
                self.volume_agc = value[0]
                self._webrtc[WR_AGC] = None   # re-init with new gain
        elif t == WMT_CLEAN_ALL:
            self.loop_word = (self.loop_word + 1) & 0xFF
            self.loop_word_record = (self.loop_word_record + 1) & 0xFF
            self.loop_word_fifo = (self.loop_word_fifo + 1) & 0xFF
            self.loop_word_rtp = (self.loop_word_rtp + 1) & 0xFF
        elif t == WMT_NOTE:
            self._note_ctl(value)
        elif t == WMT_FIFO_G711A:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.fifo_g711a_record, mtype, value)
        elif t == WMT_LOG_SW:
            self.debug = bool(value[0])
        elif t == WMT_INFO:
            print(self.info())
        elif t == WMT_CONSOLE:
            self.console(value.split(b"\0", 1)[0].decode())
        elif t == WMT_FFT:
            # the reference's WMT_FFT handler is a stub: only the "close"
            # path does anything, and even that is a no-op flag clear
            # (src/wmix.c:1124-1137); mirrored as a no-op
            pass
        elif t == WMT_RECORD_AAC:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.record_aac, mtype, value)
        elif t == WMT_FIFO_AAC:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.fifo_aac_record, mtype, value)
        elif t == WMT_RTP_SEND_AAC:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.rtp_send_aac, mtype, value)
        elif t == WMT_RTP_RECV_AAC:
            from wmix_tpu_torch.service import tasks
            self._spawn(tasks.rtp_recv_aac, mtype, value)

    def _note_ctl(self, value: bytes):
        """WMT_NOTE (src/wmix.c:1100-1123): tap the play stream to wav."""
        self.note_path = ""
        if not value[0]:
            return
        path = value.split(b"\0", 1)[0].decode()
        if self.note_fd is not None:
            self.note_fd.close()
            self.note_fd = None
        f = open(path, "wb")
        hdr = wavc.WavHeader.params(10, self.cfg.chn, self.cfg.sample,
                                    self.cfg.freq)
        f.write(hdr.pack())
        f.flush()
        self.note_fd = f
        self.note_path = path

    def console(self, path: str):
        """wmix_console (src/wmix.c:231-266): redirect stdout to a tty
        (truncate mode) or a file (append)."""
        import sys
        if not path:
            return
        if path.startswith("/dev/"):
            if not os.path.exists(path):
                print(f"wmix_console: {path} not exist !!")
                return
            mode = "w"
        else:
            try:
                open(path, "a+").close()
            except OSError:
                print(f"wmix_console: file {path} open faile !!")
                return
            mode = "a+"
        print(f"wmix_console: point to {path}")
        sys.stdout = open(path, mode, buffering=1)

    def info(self) -> str:
        """WMT_INFO text (src/wmix.c:1164-1214)."""
        c = self.cfg
        return (f"---- WMix info -----\n"
                f" chn: {c.chn}\n freq: {c.freq} Hz\n"
                f" sample: {c.sample} bit\n"
                f" volume: play/{self.volume}, mic/{self.volume_mic}, "
                f"agc/{self.volume_agc}\n"
                f" webrtc: vad/{self.webrtc_enable[WR_VAD]}, "
                f"aec/{self.webrtc_enable[WR_AEC]}, "
                f"ns/{self.webrtc_enable[WR_NS]}, "
                f"ns_pa/{self.webrtc_enable[WR_NS_PA]} "
                f"agc/{self.webrtc_enable[WR_AGC]}\n"
                f" playRun: {int(self.play_run)}\n"
                f" recordRun: {int(self.record_run)}\n"
                f" circleBuff: tick/{self.tick}\n"
                f" loopWord: all/{self.loop_word}, "
                f"record/{self.loop_word_record}, "
                f"fifo/{self.loop_word_fifo}, rtp/{self.loop_word_rtp}\n"
                f" thread: sys/{self.thread_sys}, "
                f"record/{self.thread_record}, play/{self.thread_play}\n"
                f" queue: total/{self.queue.on_play_count}, "
                f"head/{self.queue.head}, tail/{self.queue.tail}\n"
                f" shmemRun: {self.shmem_run}\n"
                f" reduceMode: {self.reduce_mode}\n"
                f" note: {self.note_path}\n"
                f" version: {VERSION}\n")

    def _spawn(self, fn, mtype, value):
        th = threading.Thread(target=fn, args=(self, mtype, value),
                              daemon=True)
        th.start()
        self._threads.append(th)

    # ------------------------------------------------------------------
    # mixer (wmix_load_data through ops.mixer)
    # ------------------------------------------------------------------

    def load_data(self, src: bytes, freq: int, chn: int, sample: int,
                  head_off: int, reduce: int, tick: int):
        """Task-facing wmix_load_data; returns (head_off, tick) with the
        reference's 0-as-restart head convention mapped to -1."""
        with self._lock:
            h = -1 if head_off == 0 else head_off
            new_head, new_tick = mixer.load_data(
                self.cfg, self.ring, h, self.head_off, self.tick,
                self.reduce_mode, src, freq, chn, sample, reduce, tick)
            return new_head, new_tick

    # ------------------------------------------------------------------
    # play loop (wmix_play_thread body, src/wmix.c:1304-1516)
    # ------------------------------------------------------------------

    def _drain_pkg(self) -> np.ndarray:
        """Pull one package off the mix ring (clearing it) at head."""
        cfg = self.cfg
        R = self.ring.shape[0]
        f0 = (self.head_off % cfg.buff_size) // cfg.frame_size
        idx = (f0 + np.arange(cfg.frame_num)) % R
        pkg = self.ring[idx].copy()
        self.ring[idx] = 0
        self.head_off = ((f0 + cfg.frame_num) % R) * cfg.frame_size
        self.tick = (self.tick + cfg.pkg_size) & 0xFFFFFFFF
        return pkg.reshape(-1)

    def _play_pkg_add(self, pkg_bytes: bytes):
        self._play_fifo[self._play_fifo_count] = np.frombuffer(
            pkg_bytes, np.uint8)
        self._play_fifo_count = (self._play_fifo_count + 1) % self.fifo_pkgs

    def _play_pkg_get(self, delay_ms: int) -> bytes:
        """playPkgBuff_get (src/wmix.c:487-526), byteCount==0 case."""
        c = self._play_fifo_count
        g = c - delay_ms // self.cfg.interval_ms
        g = min(max(g, 0), self.fifo_pkgs)
        g = c - g
        if g >= self.fifo_pkgs:
            g -= self.fifo_pkgs
        elif g < 0:
            g += self.fifo_pkgs
        return self._play_fifo[g].tobytes()

    def _record_pkg_add(self, pkg_bytes: bytes):
        self._record_fifo[self._record_fifo_count] = np.frombuffer(
            pkg_bytes, np.uint8)
        self._record_fifo_count = (self._record_fifo_count + 1) % \
            self.fifo_pkgs

    def play_tick(self):
        """One play-loop iteration: up to 4 packages + record heartbeat
        per package (the WMIX_RECORD_PLAY_SYNC call sites)."""
        if self.play_run or self.rw_test:
            for _ in range(4):
                with self._lock:
                    pkg = self._drain_pkg()
                buf = pkg.astype(np.int16)
                if self.webrtc_enable[WR_NS_PA] and self.cfg.freq <= 32000:
                    if self._webrtc[WR_NS_PA] is None:
                        self._webrtc[WR_NS_PA] = _NsProc(
                            self.cfg.chn, self.cfg.freq, self.device)
                    buf = _to_host(self._webrtc[WR_NS_PA].process(
                        _to_device(buf[None], self.device)))
                elif not self.webrtc_enable[WR_NS_PA]:
                    self._webrtc[WR_NS_PA] = None
                data = buf.tobytes()
                self._play_pkg_add(data)
                self.hal.ao_write(self.obj_ao, data)
                if self.note_fd is not None and self.note_path:
                    self.note_fd.write(data)
                    self.note_fd.flush()
                elif self.note_fd is not None and not self.note_path:
                    wavc.write_len(self.note_fd)
                    self.note_fd.close()
                    self.note_fd = None
                self.shmem_write_circle()
        else:
            data = bytes(self.cfg.pkg_size)
            self._play_pkg_add(data)
            self.hal.ao_write(self.obj_ao, data)
            self.shmem_write_circle()

    # ------------------------------------------------------------------
    # record heartbeat (wmix_shmem_write_circle, src/wmix.c:528-872)
    # ------------------------------------------------------------------

    def _wr(self, idx, factory):
        if self.webrtc_enable[idx]:
            if self._webrtc[idx] is None:
                self._webrtc[idx] = factory()
            return self._webrtc[idx]
        self._webrtc[idx] = None
        return None

    def shmem_write_circle(self):
        cfg = self.cfg
        if not (self.record_run or self.shmem_run > 0 or self.rw_test):
            self._record_pkg_add(bytes(cfg.pkg_size))
            if self.obj_ai:
                self.hal.ai_exit(self.obj_ai)
                self.obj_ai = None
            for i in (WR_VAD, WR_NS, WR_AEC, WR_AGC):
                self._webrtc[i] = None
            return
        if not self.obj_ai:
            self._record_pkg_add(bytes(cfg.pkg_size))
            self.obj_ai = self.hal.ai_init(cfg.chn, cfg.freq)
            if self.obj_ai:
                self.hal.ai_vol_set(self.obj_ai, self.volume_mic)
                self.hal.ai_read(self.obj_ai, cfg.pkg_size)  # discard one
            return

        raw = self.hal.ai_read(self.obj_ai, cfg.pkg_size)
        if not raw:
            self._record_pkg_add(bytes(cfg.pkg_size))
            return
        self._record_pkg_add(raw)
        buf = np.frombuffer(raw, np.int16).copy()

        if self.dsp_bridge is not None and \
                self.dsp_bridge.accepts(self):
            # batched-engine serving (VERDICT r3 next #8): this daemon's
            # record chain runs as one slot of a shared StreamServer
            # batch; the play package written to the DAC this tick rides
            # along so the server-side chain reproduces the playPkgBuff
            # far-end alignment (src/wmix.c:487-526) per slot.  Outputs
            # return through deliver_record_pkg after the batch step.
            play_pkg = self._play_fifo[
                (self._play_fifo_count - 1) % self.fifo_pkgs]
            self.dsp_bridge.feed(self, buf,
                                 play_pkg.view(np.int16).copy())
            return
        dev = self.device
        if cfg.ns_backend == "nsx":
            # fixed-point NSX alternate (webrtc.c:511-530 with
            # MAKE_WEBRTC_NSX defined; policy NS_AGGRESSIVE=2)
            from wmix_tpu_torch.dsp import nsx as nsx_mod
            ns = self._wr(WR_NS, lambda: nsx_mod.NsxProcessor(
                cfg.chn, cfg.freq, 2, dev)) if cfg.freq <= 32000 else None
        else:
            ns = self._wr(WR_NS, lambda: _NsProc(cfg.chn, cfg.freq, dev)) \
                if cfg.freq <= 32000 else None
        speex = cfg.aec_backend == "speex"
        if speex:
            # MAKE_SPEEX_BETA3 alternate (src/wmix.c:660-676): same far
            # FIFO tap, the speexType wrapper handles the plumbing quirk
            from wmix_tpu_torch.dsp import speex_aec
            aecp = self._wr(WR_AEC, lambda: speex_aec.SpxAecProcessor(
                cfg.chn, cfg.freq, cfg.interval_ms, 0)) \
                if cfg.freq <= 16000 and cfg.freq % 8000 == 0 else None
        elif cfg.aec_backend == "aecm":
            # mobile AEC (src/webrtc.c with MAKE_WEBRTC_AEC undefined:
            # the #undef switch at webrtc.c:172-190 routes aec_* to
            # WebRtcAecm_*); same far FIFO tap and call pattern
            from wmix_tpu_torch.dsp import aecm as aecm_mod
            aecp = self._wr(WR_AEC, lambda: aecm_mod.AecmProcessor(
                cfg.chn, cfg.freq, cfg.interval_ms, dev)) \
                if cfg.freq <= 16000 and cfg.freq % 8000 == 0 else None
        else:
            aecp = self._wr(WR_AEC, lambda: aec_mod.AecProcessor(
                cfg.chn, cfg.freq, cfg.interval_ms, dev)) \
                if cfg.freq <= 16000 else None
        agc = self._wr(WR_AGC, lambda: _AgcProc(cfg.chn, cfg.freq,
                                                self.volume_agc, dev)) \
            if cfg.freq <= 32000 else None
        vad = self._wr(WR_VAD, lambda: _VadProc(cfg.chn, cfg.freq,
                                                cfg.interval_ms, dev)) \
            if cfg.freq <= 32000 else None
        if not (ns or aecp or agc or vad):
            self._record_out(buf)
            return

        # one copy to the device: the mic package, and the far-end
        # package of the play FIFO when the AEC runs
        pkgs = buf[None]
        if aecp:
            far = np.frombuffer(
                self._play_pkg_get(cfg.aec_interval_ms), np.int16)
            pkgs = np.stack([buf, far])
        x = _to_device(pkgs, dev)
        x, far_d = x[:1], x[1:]
        if ns:
            x = ns.process(x)
        if aecp and speex:
            x = _to_device(aecp.process2(far, _to_host(x))[None], dev)
        elif aecp:
            x = aecp.process2(far_d, x, 0)
        if agc:
            x = agc.process(x)
        if vad:
            x = vad.process(x)
        self._record_out(_to_host(x))

    def _record_out(self, buf: np.ndarray) -> None:
        """Record fan-out tail (src/wmix.c:712-737): shm 'L' ring, the
        rw-test loopback, and the zoomed shm 'I' ring."""
        cfg = self.cfg
        if self.mem_origin:
            self.mem_origin.write(buf)

        if self.rw_test:
            self._rw_head, self._rw_tick = self.load_data(
                buf.tobytes(), cfg.freq, cfg.chn, cfg.sample,
                self._rw_head, 1, self._rw_tick)
        else:
            self._rw_head, self._rw_tick = -1, 0

        if self.mem_8k:
            z = resample.pcm_zoom(cfg.chn, cfg.freq, buf.tobytes(), 1, 8000)
            self.mem_8k.write(np.frombuffer(z, np.int16))

    def deliver_record_pkg(self, buf: np.ndarray) -> None:
        """Bridge return path: one processed record package from the
        batched engine (see service/engine_bridge.py)."""
        self._record_out(np.asarray(buf, np.int16))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def pump(self, n_ticks: int = 1):
        """Test/offline mode: run n play-loop iterations + msg polls +
        the playRun/recordRun arbitration (the 10 ms msg-loop tail,
        src/wmix.c:1246-1293, time-compressed)."""
        for _ in range(n_ticks):
            while self.msg_poll():
                pass
            self.play_run = bool(self.thread_play or self.shmem_run or
                                 self.rw_test or self.tick_has_data())
            self.record_run = bool(self.thread_record or self.shmem_run or
                                   self.rw_test)
            self.play_tick()

    def tick_has_data(self) -> bool:
        return bool(np.any(self.ring))

    def start(self):
        """Realtime mode: spawn msg + play threads."""
        self.realtime = True

        def _msg_loop():
            self.thread_sys += 1
            play_timeout = 9999
            record_timeout = 9999
            while self.run:
                if not self.msg_poll():
                    if (self.thread_play == 0 and self.shmem_run == 0
                            and not self.rw_test):
                        if play_timeout < 6000:
                            play_timeout += 10
                            if play_timeout >= 5000:
                                self.play_run = False
                        elif play_timeout != 9999:
                            play_timeout = 9999
                            self.play_run = False
                            with self._lock:
                                self.head_off = self.tail_off = 0
                                self.tick = 0
                                self.ring[:] = 0
                    else:
                        play_timeout = 0
                        self.play_run = True
                    if (self.thread_record == 0 and self.shmem_run == 0
                            and not self.rw_test):
                        if record_timeout < 5000:
                            record_timeout += 10
                        elif record_timeout != 9999:
                            record_timeout = 9999
                            self.record_run = False
                    else:
                        record_timeout = 0
                        self.record_run = True
                    time.sleep(0.01)
            self.thread_sys -= 1

        def _play_loop():
            self.thread_sys += 1
            per_iter = 4 * self.cfg.interval_ms / 1000.0
            while self.run:
                t0 = time.monotonic()
                self.play_tick()
                dt = time.monotonic() - t0
                budget = per_iter if (self.play_run or self.rw_test) \
                    else self.cfg.interval_ms / 1000.0
                if dt < budget:
                    time.sleep((budget - dt) * 0.8)
            self.thread_sys -= 1

        for fn in (_msg_loop, _play_loop):
            th = threading.Thread(target=fn, daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self):
        self.run = False
        self.loop_word = (self.loop_word + 1) & 0xFF
        self.loop_word_record = (self.loop_word_record + 1) & 0xFF
        self.loop_word_fifo = (self.loop_word_fifo + 1) & 0xFF
        self.loop_word_rtp = (self.loop_word_rtp + 1) & 0xFF
        for th in self._threads:
            th.join(timeout=2.0)
        if self._msg_fd is not None:
            sysv.msgctl_rmid(self._msg_fd)
            self._msg_fd = None
        if self.note_fd is not None:
            wavc.write_len(self.note_fd)
            self.note_fd.close()
            self.note_fd = None
