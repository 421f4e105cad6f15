"""Client SDK (srcMsg/wmix_user.{h,c}): drives a running daemon through
the SysV message-queue protocol.  Binary-compatible with the reference
daemon and clients — either side can be the C build."""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from wmix_tpu_torch.service import core, sysv
from wmix_tpu_torch.service.mem import MemReader

_auto_id = 0


def _msg_fd() -> int:
    key = sysv.ftok(sysv.MSG_PATH, sysv.MSG_ID)
    return sysv.msgget(key, 0o666)


def _send(mtype: int, value: bytes = b"") -> None:
    sysv.msgsnd(_msg_fd(), mtype, value.ljust(sysv.MSG_BUFF_SIZE, b"\0"))


def auto_path(task_id: int = 0):
    """wmix_auto_path (wmix_user.c:175-191): /tmp/wmix/<id>."""
    global _auto_id
    if task_id > 0:
        ret = task_id
    else:
        ret = (os.getpid() % 1000000) * 1000 + _auto_id
        _auto_id = (_auto_id + 1) & 0xFF
    return f"{sysv.MSG_PATH}/{ret}", ret


def play(audio_file: Optional[str], reduce: int = 0, interval: int = 0,
         repeat: int = 0, order: int = 0) -> int:
    """wmix_play (wmix_user.c:193-245).  order: -1 mutex / 0 last /
    1 first / 2 mix.  Returns the task id."""
    if not audio_file:
        if order < 0:
            play_kill(0)
        return 0
    reduce = min(reduce, 15)
    interval = min(interval, 255)
    repeat = min(repeat, 127)
    msg_path, red_id = auto_path()
    mtype = (reduce << 8) | (interval << 16) | (repeat << 24)
    mtype += {-1: core.WMT_PLAY_MUTEX, 0: core.WMT_PLAY_LAST,
              1: core.WMT_PLAY_FIRST}.get(order, core.WMT_PLAY_MIX) \
        if order in (-1, 0, 1) else core.WMT_PLAY_MIX
    value = audio_file.encode() + b"\0" + msg_path.encode() + b"\0"
    _send(mtype, value)
    return red_id


def play_kill(task_id: int) -> int:
    """wmix_play_kill (wmix_user.c:247-295): 0 clears the list; else
    destroys the task's queue and waits for it to exit."""
    if task_id == 0:
        _send(core.WMT_CLEAN_LIST)
        return 0
    msg_path, _ = auto_path(task_id)
    if not os.path.exists(msg_path):
        return -1
    try:
        key = sysv.ftok(msg_path, sysv.MSG_ID)
        fd = sysv.msgget(key, 0o666)
        sysv.msgctl_rmid(fd)
    except OSError:
        if os.path.exists(msg_path):
            os.remove(msg_path)
        return -1
    for _ in range(20):
        if not os.path.exists(msg_path):
            break
        time.sleep(0.01)
    if os.path.exists(msg_path):
        os.remove(msg_path)
    return 0


def kill_all() -> None:
    _send(core.WMT_CLEAN_ALL)


def ctrl(task_id: int, ctrl_type: int) -> int:
    """wmix_ctrl (wmix_user.c:798-827): per-task control message."""
    msg_path, _ = auto_path(task_id)
    if not os.path.exists(msg_path):
        return -1
    key = sysv.ftok(msg_path, sysv.MSG_ID)
    fd = sysv.msgget(key, 0o666)
    sysv.msgsnd(fd, ctrl_type, b"\0" * sysv.MSG_BUFF_SIZE)
    return 0


def _geometry_value(chn: int, freq: int) -> bytes:
    return bytes((2 if chn > 1 else 1, 16, (freq >> 8) & 0xFF,
                  freq & 0xFF))


def fifo_play(path: str, chn: int, freq: int, reduce: int = 0) -> int:
    msg_path, red_id = auto_path()
    value = _geometry_value(chn, freq) + path.encode() + b"\0"
    _send(core.WMT_FIFO_PLAY | (reduce << 8), value)
    return red_id


def fifo_record(path: str, chn: int, freq: int, type: int = 0) -> int:
    """wmix_fifo_record (wmix_user.c:403-452): type 0 = raw PCM,
    1 = ADTS AAC, 2 = G.711a."""
    msg_path, red_id = auto_path()
    value = _geometry_value(chn, freq) + path.encode() + b"\0"
    if type == 2:
        mtype = core.WMT_FIFO_G711A
    elif type == 1:
        mtype = core.WMT_FIFO_AAC
    else:
        mtype = core.WMT_FIFO_RECORD
    _send(mtype, value)
    return red_id


def record(wav_path: str, chn: int, freq: int, seconds: int,
           type: int = 0) -> None:
    """wmix_record (wmix_user.c:454-485): type 1 = ADTS AAC file."""
    value = _geometry_value(chn, freq) + \
        bytes(((seconds >> 8) & 0xFF, seconds & 0xFF)) + \
        wav_path.encode() + b"\0"
    _send(core.WMT_RECORD_AAC if type == 1 else core.WMT_RECORD_WAV,
          value)


def rtp(ip: str, port: int, chn: int, freq: int, send_mode: bool,
        bind_mode: bool, aac: bool = False, reduce: int = 0) -> int:
    """_wmix_rtp (wmix_user.c:499-559)."""
    msg_path, red_id = auto_path()
    value = _geometry_value(chn, freq) + bytes((
        (port >> 8) & 0xFF, port & 0xFF, 1 if bind_mode else 0,
        0, 0, 0, 0)) + ip.encode() + b"\0" + msg_path.encode() + b"\0"
    if send_mode:
        mtype = core.WMT_RTP_SEND_AAC if aac else core.WMT_RTP_SEND_PCMA
    else:
        mtype = core.WMT_RTP_RECV_AAC if aac else core.WMT_RTP_RECV_PCMA
    _send(mtype | (reduce << 8), value)
    return red_id


def set_volume(value: int) -> None:
    _send(core.WMT_VOLUME, bytes((min(value, 10),)))


def set_volume_mic(value: int) -> None:
    _send(core.WMT_VOLUME_MIC, bytes((min(value, 10),)))


def set_volume_agc(value: int) -> None:
    _send(core.WMT_VOLUME_AGC, bytes((min(value, 20),)))


def webrtc_switch(module: str, on: bool) -> None:
    """wmix_webrtc_* (wmix_user.c:724-764)."""
    mt = {"vad": core.WMT_WEBRTC_VAD_SW, "aec": core.WMT_WEBRTC_AEC_SW,
          "ns": core.WMT_WEBRTC_NS_SW, "ns_pa": core.WMT_WEBRTC_NS_PA_SW,
          "agc": core.WMT_WEBRTC_AGC_SW}[module]
    _send(mt, bytes((1 if on else 0,)))


def rw_test(on: bool) -> None:
    _send(core.WMT_RW_TEST, bytes((1 if on else 0,)))


def log_switch(on: bool) -> None:
    _send(core.WMT_LOG_SW, bytes((1 if on else 0,)))


def info() -> None:
    _send(core.WMT_INFO)


def reset() -> None:
    _send(core.WMT_RESET)


def note(path: str) -> None:
    """wmix_note (wmix_user.c:879-894): tap the play stream to wav;
    empty path stops."""
    _send(core.WMT_NOTE, (path.encode() + b"\0") if path else b"\0")


def mem_switch(on: bool) -> None:
    _send(core.WMT_MEM_SW, bytes((1 if on else 0,)))


def console(path: str) -> None:
    """wmix_console client call (wmix_user.c:766-796)."""
    _send(core.WMT_CONSOLE, path.encode() + b"\0")


def fft(path: str) -> None:
    """wmix_fft (wmix_user.c:896-908): request the FFT display; the
    reference daemon's handler is a stub, mirrored as such."""
    _send(core.WMT_FFT, (path.encode() + b"\0") if path else b"\0")


def list_tasks() -> list:
    """wmix_list (wmix_user.c:830-876): read /tmp/wmix/<id> notes."""
    out = []
    if not os.path.isdir(sysv.MSG_PATH):
        return out
    for name in sorted(os.listdir(sysv.MSG_PATH)):
        p = os.path.join(sysv.MSG_PATH, name)
        if name.isdigit() and os.path.isfile(p):
            try:
                out.append((int(name), open(p).read()))
            except OSError:
                pass
    return out


def mem_1x8000(n: int, wait: bool = True) -> np.ndarray:
    """wmix_mem_1x8000 (wmix_user.c:631-675): enables the fan-out and
    reads n int16 samples of mono-8 kHz mic audio."""
    mem_switch(True)
    try:
        return MemReader(sysv.MEM_AI_1X8000_CHAR).read(n, wait=wait)
    finally:
        mem_switch(False)


def mem_origin(n: int, wait: bool = True) -> np.ndarray:
    mem_switch(True)
    try:
        return MemReader(sysv.MEM_AI_ORIGIN_CHAR).read(n, wait=wait)
    finally:
        mem_switch(False)
