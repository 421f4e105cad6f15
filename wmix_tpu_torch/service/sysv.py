"""SysV IPC via libc (ctypes): message queues + shared memory.

The reference's control plane is SysV message queues (src/wmix.c:874-980,
srcMsg/wmix_user.c:104-170) and its mic fan-out is SysV shared memory
(src/wmixMem.c).  Python has no stdlib bindings, so this module wraps the
libc calls directly — keys, permissions, and struct layouts match the C
side bit for bit, which keeps reference-built clients working against
this daemon.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os

_libc = ctypes.CDLL(None, use_errno=True)

IPC_CREAT = 0o1000
IPC_NOWAIT = 0o4000
IPC_RMID = 0

MSG_BUFF_SIZE = 128          # WMIX_MSG_BUFF_SIZE (src/wmixConf.h:26)
MSG_PATH = "/tmp/wmix"       # WMIX_MSG_PATH (src/wmixConf.h:22)
MSG_ID = ord("w")            # WMIX_MSG_ID (src/wmixConf.h:24)


class _MsgBuf(ctypes.Structure):
    _fields_ = [("mtype", ctypes.c_long),
                ("mtext", ctypes.c_uint8 * MSG_BUFF_SIZE)]


def ftok(path: str, proj_id: int) -> int:
    key = _libc.ftok(path.encode(), proj_id)
    if key == -1:
        raise OSError(ctypes.get_errno(), f"ftok({path}, {proj_id})")
    return key


def msgget(key: int, flags: int) -> int:
    fd = _libc.msgget(key, flags)
    if fd == -1:
        raise OSError(ctypes.get_errno(), f"msgget(key={key:#x})")
    return fd


def msgsnd(fd: int, mtype: int, value: bytes, nowait: bool = True) -> None:
    buf = _MsgBuf()
    buf.mtype = mtype
    data = value[:MSG_BUFF_SIZE]
    ctypes.memmove(buf.mtext, data, len(data))
    ret = _libc.msgsnd(fd, ctypes.byref(buf), MSG_BUFF_SIZE,
                       IPC_NOWAIT if nowait else 0)
    if ret == -1:
        raise OSError(ctypes.get_errno(), "msgsnd")


def msgrcv(fd: int, nowait: bool = True):
    """Returns (mtype, value bytes) or None when the queue is empty.
    Raises OSError for EIDRM/EINVAL (queue destroyed — the kill path)."""
    buf = _MsgBuf()
    ret = _libc.msgrcv(fd, ctypes.byref(buf), MSG_BUFF_SIZE, 0,
                       IPC_NOWAIT if nowait else 0)
    if ret == -1:
        e = ctypes.get_errno()
        if e == errno.ENOMSG or e == errno.EAGAIN:
            return None
        raise OSError(e, "msgrcv")
    return buf.mtype, bytes(buf.mtext)


def msgctl_rmid(fd: int) -> None:
    _libc.msgctl(fd, IPC_RMID, None)


def queue_exists(key: int) -> bool:
    return _libc.msgget(key, 0o666) != -1


# ---- shared memory (src/wmixMem.c:19-44) ----

_libc.shmat.restype = ctypes.c_void_p

MEM_CIRCLE_BUFF_LEN = 10240        # WMIX_MEM_CIRCLE_BUFF_LEN
MEM_AI_1X8000_CHAR = "I"
MEM_AI_ORIGIN_CHAR = "L"


class MemCircle(ctypes.Structure):
    """WMix_MemCircle (src/wmixConf.h:92-96)."""
    _fields_ = [("w", ctypes.c_int16),
                ("buff", ctypes.c_int16 * (MEM_CIRCLE_BUFF_LEN + 4))]


def shm_attach(flag_char: str) -> MemCircle:
    """wmix_mem_create(WMIX_MSG_PATH, <char>, sizeof(WMix_MemCircle))."""
    os.makedirs(MSG_PATH, exist_ok=True)
    key = ftok(MSG_PATH, ord(flag_char))
    size = ctypes.sizeof(MemCircle)
    shm_id = _libc.shmget(key, size, 0o666)
    if shm_id == -1:
        shm_id = _libc.shmget(key, size, IPC_CREAT | 0o666)
    if shm_id == -1:
        raise OSError(ctypes.get_errno(), "shmget")
    addr = _libc.shmat(shm_id, None, 0)
    if addr in (None, ctypes.c_void_p(-1).value):
        raise OSError(ctypes.get_errno(), "shmat")
    return MemCircle.from_address(addr)
