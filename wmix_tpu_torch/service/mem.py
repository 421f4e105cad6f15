"""Shared-memory mic fan-out (src/wmixMem.c): two SysV shm rings
publishing record audio — the raw geometry ring ('L') and the mono-8 kHz
ring ('I').  Readers poll the int16 write cursor `w`; writers advance it
one sample at a time with wraparound at 10240."""
from __future__ import annotations

import time

import numpy as np

from wmix_tpu_torch.service import sysv


class MemWriter:
    """Daemon side: wmix_mem_write_1x8000/origin (src/wmixMem.c:121-168)."""

    def __init__(self, flag_char: str):
        self.circle = sysv.shm_attach(flag_char)

    def write(self, dat: np.ndarray) -> int:
        dat = np.asarray(dat, np.int16).ravel()
        w = int(self.circle.w)
        if w < 0 or w >= sysv.MEM_CIRCLE_BUFF_LEN:
            w = 0
        n = dat.size
        buf = self.circle.buff
        for i in range(n):
            buf[w] = int(dat[i])
            w += 1
            if w >= sysv.MEM_CIRCLE_BUFF_LEN:
                w = 0
        self.circle.w = w
        return n


class MemReader:
    """Client side: wmix_mem_read_1x8000/origin (src/wmixMem.c:47-118)."""

    def __init__(self, flag_char: str):
        self.circle = sysv.shm_attach(flag_char)
        self.addr = int(self.circle.w)

    def read(self, n: int, wait: bool = False,
             timeout: float = 2.0) -> np.ndarray:
        out = np.zeros(n, np.int16)
        got = 0
        w = self.addr
        if w < 0 or w >= sysv.MEM_CIRCLE_BUFF_LEN:
            w = int(self.circle.w)
        deadline = time.monotonic() + timeout
        while got < n:
            if w == int(self.circle.w):
                if wait and time.monotonic() < deadline:
                    time.sleep(0.005)
                    continue
                break
            out[got] = self.circle.buff[w]
            w += 1
            if w >= sysv.MEM_CIRCLE_BUFF_LEN:
                w = 0
            got += 1
        self.addr = w
        return out[:got]
