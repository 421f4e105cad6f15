"""Audio HAL: the 10-function platform contract
(platform/alsa/plat.h:23-36) as a Python protocol, plus the two HALs the
tests and headless deployments use.

The reference compiles exactly one platform in (alsa / hi3516-null /
t31); here the HAL is an injected object, so the daemon core is testable
without hardware and a real backend can be slotted in per deployment.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class Hal:
    """Contract: plat_{ao,ai}_{init,exit}, plat_ao_write, plat_ai_read,
    plat_{ao,ai}_vol_{set,get}."""

    def ao_init(self, chn: int, freq: int):  # -> handle or None
        raise NotImplementedError

    def ao_exit(self, obj) -> None:
        raise NotImplementedError

    def ao_write(self, obj, data: bytes) -> int:
        raise NotImplementedError

    def ao_vol_set(self, obj, vol: int) -> None:
        pass

    def ao_vol_get(self, obj) -> int:
        return 10

    def ai_init(self, chn: int, freq: int):
        raise NotImplementedError

    def ai_exit(self, obj) -> None:
        raise NotImplementedError

    def ai_read(self, obj, size: int) -> bytes:
        raise NotImplementedError

    def ai_vol_set(self, obj, vol: int) -> None:
        pass

    def ai_vol_get(self, obj) -> int:
        return 10


class NullHal(Hal):
    """hi3516-style stub (platform/hi3516/plat.c:7-55): every call
    succeeds and produces silence."""

    def ao_init(self, chn, freq):
        return object()

    def ao_exit(self, obj):
        pass

    def ao_write(self, obj, data):
        return len(data)

    def ai_init(self, chn, freq):
        return object()

    def ai_exit(self, obj):
        pass

    def ai_read(self, obj, size):
        return bytes(size)


class T31Hal(Hal):
    """Ingenic T31 analog (platform/t31/plat.c): the hi3516-style null
    device plus the T31's ×7 volume mapping (vol 0..10 -> device units
    0..70, plat.c:19-26,71-133) and the hardware-AEC geometry
    (AEC_INTERVALMS=0, PLAY_CORRECT=0 — see EngineConfig.t31()).

    Volume semantics reproduced: set clamps >10 to 70 and <1 to 0,
    else vol*7; get returns device_units // 7 (floor), 0 below the
    minimum."""

    VOL_MAX, VOL_DIV, VOL_MIN = 70, 7, 0

    def __init__(self, hw_aec: bool = False):
        # T31_AEC_EN (plat.c:303-309): the IMP SDK's built-in echo
        # canceller on the capture path; modeled as a flag the daemon's
        # chain config reads (hardware AEC means the software AEC stays
        # off and the delay FIFO is degenerate)
        self.hw_aec = hw_aec
        self._ao_vol = 60   # IMP defaults land mid-range
        self._ai_vol = 60

    def _map_set(self, vol: int) -> int:
        if vol > 10:
            return 10 * self.VOL_DIV + self.VOL_MIN
        if vol < 1:
            return 0
        return vol * self.VOL_DIV + self.VOL_MIN

    def _map_get(self, dev: int) -> int:
        if dev < self.VOL_MIN:
            return 0
        return (dev - self.VOL_MIN) // self.VOL_DIV

    def ao_init(self, chn, freq):
        return object()

    def ao_exit(self, obj):
        pass

    def ao_write(self, obj, data):
        return len(data)

    def ao_vol_set(self, obj, vol):
        self._ao_vol = self._map_set(vol)

    def ao_vol_get(self, obj):
        return self._map_get(self._ao_vol)

    def ai_init(self, chn, freq):
        return object()

    def ai_exit(self, obj):
        pass

    def ai_read(self, obj, size):
        return bytes(size)

    def ai_vol_set(self, obj, vol):
        self._ai_vol = self._map_set(vol)

    def ai_vol_get(self, obj):
        return self._map_get(self._ai_vol)


class LoopHal(Hal):
    """Test/headless HAL: ao_write appends to a capture buffer; ai_read
    pulls from a programmable source array (then silence).  Thread-safe;
    `played` exposes everything 'sent to the speaker'."""

    def __init__(self):
        self._lock = threading.Lock()
        self.played = bytearray()
        self._mic = b""
        self._mic_pos = 0
        self.ao_vol = 10
        self.ai_vol = 10

    def feed_mic(self, pcm: bytes) -> None:
        with self._lock:
            self._mic = self._mic[self._mic_pos:] + bytes(pcm)
            self._mic_pos = 0

    def ao_init(self, chn, freq):
        return object()

    def ao_exit(self, obj):
        pass

    def ao_write(self, obj, data):
        with self._lock:
            self.played += bytes(data)
        return len(data)

    def ao_vol_set(self, obj, vol):
        self.ao_vol = vol

    def ao_vol_get(self, obj):
        return self.ao_vol

    def ai_init(self, chn, freq):
        return object()

    def ai_exit(self, obj):
        pass

    def ai_read(self, obj, size):
        with self._lock:
            chunk = self._mic[self._mic_pos:self._mic_pos + size]
            self._mic_pos += len(chunk)
        return bytes(chunk) + bytes(size - len(chunk))

    def ai_vol_set(self, obj, vol):
        self.ai_vol = vol

    def ai_vol_get(self, obj):
        return self.ai_vol
