"""ALSA audio HAL — the reference's default platform backend
(platform/alsa/plat.c) over libasound via ctypes.

Mirrors the reference's device setup and recovery behavior:

- "default" device, interleaved S16_LE (plat.c:224-278 _plat_init with
  sample=16)
- buffer_time = min(hw max, 500 ms), period_time = buffer_time/4
  (plat.c:82-107 — the 500 ms cap is the reference's Ubuntu guard)
- write/read loops with snd_pcm_recover on error, EPIPE -> prepare,
  EAGAIN/short -> snd_pcm_wait(1000) (plat.c:280-373)
- mixer volume on the first element, capture range 0..10, playback
  range 0..15 with a +5 "base" so daemon volume 1 is audible
  (plat.c:150-212 plat_ao_base)

The HAL degrades gracefully: constructing AlsaHal raises RuntimeError
when libasound is unavailable, so deployments fall back to NullHal /
LoopHal (the daemon picks via --hal, service/daemon.py).
"""
from __future__ import annotations

import ctypes as C
import ctypes.util

SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_ACCESS_RW_INTERLEAVED = 3
SND_PCM_FORMAT_S16_LE = 2
EAGAIN, EPIPE, ESTRPIPE = 11, 32, 86


def _load_asound():
    name = ctypes.util.find_library("asound") or "libasound.so.2"
    try:
        lib = C.CDLL(name)
    except OSError as e:
        raise RuntimeError(f"libasound unavailable: {e}") from e
    lib.snd_pcm_open.argtypes = [C.POINTER(C.c_void_p), C.c_char_p,
                                 C.c_int, C.c_int]
    lib.snd_pcm_hw_params_malloc.argtypes = [C.POINTER(C.c_void_p)]
    lib.snd_pcm_writei.restype = C.c_long
    lib.snd_pcm_writei.argtypes = [C.c_void_p, C.c_void_p, C.c_ulong]
    lib.snd_pcm_readi.restype = C.c_long
    lib.snd_pcm_readi.argtypes = [C.c_void_p, C.c_void_p, C.c_ulong]
    lib.snd_strerror.restype = C.c_char_p
    return lib


class _Pcm:
    """SNDPCMContainer_t equivalent."""

    def __init__(self, lib, chn: int, freq: int, capture: bool):
        self.lib = lib
        self.chn = chn
        self.frame_size = 2 * chn
        self.volume = 10
        self.capture = capture
        handle = C.c_void_p()
        rc = lib.snd_pcm_open(
            C.byref(handle), b"default",
            SND_PCM_STREAM_CAPTURE if capture else SND_PCM_STREAM_PLAYBACK,
            0)
        if rc < 0:
            raise RuntimeError(f"snd_pcm_open: {rc}")
        self.handle = handle
        try:
            self._set_params(freq)
        except Exception:
            lib.snd_pcm_close(handle)
            raise

    def _set_params(self, freq: int):
        lib = self.lib
        hw = C.c_void_p()
        if lib.snd_pcm_hw_params_malloc(C.byref(hw)) < 0:
            raise RuntimeError("hw_params_malloc")
        try:
            if lib.snd_pcm_hw_params_any(self.handle, hw) < 0:
                raise RuntimeError("hw_params_any")
            if lib.snd_pcm_hw_params_set_access(
                    self.handle, hw, SND_PCM_ACCESS_RW_INTERLEAVED) < 0:
                raise RuntimeError("set_access")
            if lib.snd_pcm_hw_params_set_format(
                    self.handle, hw, SND_PCM_FORMAT_S16_LE) < 0:
                raise RuntimeError("set_format S16_LE")
            if lib.snd_pcm_hw_params_set_channels(self.handle, hw,
                                                  self.chn) < 0:
                raise RuntimeError(f"set_channels {self.chn}")
            rate = C.c_uint(freq)
            if lib.snd_pcm_hw_params_set_rate_near(
                    self.handle, hw, C.byref(rate), None) < 0:
                raise RuntimeError("set_rate_near")
            buffer_time = C.c_uint(0)
            lib.snd_pcm_hw_params_get_buffer_time_max(
                hw, C.byref(buffer_time), None)
            if buffer_time.value > 500000:   # plat.c:89 Ubuntu guard
                buffer_time.value = 500000
            period_time = C.c_uint(buffer_time.value // 4)
            lib.snd_pcm_hw_params_set_buffer_time_near(
                self.handle, hw, C.byref(buffer_time), None)
            lib.snd_pcm_hw_params_set_period_time_near(
                self.handle, hw, C.byref(period_time), None)
            if lib.snd_pcm_hw_params(self.handle, hw) < 0:
                raise RuntimeError("hw_params commit")
        finally:
            lib.snd_pcm_hw_params_free(hw)

    def close(self):
        self.lib.snd_pcm_drain(self.handle)
        self.lib.snd_pcm_close(self.handle)

    def _io_loop(self, data: bytes | bytearray, write: bool) -> int:
        """plat_ao_write/plat_ai_read recovery loop (plat.c:280-373)."""
        lib = self.lib
        buf = (C.c_char * len(data)).from_buffer(
            bytearray(data) if write else data)
        frame_num = len(data) // self.frame_size
        off = 0
        result = 0
        while frame_num > 0:
            p = C.cast(C.byref(buf, off * self.frame_size), C.c_void_p)
            ret = (lib.snd_pcm_writei if write else lib.snd_pcm_readi)(
                self.handle, p, frame_num)
            if ret < 0:
                ret = lib.snd_pcm_recover(self.handle, C.c_int(ret), 0)
            if ret == -EAGAIN or (0 <= ret < frame_num):
                lib.snd_pcm_wait(self.handle, 1000)
            elif ret == -EPIPE:
                lib.snd_pcm_prepare(self.handle)
            elif ret == -ESTRPIPE:
                pass
            elif ret < 0:
                # fatal: ai_read unpacks a 2-tuple, so the read path
                # must not return a bare int (ADVICE r2)
                return (-1, b"") if not write else -1
            if frame_num < ret:
                break
            if ret > 0:
                result += ret
                frame_num -= ret
                off += ret
        if not write:
            return result * self.frame_size, bytes(buf)
        return result * self.frame_size

    def set_volume(self, vol: int):
        """Mixer volume on the first element (plat.c:150-212)."""
        lib = self.lib
        self.volume = max(0, min(10, vol))
        mixer = C.c_void_p()
        if lib.snd_mixer_open(C.byref(mixer), 0) < 0:
            return
        try:
            if lib.snd_mixer_attach(mixer, b"default") < 0:
                return
            if lib.snd_mixer_selem_register(mixer, None, None) < 0:
                return
            if lib.snd_mixer_load(mixer) < 0:
                return
            lib.snd_mixer_first_elem.restype = C.c_void_p
            elem = lib.snd_mixer_first_elem(mixer)
            if not elem:
                return
            got = C.c_long(self.volume)
            if self.capture:
                lib.snd_mixer_selem_set_capture_volume_range(
                    C.c_void_p(elem), 0, 10)
                lib.snd_mixer_selem_set_capture_volume_all(
                    C.c_void_p(elem), self.volume)
                lib.snd_mixer_selem_get_capture_volume(
                    C.c_void_p(elem), 0, C.byref(got))
            else:
                base = 5   # plat_ao_base: floor so volume 1 is audible
                lib.snd_mixer_selem_set_playback_volume_range(
                    C.c_void_p(elem), 0, 10 + base)
                lib.snd_mixer_selem_set_playback_volume_all(
                    C.c_void_p(elem),
                    0 if self.volume == 0 else self.volume + base)
                lib.snd_mixer_selem_get_playback_volume(
                    C.c_void_p(elem), 0, C.byref(got))
            self.volume = got.value
            lib.snd_mixer_handle_events(mixer)
        finally:
            lib.snd_mixer_close(mixer)


class AlsaHal:
    """The Hal contract over ALSA.  Raises RuntimeError in __init__ when
    libasound cannot be loaded (headless containers)."""

    def __init__(self):
        self.lib = _load_asound()

    # -- playback --
    def ao_init(self, chn, freq):
        try:
            pcm = _Pcm(self.lib, chn, freq, capture=False)
            pcm.set_volume(10)   # plat.c:255 default volume
            return pcm
        except RuntimeError:
            return None

    def ao_exit(self, obj):
        if obj:
            obj.close()

    def ao_write(self, obj, data):
        return obj._io_loop(bytes(data), write=True)

    def ao_vol_set(self, obj, vol):
        if obj:
            obj.set_volume(vol)

    def ao_vol_get(self, obj):
        return obj.volume if obj else 0

    # -- capture --
    def ai_init(self, chn, freq):
        try:
            pcm = _Pcm(self.lib, chn, freq, capture=True)
            pcm.set_volume(10)
            return pcm
        except RuntimeError:
            return None

    def ai_exit(self, obj):
        if obj:
            obj.close()

    def ai_read(self, obj, size):
        buf = bytearray(size)
        n, data = obj._io_loop(buf, write=False)
        if n < 0:
            return b""
        return data[:size]

    def ai_vol_set(self, obj, vol):
        if obj:
            obj.set_volume(vol)

    def ai_vol_get(self, obj):
        return obj.volume if obj else 0
