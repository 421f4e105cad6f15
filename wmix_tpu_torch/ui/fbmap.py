"""Framebuffer blitting (ui/fbmap.c): mmap /dev/fb0 when present, else a
malloc'd RGB buffer of the default 720x480 geometry (ui/fbmap.c:73-78).
Screenshots dump the buffer through the BMP writer."""
from __future__ import annotations

import mmap
import os
from typing import Optional

import numpy as np

from wmix_tpu_torch.ui import bmp

FB_PATH = "/dev/fb0"
DEFAULT_W, DEFAULT_H = 720, 480


class FbMap:
    def __init__(self):
        self.fd = None
        self.mem = None
        self.xres = DEFAULT_W
        self.yres = DEFAULT_H
        self.bpp = 3
        try:
            self.fd = os.open(FB_PATH, os.O_RDWR)
            # without ioctl bindings assume 32bpp double-word pixels,
            # probing the size from the device
            size = os.lseek(self.fd, 0, os.SEEK_END)
            os.lseek(self.fd, 0, os.SEEK_SET)
            self.mem = mmap.mmap(self.fd, size)
            self.bpp = 4
        except OSError:
            if self.fd is not None:
                os.close(self.fd)
                self.fd = None
            self.buf = np.zeros(self.xres * self.yres * self.bpp,
                                np.uint8)

    def output(self, rgb, x_offset: int, y_offset: int, width: int,
               height: int):
        """fb_output (ui/fbmap.c:113-155): RGB blit with clipping."""
        rgb = np.asarray(rgb, np.uint8).reshape(height, width, 3)
        w = min(width, self.xres - x_offset)
        h = min(height, self.yres - y_offset)
        if w <= 0 or h <= 0:
            return
        if self.fd is None:
            view = self.buf.reshape(self.yres, self.xres, self.bpp)
            view[y_offset:y_offset + h, x_offset:x_offset + w, :3] = \
                rgb[:h, :w]
        else:
            frame = np.frombuffer(self.mem, np.uint8).reshape(
                self.yres, self.xres, self.bpp)
            # fb stores BGRX
            frame[y_offset:y_offset + h, x_offset:x_offset + w, 0] = \
                rgb[:h, :w, 2]
            frame[y_offset:y_offset + h, x_offset:x_offset + w, 1] = \
                rgb[:h, :w, 1]
            frame[y_offset:y_offset + h, x_offset:x_offset + w, 2] = \
                rgb[:h, :w, 0]

    def screenshot(self, path: str):
        """fb_screensShot (ui/fbmap.c:160-174)."""
        if self.fd is None:
            data = self.buf.reshape(self.yres, self.xres, self.bpp)[..., :3]
        else:
            frame = np.frombuffer(self.mem, np.uint8).reshape(
                self.yres, self.xres, self.bpp)
            data = frame[..., 2::-1]
        bmp.create(path, np.ascontiguousarray(data).reshape(-1),
                   self.xres, self.yres, 3)

    def release(self):
        if self.mem is not None:
            self.mem.close()
            self.mem = None
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


_fbmap: Optional[FbMap] = None


def fb_init() -> FbMap:
    global _fbmap
    if _fbmap is None:
        _fbmap = FbMap()
    return _fbmap


def fb_output(rgb, x_offset, y_offset, width, height):
    fb_init().output(rgb, x_offset, y_offset, width, height)


def fb_release():
    global _fbmap
    if _fbmap is not None:
        _fbmap.release()
        _fbmap = None
