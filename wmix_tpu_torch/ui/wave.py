"""12-channel rolling-waveform oscilloscope (ui/wave.c), byte-exact.

The line rasterizer is the reference's Bresenham variant with its
half-transparent blend quirk: the channel colors are declared `char[3]`,
so 0xFF components are the *signed* value -1 when blended —
``map = (map + rgb_signed) >> 1`` with arithmetic shift, truncated to
uint8 (ui/wave.c:47-110 + WAVE_COLOR, ui/wave.h:10-24)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from wmix_tpu_torch.ui import bmp as bmp_mod
from wmix_tpu_torch.ui import fbmap

WAVE_CHN = 12
WAVE_COLOR = np.array([
    [0xFF, 0x00, 0x00], [0x00, 0xFF, 0x00], [0x00, 0x00, 0xFF],
    [0xFF, 0xFF, 0x00], [0x00, 0xFF, 0xFF], [0xFF, 0x00, 0xFF],
    [0xFF, 0x80, 0x00], [0x00, 0xFF, 0x80], [0x80, 0x00, 0xFF],
    [0x80, 0x40, 0x40], [0x40, 0x80, 0x40], [0x40, 0x40, 0x80],
], np.uint8)
# signed-char view used by the blend (the C passes char*)
_COLOR_SIGNED = WAVE_COLOR.astype(np.int8).astype(np.int32)


def wave_line(x0: int, y0: int, x1: int, y1: int, width: int,
              buf: np.ndarray, rgb_signed) -> None:
    """wave_line (ui/wave.c:47-110)."""
    dx = x1 - x0
    dy = y1 - y0
    xc, yc = x0, y0
    incx = 1 if dx > 0 else (0 if dx == 0 else -1)
    dx = abs(dx)
    incy = 1 if dy > 0 else (0 if dy == 0 else -1)
    dy = abs(dy)
    dist = dx if dx > dy else dy
    xerr = yerr = 0
    for _ in range(dist + 2):       # t = 0..distance+1 inclusive
        off = (yc * width + xc) * 3
        for k in range(3):
            buf[off + k] = ((int(buf[off + k]) + int(rgb_signed[k])) >> 1) \
                & 0xFF
        xerr += dx
        yerr += dy
        if xerr > dist:
            xerr -= dist
            xc += incx
        if yerr > dist:
            yerr -= dist
            yc += incy


class Wave:
    """Wave_Struct + wave_init/load/skip/output (ui/wave.c:12-190)."""

    def __init__(self, x_offset: int, y_offset: int, width: int,
                 height: int):
        self.x_offset = x_offset
        self.y_offset = y_offset
        self.width = width
        self.height = height
        self.height_half = height // 2
        self.output_count = 0
        self.map = np.zeros(width * height * 3, np.uint8)
        self.chn = np.zeros((WAVE_CHN, width), np.int16)

    def load(self, chn: int, value: int):
        if 0 <= chn < WAVE_CHN:
            self.chn[chn, self.output_count] = np.int16(value)

    def skip(self):
        self.output_count += 1
        if self.output_count >= self.width:
            self.chn[:, :-1] = self.chn[:, 1:]
            self.output_count -= 1

    def _render(self) -> np.ndarray:
        self.map[:] = 0
        base = self.height_half * self.width * 3
        self.map[base:base + self.width * 3] = 0xFF
        for i in range(WAVE_CHN):
            ox = oy = 0
            for j in range(self.output_count + 1):
                y = self.height_half - \
                    int(self.chn[i, j]) * self.height_half // 32768
                # NB C integer division truncates toward zero; for the
                # values here (|chn| <= 32767) the quotient sign matches
                # floor for positives; negatives round toward zero:
                v = int(self.chn[i, j]) * self.height_half
                q = -((-v) // 32768) if v < 0 else v // 32768
                y = self.height_half - q
                y = 0 if y < 0 else (self.height - 1 if y >= self.height
                                     else y)
                wave_line(ox, oy, j, y, self.width, self.map,
                          _COLOR_SIGNED[i])
                ox, oy = j, y
        return self.map

    def output(self):
        """wave_output: render to the framebuffer."""
        self._render()
        fbmap.fb_output(self.map, self.x_offset, self.y_offset,
                        self.width, self.height)
        self.skip()

    def output2(self, bmp_path: str):
        """wave_output2: render to a BMP file."""
        self._render()
        bmp_mod.create(bmp_path, self.map, self.width, self.height, 3)
        self.skip()
