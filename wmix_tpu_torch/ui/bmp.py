"""BMP read/write (ui/bmp.c), byte-exact including its quirks:

- bmp_create pads each row by ``((width*per) % 4) * height`` zero bytes
  (ui/bmp.c:240-252 — the per-row pad gets multiplied by the row count)
  and then writes only ``headSize + width*height*per`` bytes, truncating
  the padded stream (ui/bmp.c:349), so files with non-multiple-of-4 rows
  carry only the leading rows followed by the pad runs;
- bmp_get computes the *standard* pad on read (ui/bmp.c:117-119), so
  the two only round-trip when ``width*per`` is a multiple of 4 (or the
  remainder is 2);
- positive height stores rows bottom-up with per-pixel byte reversal
  (RGB -> BGR); negative height stores rows top-down.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

FILE_HEADER_SIZE = 14
INFO_SIZE = 40


def _header(width: int, height: int, file_size: int, img_size: int
            ) -> bytes:
    head_size = FILE_HEADER_SIZE + INFO_SIZE
    b = bytearray(head_size)
    b[0:2] = b"BM"
    b[2:6] = int(file_size).to_bytes(4, "little")
    b[10:14] = int(head_size).to_bytes(4, "little")
    b[14:18] = int(INFO_SIZE).to_bytes(4, "little")
    b[18:22] = int(width & 0xFFFFFFFF).to_bytes(4, "little")
    b[22:26] = int(height & 0xFFFFFFFF).to_bytes(4, "little")
    b[26:28] = (1).to_bytes(2, "little")
    b[28:30] = (24).to_bytes(2, "little")
    b[34:38] = int(img_size).to_bytes(4, "little")
    return bytes(b)


def create(path: Optional[str], data, width: int, height: int,
           per: int = 3) -> bytes:
    """bmp_create (ui/bmp.c:218-353).  Returns the written bytes; also
    writes `path` when given."""
    if width < 0:
        raise ValueError("width < 0")
    data = np.asarray(data, np.uint8).ravel()
    pad = (width * per) % 4
    if pad == 4:
        pad = 0
    h = -height if height < 0 else height
    pad *= h    # ui/bmp.c:246,251: the row pad is scaled by the height
    img_size = width * h * per
    head_size = FILE_HEADER_SIZE + INFO_SIZE
    file_size = head_size + img_size

    px = data[:img_size].reshape(h, width, per)
    px = px[:, :, ::-1]                   # per-pixel byte reversal (BGR)
    if height >= 0:
        px = px[::-1]                     # bottom-up rows
    rows = px.reshape(h, width * per)
    if pad:
        rows = np.concatenate(
            [rows, np.zeros((h, pad), np.uint8)], axis=1)
    stream = rows.reshape(-1)[:img_size]  # quirky truncation at img_size
    out = _header(width, height, file_size, img_size) + stream.tobytes()
    if path:
        with open(path, "wb") as f:
            f.write(out)
    return out


def create2(order: int, folder: str, data, width: int, height: int,
            per: int = 3) -> Optional[str]:
    """bmp_create2 (ui/bmp.c:365-378): frame series '%04d.bmp'."""
    if (not folder or not len(folder) or width < 1 or height < 1 or
            per < 3):
        return None
    sep = "" if folder.endswith("/") else "/"
    path = f"{folder}{sep}{order:04d}.bmp"
    create(path, data, width, height, per)
    return path


def get(path_or_bytes) -> Tuple[np.ndarray, int, int, int]:
    """bmp_get (ui/bmp.c:53-206): returns (rgb data, width, height, per).
    Height is returned positive; orientation already normalized."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    if len(raw) < FILE_HEADER_SIZE + INFO_SIZE or raw[:2] != b"BM":
        raise ValueError("bmp type err, bfType must be 'BM'")
    offbits = int.from_bytes(raw[10:14], "little")
    if offbits - FILE_HEADER_SIZE < INFO_SIZE:
        raise ValueError("bad bfOffbits")
    info = raw[FILE_HEADER_SIZE:FILE_HEADER_SIZE + INFO_SIZE]
    width = int.from_bytes(info[4:8], "little", signed=True)
    height = int.from_bytes(info[8:12], "little", signed=True)
    bitcount = int.from_bytes(info[14:16], "little")
    per = bitcount // 8 if bitcount >= 8 else 1
    pad = 4 - (width * (bitcount // 8)) % 4       # standard pad on read
    if pad == 4:
        pad = 0
    h = -height if height < 0 else height
    total = width * h * (bitcount // 8)
    stream = np.frombuffer(raw, np.uint8, offset=offbits)
    need = total + pad * h
    if stream.size < need:                  # tolerate truncated files
        stream = np.concatenate(
            [stream, np.zeros(need - stream.size, np.uint8)])
    rows = stream[:need].reshape(h, width * per + pad)[:, :width * per]
    px = rows.reshape(h, width, per)[:, :, ::-1]
    if height > 0:
        px = px[::-1]
    return np.ascontiguousarray(px).reshape(-1), width, h, per
