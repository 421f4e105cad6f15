"""Canonical 44-byte RIFF/WAVE container, as the reference handles it.

Mirrors src/wav.{h,c}: a fixed header+fmt+chunk layout,
strict magic validation, and the seek-back length fix-up used for
partially-written recordings (WAV_WriteLen, src/wav.c:199-218).
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct

_HDR = struct.Struct("<4sI4s4sIHHIIHH4sI")
HEADER_SIZE = 44


class WavError(ValueError):
    pass


@dataclasses.dataclass
class WavHeader:
    """The parsed fields of the canonical header (WAVContainer_t)."""
    channels: int
    sample_rate: int
    sample_bits: int
    data_bytes: int
    fmt: int = 1            # WAV_FMT_PCM
    riff_length: int = 0    # as stored; data_bytes + 36 when consistent

    @property
    def block_align(self) -> int:
        return self.channels * self.sample_bits // 8

    @property
    def bytes_per_second(self) -> int:
        return self.block_align * self.sample_rate

    @classmethod
    def params(cls, duration_s: int, chn: int, sample: int, freq: int
               ) -> "WavHeader":
        """WAV_Params (src/wav.c:178-196)."""
        data = duration_s * (chn * sample // 8) * freq
        return cls(channels=chn, sample_rate=freq, sample_bits=sample,
                   data_bytes=data, riff_length=data + 36)

    def pack(self) -> bytes:
        """WAV_WriteHeader byte layout (44 bytes)."""
        return _HDR.pack(
            b"RIFF", self.data_bytes + 36, b"WAVE",
            b"fmt ", 16, self.fmt, self.channels, self.sample_rate,
            self.bytes_per_second, self.block_align, self.sample_bits,
            b"data", self.data_bytes)

    @classmethod
    def unpack(cls, data: bytes) -> "WavHeader":
        """WAV_ReadHeader + WAV_P_CheckValid (src/wav.c:60-139): requires
        the canonical RIFF/WAVE/fmt /data layout and PCM format."""
        if len(data) < HEADER_SIZE:
            raise WavError("short wav header")
        (riff, length, wave, fmt_magic, fmt_size, fmt, chn, rate, bps,
         align, bits, data_magic, data_len) = _HDR.unpack(
             data[:HEADER_SIZE])
        if (riff != b"RIFF" or wave != b"WAVE" or fmt_magic != b"fmt " or
                data_magic != b"data"):
            raise WavError("non standard wav file")
        return cls(channels=chn, sample_rate=rate, sample_bits=bits,
                   data_bytes=data_len, fmt=fmt, riff_length=length)


def read(path_or_bytes) -> tuple[WavHeader, bytes]:
    """Read a wav file; returns (header, pcm bytes).  Like the reference's
    players, trusts chunk.length but clips to what is actually present."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    hdr = WavHeader.unpack(blob)
    data = blob[HEADER_SIZE:HEADER_SIZE + hdr.data_bytes]
    return hdr, data


def write(path, pcm: bytes, chn: int, freq: int, sample: int = 16) -> None:
    hdr = WavHeader(channels=chn, sample_rate=freq, sample_bits=sample,
                    data_bytes=len(pcm))
    with open(path, "wb") as f:
        f.write(hdr.pack())
        f.write(pcm)


def write_len(fd_or_file) -> None:
    """WAV_WriteLen (src/wav.c:199-218): patch lengths from the current
    file size; file position is restored to the end."""
    f = fd_or_file
    if isinstance(f, int):
        total = os.lseek(f, 0, os.SEEK_END)
        if total >= HEADER_SIZE:
            os.lseek(f, 4, os.SEEK_SET)
            os.write(f, struct.pack("<I", total - 8))
            os.lseek(f, 40, os.SEEK_SET)
            os.write(f, struct.pack("<I", total - HEADER_SIZE))
            os.lseek(f, 0, os.SEEK_END)
    else:
        f.seek(0, io.SEEK_END)
        total = f.tell()
        if total >= HEADER_SIZE:
            f.seek(4)
            f.write(struct.pack("<I", total - 8))
            f.seek(40)
            f.write(struct.pack("<I", total - HEADER_SIZE))
            f.seek(0, io.SEEK_END)
