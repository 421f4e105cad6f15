"""ADTS (AAC transport) 7-byte header codec + ID3 tag skipping.

Mirrors src/aacType.c:13-102 (AacHeader bitfields, aac_freqList,
aac_createHeader / aac_parseHeader) and src/mp3Type.c:99-131 (id3_len:
ID3v2 syncsafe length and ID3v1 fixed 128)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

AAC_FREQ_LIST = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                 16000, 12000, 11025, 8000, 7350, 0, 0]

ADTS_HEADER_SIZE = 7


def _freq_index(freq: int) -> int:
    """aac_createHeader's cascade (aacType.c:28-52): lowest index whose
    table rate still covers freq."""
    for idx in range(12, 0, -1):
        if freq <= AAC_FREQ_LIST[idx]:
            return idx
    return 0


def create_header(chn: int, freq: int, code_rate: int, dat_len: int
                  ) -> Tuple[bytes, int]:
    """aac_createHeader (aacType.c:15-71): returns (7 bytes, total frame
    length incl. header)."""
    # the C prototype takes uint16_t freq/codeRate/datLen
    # (aacType.h:49-53): 96000 Hz truncates to 30464 and indexes as
    # 32000 — reproduced as-is
    freq &= 0xFFFF
    code_rate &= 0xFFFF
    dat_len &= 0xFFFF
    total = dat_len + 7
    sfi = _freq_index(freq)
    b = bytearray(7)
    b[0] = 0xFF
    # AacHeader (aacType.h:17-46) declares fields bottom-up so GCC's
    # LSB-first bitfield allocation yields standard ADTS on disk:
    # byte 2: protectionAbsent b0 | layer b1-2 | id b3 | syncwordL b4-7
    b[1] = 1 | (0xF << 4)
    # byte 3: chnH b0 | privateBit b1 | samplingFreqIndex b2-5 | profile b6-7
    b[2] = ((chn >> 2) & 1) | (sfi << 2) | (1 << 6)
    # byte 4: frameLenH b0-1 | crStart b2 | crBit b3 | home b4 |
    #         originalCopy b5 | chnL b6-7
    b[3] = ((total >> 11) & 0x3) | ((chn & 0x3) << 6)
    b[4] = (total >> 3) & 0xFF
    # byte 6: bufferFullnessH b0-4 | frameLenL b5-7
    b[5] = ((code_rate >> 6) & 0x1F) | ((total & 0x7) << 5)
    # byte 7: numberOfRawDataBlockInFrame b0-1 | bufferFullnessL b2-7
    b[6] = (code_rate & 0x3F) << 2
    return bytes(b), total


@dataclass
class AdtsInfo:
    chn: int
    freq: int
    frame_len: int
    profile: int
    sfi: int


def parse_header(data: bytes) -> Optional[AdtsInfo]:
    """aac_parseHeader (aacType.c:73-102).  None on bad syncword."""
    if len(data) < 7 or data[0] != 0xFF or ((data[1] >> 4) & 0xF) != 0xF:
        return None
    sfi = (data[2] >> 2) & 0xF
    chn_h = data[2] & 0x1
    chn_l = (data[3] >> 6) & 0x3
    frame_len = ((data[3] & 0x3) << 11) | (data[4] << 3) | \
        ((data[5] >> 5) & 0x7)
    return AdtsInfo(chn=(chn_h << 3) | chn_l, freq=AAC_FREQ_LIST[sfi],
                    frame_len=frame_len, profile=(data[2] >> 6) & 0x3,
                    sfi=sfi)


def id3_len(data_or_path) -> int:
    """id3_len (mp3Type.c:99-131): bytes to skip before the first MPEG
    frame.  Accepts a path or the leading bytes of the file."""
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        buff = bytes(data_or_path[:128])
    else:
        try:
            with open(data_or_path, "rb") as f:
                buff = f.read(128)
        except OSError:
            return 0
    if len(buff) > 9 and buff[:3] == b"ID3":
        return ((buff[6] << 21) | (buff[7] << 14) | (buff[8] << 7) |
                buff[9]) + 10
    if len(buff) > 127 and buff[:3] == b"TAG":
        return 128
    return 0
