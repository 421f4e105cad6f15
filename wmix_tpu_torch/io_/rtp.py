"""RTP packetization + nonblocking UDP transport (src/rtp.{h,c}).

Wire-format notes (matching the C struct layout on little-endian):
  byte 0: cc(4 LSBs) | x<<4 | p<<5 | v<<6
  byte 1: pt(7 LSBs) | m<<7
  bytes 2-3 seq, 4-7 timestamp, 8-11 ssrc — big-endian on the wire
AAC payloads get the 4-byte AU header 00 10 <size>>5> <(size&0x1F)<<3>
(src/rtp.c:45-51); `send` auto-increments seq afterwards (src/rtp.c:67).
`recv` leaves header fields in network order in the returned header,
exactly like the C code (which never ntoh's on receive) — accessors
below give host-order values.
"""
from __future__ import annotations

import os
import socket
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

RTP_VERSION = 2
RTP_HEADER_SIZE = 12
RTP_PCMA_PKT_SIZE = 160
RTP_MAX_PAYLOAD = 4096

# RTP_AUDIO_TYPE (src/rtp.h:19-30)
PT_PCMU = 0
PT_GSM = 3
PT_G723 = 4
PT_PCMA = 8
PT_G722 = 9
PT_G728 = 15
PT_G729 = 18
PT_H264 = 96
PT_AAC = 97

_TYPE_NAMES = {
    PT_AAC: "mpeg4-generic", PT_PCMA: "pcma", PT_PCMU: "pcmu",
    PT_GSM: "gsm", PT_G723: "g723", PT_G722: "g722", PT_G728: "g728",
    PT_G729: "g729",
}

_AAC_FREQ_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4,
                   32000: 5, 24000: 6, 22050: 7, 16000: 8, 12000: 9,
                   11025: 10, 8000: 11, 7350: 12}


@dataclass
class RtpHeader:
    """Host-order header fields (rtp_header, src/rtp.c:19-32)."""
    cc: int = 0
    x: int = 0
    p: int = 0
    v: int = RTP_VERSION
    pt: int = PT_PCMA
    m: int = 0
    seq: int = 0
    timestamp: int = 0
    ssrc: int = 0

    def pack(self) -> bytes:
        b0 = (self.cc & 0xF) | ((self.x & 1) << 4) | ((self.p & 1) << 5) \
            | ((self.v & 3) << 6)
        b1 = (self.pt & 0x7F) | ((self.m & 1) << 7)
        return struct.pack(">BBHII", b0, b1, self.seq & 0xFFFF,
                           self.timestamp & 0xFFFFFFFF,
                           self.ssrc & 0xFFFFFFFF)

    @classmethod
    def unpack(cls, data: bytes) -> "RtpHeader":
        b0, b1, seq, ts, ssrc = struct.unpack(">BBHII", data[:12])
        return cls(cc=b0 & 0xF, x=(b0 >> 4) & 1, p=(b0 >> 5) & 1,
                   v=(b0 >> 6) & 3, pt=b1 & 0x7F, m=(b1 >> 7) & 1,
                   seq=seq, timestamp=ts, ssrc=ssrc)


def aac_au_header(data_size: int) -> bytes:
    """4-byte AU header prepended to AAC payloads (src/rtp.c:45-51)."""
    return bytes((0x00, 0x10, (data_size >> 5) & 0xFF,
                  (data_size & 0x1F) << 3))


def parse_payload_size(pt: int, payload: bytes) -> int:
    """rtp_recv's dataSize logic (src/rtp.c:87-96)."""
    if pt == PT_AAC:
        return ((payload[2] << 5) | (payload[3] >> 3)) if len(payload) >= 4 \
            else 0
    if pt in (PT_PCMA, PT_PCMU):
        return RTP_PCMA_PKT_SIZE
    return 0


class RtpSocket:
    """rtp_socket/send/recv/reconnect (src/rtp.c:101-158): nonblocking
    UDP, optional bind; `send` auto-increments the header sequence."""

    def __init__(self, ip: str, port: int, bind_mode: bool = False):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        self.addr = (ip, port)
        self.bind_mode = bind_mode
        if bind_mode:
            self.sock.bind(self.addr)
        self.header = RtpHeader()

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def reconnect(self, ip: str, port: int, bind_mode: bool = False):
        self.close()
        self.__init__(ip, port, bind_mode)

    def send(self, payload: bytes) -> int:
        """rtp_send: AAC payloads get the AU header; seq increments after
        the send (src/rtp.c:34-70)."""
        if self.header.pt == PT_AAC:
            payload = aac_au_header(len(payload)) + payload
        pkt = self.header.pack() + payload
        # receiver learned from the last recv in bind mode (the reference
        # reuses ss->addr, which recvfrom overwrote)
        try:
            n = self.sock.sendto(pkt, self.addr)
        except BlockingIOError:
            n = -1
        self.header.seq = (self.header.seq + 1) & 0xFFFF
        return n

    def recv(self) -> Optional[Tuple[RtpHeader, bytes, int]]:
        """rtp_recv: returns (header, raw_payload, data_size) or None when
        no datagram is pending.  For AAC, raw_payload still carries the
        4-byte AU header (the C caller skips it) and data_size is the AU
        length; for PCMA/PCMU data_size is the fixed 160."""
        try:
            pkt, addr = self.sock.recvfrom(RTP_HEADER_SIZE + RTP_MAX_PAYLOAD)
        except BlockingIOError:
            return None
        if len(pkt) < RTP_HEADER_SIZE:
            return None
        self.addr = addr  # mirrors recvfrom updating ss->addr
        hdr = RtpHeader.unpack(pkt)
        payload = pkt[RTP_HEADER_SIZE:]
        return hdr, payload, parse_payload_size(hdr.pt, payload)


def create_sdp(path: str, ip: str, port: int, chn: int, freq: int,
               pt: int = PT_AAC) -> str:
    """rtp_create_sdp (src/rtp.c:160-236), including the quirky 'decimal
    print of hex nibbles' config encoding for mpeg4-generic."""
    type_name = _TYPE_NAMES.get(pt, "mpeg4-generic")
    _freq = _AAC_FREQ_INDEX.get(freq, 8)
    config = 0x1
    config = (config << 5) | _freq
    config = (config << 4) | chn
    config <<= 3
    config = (((config >> 12) & 0xF) * 1000 + ((config >> 8) & 0xF) * 100 +
              ((config >> 4) & 0xF) * 10 + (config & 0xF))
    text = ("m=audio %d RTP/AVP %d\n"
            "a=rtpmap:%d %s/%d/%d\n"
            "a=fmtp:%d sizeLength=13;config=%d;\n"
            "c=IN IP4 %s" % (port, pt, pt, type_name, freq, chn, pt,
                             config, ip))
    if path:
        if os.path.exists(path):
            os.remove(path)
        with open(path, "w") as f:
            f.write(text)
    return text
