"""RTP AAC push/pull test tools (tools/rtpSendAAC.c, rtpRecvAAC.c).

  python -m wmix_tpu_torch.tools.rtp_aac send <file.aac> [bind 0/1] [ip] [port]
  python -m wmix_tpu_torch.tools.rtp_aac recv <out.aac> [bind 0/1] [chn] [freq]
                                         [ip] [port]

send: loops an ADTS file frame by frame, stripping the 7-byte header
(the RTP layer adds the AU header) and pacing by the buffer-fullness
field like the C ((fullness+1)/2 samples per packet,
rtpSendAAC.c:95-105); recv: re-wraps each AU with a synthesized ADTS
header and appends to the output file (rtpRecvAAC.c:64-77).
"""
from __future__ import annotations

import sys
import time

from wmix_tpu_torch.codecs import adts
from wmix_tpu_torch.io_ import rtp

DEFAULT_IP = "127.0.0.1"
DEFAULT_PORT = 9832


def send(path: str, bind: bool, ip: str, port: int):
    data = open(path, "rb").read()
    ss = rtp.RtpSocket(ip, port, bind)
    ss.header = rtp.RtpHeader(pt=rtp.PT_AAC, m=1, ssrc=0x32411)
    wsdp = False
    pos = 0
    while True:
        if pos + 7 > len(data):
            pos = 0
            continue
        info = adts.parse_header(data[pos:pos + 7])
        if info is None:
            pos = 0
            continue
        fullness = ((data[pos + 5] & 0x1F) << 6) | (data[pos + 6] >> 2)
        if not wsdp:
            wsdp = True
            rtp.create_sdp("/tmp/record-aac.sdp", ip, port, info.chn,
                           info.freq, rtp.PT_AAC)
        payload = data[pos + 7:pos + info.frame_len]
        pos += info.frame_len
        if not payload:
            pos = 0
            continue
        n = ss.send(payload)
        if n > 0:
            print(f"send: {ip}:{port} bytes {n}, seq {ss.header.seq}")
        step = (fullness + 1) // 2
        ss.header.timestamp = (ss.header.timestamp + step) & 0xFFFFFFFF
        time.sleep(max(step / info.freq - 0.001, 0))


def recv(path: str, bind: bool, chn: int, freq: int, ip: str, port: int):
    ss = rtp.RtpSocket(ip, port, bind)
    with open(path, "wb") as f:
        while True:
            got = ss.recv()
            if got is not None and got[2] > 0:
                _, payload, size = got
                hdr, _total = adts.create_header(chn, freq, 0x7FF, size)
                f.write(hdr + payload[4:4 + size])
                f.flush()
                print(f"recv: {size} bytes")
                continue
            time.sleep(0.01)


def main(argv):
    if len(argv) < 3 or argv[1] not in ("send", "recv"):
        print(__doc__)
        return 1
    mode, path = argv[1], argv[2]
    bind = len(argv) > 3 and argv[3] != "0"
    if mode == "send":
        ip = argv[4] if len(argv) > 4 else DEFAULT_IP
        port = int(argv[5]) if len(argv) > 5 else DEFAULT_PORT
        send(path, bind, ip, port)
    else:
        chn = int(argv[4]) if len(argv) > 4 else 1
        freq = int(argv[5]) if len(argv) > 5 else 44100
        ip = argv[6] if len(argv) > 6 else DEFAULT_IP
        port = int(argv[7]) if len(argv) > 7 else DEFAULT_PORT
        recv(path, bind, chn, freq, ip, port)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
