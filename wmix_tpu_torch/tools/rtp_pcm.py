"""RTP PCMA push/pull test tools (tools/rtpSendPCM.c, rtpRecvPCM.c).

  python -m wmix_tpu_torch.tools.rtp_pcm send <file.wav|pcm> [bind 0/1] [ip] [port]
  python -m wmix_tpu_torch.tools.rtp_pcm recv <out.wav> [bind 0/1] [ip] [port]

send: loops the file as 20 ms G.711a packets paced at 20 ms (160-sample
timestamp increments, rtpSendPCM.c:95-131); recv: G.711a decode to a
growing mono 8 kHz wav (rtpRecvPCM.c:40-80)."""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from wmix_tpu_torch.codecs import wav as wavc
from wmix_tpu_torch.io_ import rtp
from wmix_tpu_torch.ops import g711

DEFAULT_IP = "127.0.0.1"
DEFAULT_PORT = 9832
SEND_TIMESTAMP = 160
SEND_DELAY = 0.02


def send(path: str, bind: bool, ip: str, port: int):
    data = open(path, "rb").read()
    seek_start = 0
    if data[:4] == b"RIFF":
        seek_start = 44
    ss = rtp.RtpSocket(ip, port, bind)
    ss.header = rtp.RtpHeader(pt=rtp.PT_PCMA, m=1)
    rtp.create_sdp("/tmp/send.sdp", ip, port, 1, 8000, rtp.PT_PCMA)
    pos = seek_start
    t1 = time.monotonic()
    while True:
        chunk = data[pos:pos + SEND_TIMESTAMP * 2]
        pos += len(chunk)
        if len(chunk) < SEND_TIMESTAMP * 2:
            pos = seek_start
            continue
        alaw = g711.np_encode_alaw(np.frombuffer(chunk, np.int16))
        n = ss.send(alaw.astype(np.uint8).tobytes())
        if n > 0:
            print(f"send: {ip}:{port} bytes {n}, seq {ss.header.seq}")
        ss.header.timestamp = (ss.header.timestamp + SEND_TIMESTAMP) \
            & 0xFFFFFFFF
        t2 = time.monotonic()
        dt = t2 - t1
        time.sleep(SEND_DELAY - dt if 0 < dt < SEND_DELAY else 0.001)
        t1 = time.monotonic()


def recv(path: str, bind: bool, ip: str, port: int):
    if os.path.exists(path):
        os.remove(path)
    f = open(path, "wb")
    f.write(wavc.WavHeader.params(5, 1, 16, 8000).pack())
    f.flush()
    ss = rtp.RtpSocket(ip, port, bind)
    try:
        while True:
            got = ss.recv()
            if got is not None and got[2] > 0:
                hdr, payload, size = got
                pcm = g711.np_decode_alaw(
                    np.frombuffer(payload[:size], np.uint8))
                f.write(pcm.astype(np.int16).tobytes())
                f.flush()
                print(f"rtp_recv: {size + 12} / 12 + {size}")
                continue
            time.sleep(0.01)
    except KeyboardInterrupt:
        pass
    finally:
        wavc.write_len(f)
        f.close()


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 2 or args[0] not in ("send", "recv"):
        print(__doc__)
        return -1
    bind = len(args) > 2 and args[2] != "0"
    ip = args[3] if len(args) > 3 else DEFAULT_IP
    port = int(args[4]) if len(args) > 4 else DEFAULT_PORT
    if args[0] == "send":
        send(args[1], bind, ip, port)
    else:
        recv(args[1], bind, ip, port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
