"""CLI mirroring srcMsg/wmixMsg.c flags (same option names, same
return-code convention: 0 ok, <0 error, >0 task id for -k).

Run as:  python -m wmix_tpu_torch.service.cli [options] [audioPath]
Daemon:  python -m wmix_tpu_torch.service.daemon
"""
from __future__ import annotations

import sys

from wmix_tpu_torch.service import client


HELP = """Usage: wmix_tpu_torch.cli [option] audioPath

Option:
  -l : queue mode, last position (default)
  -i : queue mode, first position
  -m : mix mode
  -b : interrupt (mutex) mode
  -t interval : loop-play interval seconds [1~255]
  -n repeat : repeat count [1~127]
  -d reduce : background reduce factor [1~15]

  -v volume : play volume 0~10
  -vr volume : record volume 0~10
  -va volumeAgc : record AGC gain, needs -agc 1

  -k id : kill task by id (0 clears the play list)
  -ka : kill all play/record/fifo/rtp

  -r : record wav (default 1ch/16bit/8000Hz/5s)
  -rc chn / -rr freq / -rt time : record geometry overrides

  -rtpr ip port : rtp pcma receive+play (1ch 8000Hz)
  -rtps ip port : rtp pcma record+send (1ch 8000Hz)
  -bind : rtp binds the port locally

  -vad/-aec/-ns/-ns_pa/-agc 0|1 : webrtc module switches
  -rw 0|1 : loopback self-test

  -ctl id type : send control (1 CLEAR, 2 STOP, 3 RESET, 4 SILENCE)

  -log 0|1 / -reset / -list / -info
  -note wavPath : tap the mix bus to wav (0 stops)
"""


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-?", "--help"):
        print(HELP)
        return 0

    order = 0
    interval = 0
    repeat = 0
    reduce = 0
    rec_chn, rec_freq, rec_time = 1, 8000, 5
    bind = False
    audio = None
    record_mode = False
    record_type = 0

    i = 0
    n = len(args)

    def arg(k=1):
        nonlocal i
        i += k
        return args[i]

    while i < n:
        a = args[i]
        if a == "-l":
            order = 0
        elif a == "-i":
            order = 1
        elif a == "-m":
            order = 2
        elif a == "-b":
            order = -1
        elif a == "-t":
            interval = int(arg())
        elif a == "-n":
            repeat = int(arg())
        elif a == "-d":
            reduce = int(arg())
        elif a == "-v":
            client.set_volume(int(arg()))
            return 0
        elif a == "-vr":
            client.set_volume_mic(int(arg()))
            return 0
        elif a == "-va":
            client.set_volume_agc(int(arg()))
            return 0
        elif a == "-k":
            return client.play_kill(int(arg()))
        elif a == "-ka":
            client.kill_all()
            return 0
        elif a == "-r":
            record_mode = True
        elif a == "-raac":
            record_mode = True
            record_type = 1
        elif a == "-rc":
            rec_chn = int(arg())
        elif a == "-rr":
            rec_freq = int(arg())
        elif a == "-rt":
            rec_time = int(arg())
        elif a == "-rtpr":
            ip = arg()
            port = int(arg())
            return client.rtp(ip, port, 1, 8000, send_mode=False,
                              bind_mode=bind, reduce=reduce)
        elif a == "-rtps":
            ip = arg()
            port = int(arg())
            return client.rtp(ip, port, 1, 8000, send_mode=True,
                              bind_mode=bind)
        elif a == "-rtpr-aac":
            ip = arg()
            port = int(arg())
            return client.rtp(ip, port, rec_chn, rec_freq,
                              send_mode=False, bind_mode=bind,
                              aac=True, reduce=reduce)
        elif a == "-rtps-aac":
            ip = arg()
            port = int(arg())
            return client.rtp(ip, port, rec_chn, rec_freq,
                              send_mode=True, bind_mode=bind, aac=True)
        elif a == "-tm" or a == "-tm2":
            # wmix_mem_test (wmixMsg.c:110-139): 5 s from the shm rings
            import numpy as np
            from wmix_tpu_torch.service.mem import MemReader
            from wmix_tpu_torch.service import sysv as _sysv
            origin = a == "-tm2"
            client.mem_switch(True)
            rd = MemReader(_sysv.MEM_AI_ORIGIN_CHAR if origin
                           else _sysv.MEM_AI_1X8000_CHAR)
            out = open("./tm2.pcm" if origin else "./tm.pcm", "wb")
            import time as _t
            end = _t.monotonic() + 5.0
            while _t.monotonic() < end:
                got = rd.read(1600, wait=True, timeout=0.1)
                if got.size:
                    out.write(got.tobytes())
            out.close()
            client.mem_switch(False)
            return 0
        elif a == "-tfi" or a == "-tfi2":
            # wmix_fifo_test (wmixMsg.c:140-171): 5 s via the fifo
            aacm = a == "-tfi2"
            import os as _os, time as _t
            path = f"/tmp/wmix_tfi_{_os.getpid()}"
            client.fifo_record(path, rec_chn, rec_freq,
                               type=1 if aacm else 0)
            for _ in range(100):
                if _os.path.exists(path):
                    break
                _t.sleep(0.01)
            out = open("./tfi2.aac" if aacm else "./tfi.pcm", "wb")
            try:
                src = open(path, "rb")
            except OSError:
                print("fifo open failed")
                return -1
            end = _t.monotonic() + 5.0
            while _t.monotonic() < end:
                out.write(src.read(4096) or b"")
            src.close()
            out.close()
            return 0
        elif a == "-bind":
            bind = True
        elif a in ("-vad", "-aec", "-ns", "-ns_pa", "-agc"):
            client.webrtc_switch(a[1:], bool(int(arg())))
            return 0
        elif a == "-rw":
            client.rw_test(bool(int(arg())))
            return 0
        elif a == "-ctl":
            tid = int(arg())
            return client.ctrl(tid, int(arg()))
        elif a == "-log":
            client.log_switch(bool(int(arg())))
            return 0
        elif a == "-reset":
            client.reset()
            return 0
        elif a == "-list":
            for tid, note in client.list_tasks():
                print(f"{tid}: {note}")
            return 0
        elif a == "-info":
            client.info()
            return 0
        elif a == "-note":
            p = arg()
            client.note("" if p == "0" else p)
            return 0
        elif a == "-console":
            client.console(arg())
            return 0
        elif a == "-fft":
            p = arg()
            client.fft("" if p == "0" else p)
            return 0
        elif a.startswith("-"):
            print(f"unknown option {a}")
            return -1
        else:
            audio = a
        i += 1

    if record_mode:
        if not audio:
            print("record mode needs a path")
            return -1
        client.record(audio, rec_chn, rec_freq, rec_time,
                      type=record_type)
        return 0
    if audio:
        return client.play(audio, reduce, interval, repeat, order)
    return 0


if __name__ == "__main__":
    sys.exit(main())
