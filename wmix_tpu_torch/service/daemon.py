"""Daemon entry point: `python -m wmix_tpu_torch.service.daemon [options]`
(installed as `wmix-tpu-torch`).

Port of `wmix_tpu/service/daemon.py`.  Mirrors src/wmix.c main (:2064-2183) + wmix_start/main_loop
(:2015-2060): parse the startup argv (initial volumes, initial WebRTC
module switches, console redirect, a boot-time play file), run the
daemon, restart the core if it stops (the watchdog loop).

Startup option table (help(), src/wmix.c:1974-1998 + the parse loop at
:2089-2174):

  -d              debug prints
  -v N            speaker volume 0..10     (wmix_ao_vol_set)
  -vr N           mic volume 0..10         (volumeMic)
  -va N           AGC gain                 (volumeAgc)
  -vad/-aec/-ns/-ns_pa/-agc 0|1   initial webrtcEnable[] switches
  -console PATH   redirect stdout (wmix_console)
  PATH.wav|.mp3|.aac    boot-time play file (wmix_load_task, mtype 3)

plus the rebuild's geometry/backend flags (-c/-f/-t/--hal), covering
what the reference fixes at compile time (wmixConf.h / platform hal
selection in the Makefile), and `--device`, the torch device of the
record DSP: the card unless `--device cpu` asks for the CPU (without a
CUDA device the default raises)."""
from __future__ import annotations

import os
import sys
import time

from wmix_tpu_torch.config import EngineConfig
from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.service.core import (WR_AEC, WR_AGC, WR_NS, WR_NS_PA,
                                   WR_VAD, WmixDaemon)
from wmix_tpu_torch.service.hal import LoopHal, NullHal, T31Hal

_HELP = """usage: daemon [options]
  -c chn  -f freq  -t interval_ms       geometry (wmixConf.h)
  --hal null|loop|alsa|t31              platform backend
  --device cuda|cpu                     record DSP device (default: card)
  -d                                    debug
  -v N / -vr N / -va N                  volumes: speaker / mic / agc
  -vad|-aec|-ns|-ns_pa|-agc 0|1         initial webrtc switches
  -console PATH                         redirect stdout
  FILE.wav|.mp3|.aac                    play at boot"""


def parse_args(args):
    """argv -> settings dict (separated from main for testability)."""
    s = {
        "chn": None, "freq": None, "interval": 20, "debug": False,
        "hal": "null", "volume": -1, "volume_mic": -1, "volume_agc": -1,
        "webrtc": {}, "console": None, "play": None, "help": False,
        "device": None,
    }
    sw = {"-vad": WR_VAD, "-aec": WR_AEC, "-ns": WR_NS,
          "-ns_pa": WR_NS_PA, "-agc": WR_AGC}
    i = 0
    while i < len(args):
        a = args[i]
        nxt = args[i + 1] if i + 1 < len(args) else None
        if a in ("-?", "--help") or "help" in a:
            s["help"] = True
        elif a == "-c" and nxt is not None:
            i += 1
            s["chn"] = int(nxt)
        elif a == "-f" and nxt is not None:
            i += 1
            s["freq"] = int(nxt)
        elif a == "-t" and nxt is not None:
            i += 1
            s["interval"] = int(nxt)
        elif a == "--hal" and nxt is not None:
            i += 1
            s["hal"] = nxt
        elif a == "--device" and nxt is not None:
            i += 1
            s["device"] = nxt
        elif a == "-d":
            s["debug"] = True
        elif a == "-v" and nxt is not None:
            i += 1
            s["volume"] = int(nxt)
        elif a == "-vr" and nxt is not None:
            i += 1
            s["volume_mic"] = int(nxt)
        elif a == "-va" and nxt is not None:
            i += 1
            s["volume_agc"] = int(nxt)
        elif a in sw and nxt is not None:
            # reference semantics: first char '1' enables (wmix.c:2104)
            i += 1
            s["webrtc"][sw[a]] = 1 if nxt[:1] == "1" else 0
        elif a == "-console" and nxt is not None:
            i += 1
            s["console"] = nxt
        elif a.endswith((".wav", ".mp3", ".aac")) or \
                any(ext in a for ext in (".wav", ".mp3", ".aac")):
            s["play"] = a
        i += 1
    return s


def make_config(s) -> EngineConfig:
    if s["hal"] == "t31":
        # t31 geometry defaults (platform/t31/plat.h:10-16): hw AEC,
        # no write-ahead; -c/-f still override chn/freq
        kw = {"interval_ms": s["interval"]}
        if s["chn"] is not None:
            kw["chn"] = s["chn"]
        if s["freq"] is not None:
            kw["freq"] = s["freq"]
        return EngineConfig.t31(**kw)
    return EngineConfig(chn=s["chn"] if s["chn"] is not None else 1,
                        freq=s["freq"] if s["freq"] is not None else 8000,
                        interval_ms=s["interval"])


def make_hal(name: str):
    if name == "alsa":
        # the reference's default platform (platform/alsa/plat.c)
        from wmix_tpu_torch.service.hal_alsa import AlsaHal
        return AlsaHal()
    if name == "t31":
        return T31Hal()
    if name == "loop":
        return LoopHal()
    return NullHal()


def apply_startup(d: WmixDaemon, s) -> None:
    """Apply the parsed startup settings to a (fresh) daemon core —
    the post-wmix_init block of main (src/wmix.c:2148-2174)."""
    d.debug = d.debug or s["debug"]
    if s["console"]:
        d.console(s["console"])
    if s["volume"] >= 0:
        d.volume = s["volume"]
        d.hal.ao_vol_set(d.obj_ao, s["volume"])
    if s["volume_mic"] >= 0:
        if d.obj_ai:
            d.hal.ai_vol_set(d.obj_ai, s["volume_mic"])
        d.volume_mic = min(s["volume_mic"], 10)
    if s["volume_agc"] >= 0:
        d.volume_agc = s["volume_agc"]
    for idx, on in s["webrtc"].items():
        d.webrtc_enable[idx] = on
    if s["play"]:
        from wmix_tpu_torch.service import tasks
        # wmix_load_thread(main_wmix, 3, path, ...) -> wmix_load_task:
        # mtype 3 = background-mix play of the boot file
        d._spawn(tasks.load_task, 3, s["play"].encode() + b"\0")


def main(argv=None) -> int:
    s = parse_args(list(sys.argv[1:] if argv is None else argv))
    if s["help"]:
        print(_HELP)
        return 0

    cfg = make_config(s)
    device = resolve_device(s["device"])
    hal = make_hal(s["hal"])

    # WMIX_TRACE=<logdir>: capture a torch.profiler trace for the daemon
    # lifetime (utils/trace.py)
    trace_ctx = None
    logdir = os.environ.get("WMIX_TRACE")
    if logdir:
        from wmix_tpu_torch.utils.trace import profile
        trace_ctx = profile(logdir)
        trace_ctx.__enter__()

    # watchdog: restart the core when it exits without a SIGINT
    # (main_loop, src/wmix.c:2015-2046)
    first = True
    while True:
        d = WmixDaemon(cfg, hal=hal, realtime=True, debug=s["debug"],
                       device=device)
        apply_startup(d, s if first else
                      {**s, "play": None, "console": None})
        first = False
        print(f"wmix-tpu-torch daemon: chn={cfg.chn} freq={cfg.freq} "
              f"interval={cfg.interval_ms} hal={s['hal']} device={device}")
        d.start()
        try:
            while d.run:
                time.sleep(0.5)
        except KeyboardInterrupt:
            d.stop()
            if trace_ctx is not None:
                trace_ctx.__exit__(None, None, None)
            return 0
        d.stop()
        time.sleep(0.5)


if __name__ == "__main__":
    sys.exit(main())
