"""Codec throughput bench of the port: concurrent MP3 and AAC play-task
decodes per card, the transform math batched on the device
(`codecs/mp3_batch.py`, `codecs/aac_batch.py`).  The counterpart of
`codec_bench.py`.

    python -m wmix_tpu_torch.codec_bench [--quick] [--device cpu] [--out PATH]

Two kinds of number, kept apart:
  * `*_device`: the device half alone (MP3 polyphase synthesis,
    `BatchedSynth`; AAC inverse filterbank, `BatchedFilterbank`) on seeded
    arrays; streams = B * audio_s / wall_s;
  * `e2e_host_plus_device`: `Mp3BatchDecoder` and `AacBatchDecoder`, the
    C bitstream front-ends on one host core feeding one batched device
    transform per frame tick.

codec_bench.py decodes the reference checkout's fixtures
(`2x44100.{mp3,aac}`, :30, :94), which this repo does not hold; the
decoders here read the stored streams of tests/data
(`tools/gen_torch_codec_streams.py`: seeded Layer III frames, and AAC-LC
at 44.1 kHz stereo), every stream of the batch the same file, and each
result names the file and the frames it decoded: a stream that ends
before the frames asked for ends the timing there (80 Layer III frames,
61 AAC ticks).

Writes `CODEC_torch_h100.json` at the repo root by default
(`CODEC_torch_cpu.json` with `--device cpu`), with `backend` and `device`
(the card's name and power limit), and prints one JSON line.  The card is
the default; without one it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from wmix_tpu_torch.codecs.aac_batch import AacBatchDecoder, \
    BatchedFilterbank
from wmix_tpu_torch.codecs.mp3_batch import BatchedSynth, Mp3BatchDecoder
from wmix_tpu_torch.device import describe, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP3_FIXTURE = os.path.join("tests", "data", "torch_codec_mp3_l3.mp3")
AAC_FIXTURE = os.path.join("tests", "data", "torch_codec_aac_44k_stereo.aac")
# (synth batch, synth frames, e2e batch, e2e frames): codec_bench.py:163-169
QUICK = (64, 40, 16, 40)
FULL = (512, 80, 128, 120)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read(rel_path: str) -> bytes:
    with open(os.path.join(REPO, rel_path), "rb") as f:
        return f.read()


def bench_synth(batch: int, n_frames: int, device=None) -> dict:
    """Device-side batched synthesis throughput: stereo frames of 36
    slots of seeded Q28 subband samples, given as a host array."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    ns, nch, sr = 36, 2, 44100
    # a host array, copied to the device by every frame call, as
    # codec_bench.py passes it
    sb = rng.randint(-(1 << 28), 1 << 28,
                     size=(batch, 2, ns, 32)).astype(np.int32)
    synth = BatchedSynth(batch, device=dev)
    synth.frame(sb, nch, ns)       # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_frames):
        synth.frame(sb, nch, ns)
    _sync(dev)
    dt = time.perf_counter() - t0
    audio_s = n_frames * (32 * ns) / sr
    return {
        "batch": batch,
        "frames": n_frames,
        "wall_s": round(dt, 3),
        "streams": round(batch * audio_s / dt, 1),
    }


def bench_e2e(batch: int, n_frames: int, device=None) -> dict:
    """End to end: host front-ends + device synthesis, 8 warm ticks."""
    data = _read(MP3_FIXTURE)
    dec = Mp3BatchDecoder(batch, device=device)
    for b in range(batch):
        dec.start(b, data)
    for _ in range(8):       # warm
        dec.tick()
    sr = 44100
    t0 = time.perf_counter()
    done_frames = 0
    for _ in range(n_frames):
        pcm, _done = dec.tick()
        if pcm is None:
            break
        done_frames += 1
    dt = time.perf_counter() - t0
    audio_s = done_frames * 1152 / sr
    return {
        "batch": batch,
        "file": MP3_FIXTURE,
        "frames": done_frames,
        "wall_s": round(dt, 3),
        "streams": round(batch * audio_s / dt, 1),
    }


def bench_aac_fb(batch: int, n_frames: int, device=None) -> dict:
    """Device-side batched AAC inverse filterbank throughput: ONLY_LONG
    frames of seeded spectra, on the device before the timed region, over
    `batch` channel slots."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    fb = BatchedFilterbank(batch, device=dev)
    spec = torch.from_numpy((rng.randn(batch, 1024) * 50)
                            .astype(np.float32)).to(dev)
    idx = np.arange(batch, dtype=np.int32)
    fb.frame_stacked(idx, 0, 0, spec)     # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_frames):
        fb.frame_stacked(idx, 0, 0, spec)
    _sync(dev)
    dt = time.perf_counter() - t0
    sr = 44100
    audio_s = n_frames * 1024 / sr
    return {
        "batch": batch,
        "frames": n_frames,
        "wall_s": round(dt, 3),
        "streams": round(batch * audio_s / dt, 1),
    }


def bench_aac_e2e(batch: int, n_frames: int, device=None) -> dict:
    """End to end: host front-ends + device filterbank, 30 warm ticks."""
    data = _read(AAC_FIXTURE)
    dec = AacBatchDecoder(batch, device=device)
    for b in range(batch):
        dec.start(b, data)
    for _ in range(30):
        dec.tick()
    sr = 44100
    t0 = time.perf_counter()
    done_frames = 0
    for _ in range(n_frames):
        pcms, _done = dec.tick()
        if not pcms:
            break
        done_frames += 1
    dt = time.perf_counter() - t0
    audio_s = done_frames * 1024 / sr
    return {
        "batch": batch,
        "file": AAC_FIXTURE,
        "frames": done_frames,
        "wall_s": round(dt, 3),
        "streams": round(batch * audio_s / dt, 1),
    }


def run(quick: bool, device=None) -> dict:
    """codec_bench.py's result object (:171-192), with `device`."""
    dev = resolve_device(device)
    synth_b, synth_f, e2e_b, e2e_f = QUICK if quick else FULL
    return {
        "metric": "concurrent_codec_decode_streams_per_chip",
        "backend": dev.type,
        "device": describe(dev),
        "mp3": {
            "synth_device": bench_synth(synth_b, synth_f, dev),
            "e2e_host_plus_device": bench_e2e(e2e_b, e2e_f, dev),
        },
        "aac": {
            "filterbank_device": bench_aac_fb(synth_b, synth_f, dev),
            "e2e_host_plus_device": bench_aac_e2e(e2e_b, e2e_f, dev),
        },
        "note": ("*_device = the batched transform math alone on the "
                 "device (MP3 polyphase synthesis / AAC IMDCT+filterbank); "
                 "e2e = the native C bitstream front-ends feeding it from "
                 "one core (host parsing is host work by design, "
                 "SURVEY §7.5)"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result = run(args.quick, dev)
    out = args.out or os.path.join(
        REPO, "CODEC_torch_h100.json" if dev.type == "cuda"
        else f"CODEC_torch_{dev.type}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({
        "mp3_synth_streams": result["mp3"]["synth_device"]["streams"],
        "mp3_e2e_streams":
            result["mp3"]["e2e_host_plus_device"]["streams"],
        "aac_fb_streams": result["aac"]["filterbank_device"]["streams"],
        "aac_e2e_streams":
            result["aac"]["e2e_host_plus_device"]["streams"],
        "device": result["device"], "out": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
