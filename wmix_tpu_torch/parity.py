"""The port held against `wmix_tpu` over the parity scenes, on the card.

    python -m wmix_tpu_torch.parity [--device cuda] [--seconds N]
        [--configs a,b] [--quick] [--jobs N] [--out PATH]

The counterpart of the repo's `parity.py` (which measures `wmix_tpu`
against the C reference): the same 64 scenes (echo / fartalk / noecho /
silence x echo gains 0.3-0.9, one seed a stream; `make_scene`,
`build_streams`), the same LSB statistics (`error_stats`) and the same
enable flags (`FULL`, `STAGES`), with the port's `RecordChain` driven by
`run_chunk` in chunks of 50 packages (`port_outputs`).

The reference side is stored, not live: `tools/gen_torch_parity_ref.py`
runs the scenes through `wmix_tpu` and through the port on the CPU and
writes `tests/data/torch_parity_ref.json` (`REF_PATH`) with, per
configuration of `CONFIGS`:

  * the `digest` of `wmix_tpu`'s outputs where the port must be bit-equal
    (`int_chain_nsx_aecm`, `full_chain_exact`, `agc_only`, `vad_only`);
  * the `digest` of the port's own CPU outputs for the fast
    configurations (`full_chain`, `ns_only`, `aec_only`), and
    `wmix_tpu`'s fast `full_chain` VAD flags;
  * for `aec_only` and `full_chain` the `digest` of `wmix_tpu`'s plain-JAX
    fast path (WMIX_PALLAS=0), the form the port's fast AEC is held to:
    `wmix_tpu`'s Pallas form on the CPU breaks a tie of the divergence
    test that the plain form, the C reference and the port keep
    (tools/aec_parting.py); and, in `PLAIN_1S_PATH`, the first second of
    its `aec_only` outputs.

This module runs the port on a device (the card by default; it raises
without one) and, per configuration:

  * bit-equal configurations: the device's digests against `wmix_tpu`'s,
    stream by stream and window by window; any mismatch is listed;
  * fast configurations: `error_stats` of the device against the port on
    the CPU in the same process, whether that CPU run reproduces the
    stored CPU digests (torch's CPU kernels may differ by ISA: reported,
    not failed on), for `full_chain` the packages whose VAD flag differs
    from `wmix_tpu`'s, and the CPU half's own numbers
    (`PARITY_torch_cpu.json`, port CPU against `wmix_tpu`) beside them;
  * `aec_only`: the device and the CPU against `wmix_tpu`'s plain-JAX
    fast path, `error_stats` over the first second (`PLAIN_1S_PATH`) and
    the windows whose digests equal its stored ones;
  * the AEC kernel's launches (`kernels.launched("aec_package")`).

A digest is the first 16 hex characters of a SHA-256 over a stream's
int16 bytes: the first second, then each of `error_stats`'s 10 windows.
Outputs are prefix-stable (a scene's first second does not depend on its
length, nor a chain's first packages on later ones), so a shorter run
still compares its first second; its windows are compared only at the
stored length.  The bit-equal configurations are batch-independent (folds
in a fixed order, integer arithmetic), so the first B' <= 64 streams may
be run alone.

The artifact (`PARITY_torch_h100.json` at the repo root by default) has
`parity.py`'s keys and is written after every configuration, so a run
that is cut keeps every configuration it finished.  `--jobs N` runs N
configurations at a time, each in a process of its own: a package is
bound by the host's launches, so processes share one card well.
"""
from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from wmix_tpu_torch import kernels
from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.floatops import mode_env
from wmix_tpu_torch.engine.chain import RecordChain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(REPO, "tests", "data", "torch_parity_ref.json")
# the first second of wmix_tpu's plain-JAX fast aec_only, every stream
PLAIN_1S_PATH = os.path.join(REPO, "tests", "data",
                             "torch_aec_only_plain_1s.npz")
# the port's fast AEC against wmix_tpu's plain-JAX fast path: at most this
# many LSB on every sample (tools/aec_parting.py)
PLAIN_LSB = 1
CPU_ARTIFACT = os.path.join(REPO, "PARITY_torch_cpu.json")
OUT_PATH = os.path.join(REPO, "PARITY_torch_h100.json")

FREQ = 16000
PKG_MS = 20
CHUNK_PKGS = 50
N_WINDOWS = 10


# ------------------------------------------------------------------ scenes

def make_scene(n: int, freq: int, kind: str, seed: int,
               echo_gain: float) -> tuple[np.ndarray, np.ndarray]:
    """(play, mic) int16 streams for one stream slot (parity.py:52-82)."""
    r = np.random.RandomState(seed)
    t = np.arange(n) / freq
    far = (np.sin(2 * np.pi * (300 + 40 * (seed % 7)) * t) * 6000 +
           np.sin(2 * np.pi * (170 + 23 * (seed % 5)) * t) * 3000 *
           (np.sin(2 * np.pi * 1.3 * t + seed) > 0))
    speech = (np.sin(2 * np.pi * (220 + 31 * (seed % 3)) * t) * 4000 *
              (np.sin(2 * np.pi * 0.7 * t + seed * 0.7) > 0.3))
    noise = r.randn(n) * 80
    delay = freq // 100 + (seed % 3) * 16   # ~10 ms echo path
    echo = np.zeros(n)
    echo[delay:] = far[:n - delay] * echo_gain

    if kind == "echo":            # duplex: echo + local speech
        play, mic = far, echo + speech + noise
    elif kind == "fartalk":       # far-end only: pure echo + noise
        play, mic = far, echo + noise
    elif kind == "noecho":        # local speech only, far silent
        play, mic = np.zeros(n), speech + noise
    elif kind == "silence":       # idle room
        play, mic = np.zeros(n), noise
    else:
        raise ValueError(kind)
    clip = lambda x: np.clip(x, -32768, 32767).astype(np.int16)  # noqa: E731
    return clip(play), clip(mic)


def build_streams(batch: int, n: int, freq: int):
    """(plays, mics) int16 [batch, n] and the scene of each stream
    (parity.py:85-97)."""
    kinds = ("echo", "fartalk", "noecho", "silence")
    gains = (0.3, 0.5, 0.7, 0.9)
    plays = np.zeros((batch, n), np.int16)
    mics = np.zeros((batch, n), np.int16)
    meta = []
    for b in range(batch):
        kind = kinds[b % len(kinds)]
        gain = gains[(b // len(kinds)) % len(gains)]
        plays[b], mics[b] = make_scene(n, freq, kind, seed=b,
                                       echo_gain=gain)
        meta.append({"kind": kind, "gain": gain, "seed": b})
    return plays, mics, meta


# ------------------------------------------------------------------ stats

def error_stats(got: np.ndarray, want: np.ndarray, freq: int,
                n_windows: int = N_WINDOWS) -> dict:
    """The LSB distribution of `got` against `want`, [B, n] int16
    (parity.py:203-229)."""
    g = got.astype(np.int64)
    w = want.astype(np.int64)
    err = np.abs(g - w)
    denom = float(np.sqrt(np.mean(g.astype(np.float64) ** 2) *
                          np.mean(w.astype(np.float64) ** 2))) + 1e-9
    corr = float(np.mean(g.astype(np.float64) * w.astype(np.float64))
                 / denom)
    n = err.shape[1]
    wlen = n // n_windows
    win_max = [int(err[:, i * wlen:(i + 1) * wlen].max())
               for i in range(n_windows)]
    flat = err.ravel()
    return {
        "samples": int(flat.size),
        "max_lsb": int(flat.max()),
        "p999_lsb": int(np.percentile(flat, 99.9)),
        "p99_lsb": int(np.percentile(flat, 99)),
        "mean_lsb": round(float(flat.mean()), 5),
        "pct_exact": round(float(np.mean(flat == 0) * 100), 3),
        "pct_within_1lsb": round(float(np.mean(flat <= 1) * 100), 3),
        "pct_within_4lsb": round(float(np.mean(flat <= 4) * 100), 3),
        "corr": round(corr, 6),
        "window_max_lsb": win_max,
        "per_stream_max_lsb": [int(x) for x in err.max(axis=1)],
    }


def digest(out: np.ndarray, freq: int = FREQ,
           n_windows: int = N_WINDOWS) -> list[list[str]]:
    """Per stream of `out` [B, n] int16: the first 16 hex characters of the
    SHA-256 of the int16 bytes of the first second, then of each of
    `error_stats`'s `n_windows` windows."""
    out = np.ascontiguousarray(out, dtype="<i2")
    wlen = out.shape[1] // n_windows
    spans = [(0, freq)] + [(i * wlen, (i + 1) * wlen)
                           for i in range(n_windows)]
    return [[hashlib.sha256(row[a:b].tobytes()).hexdigest()[:16]
             for a, b in spans] for row in out]


def digest_mismatches(got, want, windows: bool) -> list[list]:
    """[stream, window] where two digests differ; window "first_second" or
    the window's index.  The windows count only when `windows` (both runs
    of the stored length)."""
    bad = []
    for b, (g, w) in enumerate(zip(got, want)):
        if g[0] != w[0]:
            bad.append([b, "first_second"])
        if windows:
            bad += [[b, i] for i in range(N_WINDOWS) if g[1 + i] != w[1 + i]]
    return bad


def pack_flags(flags: np.ndarray) -> str:
    """VAD flags [B, n_pkgs] (the VAD's reduce level, 0..4) as text: three
    bit planes, bit-packed along the packages, deflated, base64."""
    flags = np.asarray(flags)
    if flags.min() < 0 or flags.max() > 7:
        raise ValueError("VAD flags outside 0..7")
    planes = (flags.astype(np.uint8)[None] >> np.arange(3)[:, None, None]) & 1
    return base64.b64encode(zlib.compress(
        np.packbits(planes, axis=-1).tobytes(), 9)).decode()


def unpack_flags(text: str, batch: int, n_pkgs: int) -> np.ndarray:
    """`pack_flags`'s inverse: int32 [batch, n_pkgs]."""
    packed = np.frombuffer(zlib.decompress(base64.b64decode(text)),
                           np.uint8).reshape(3, batch, -1)
    planes = np.unpackbits(packed, axis=-1, count=n_pkgs).astype(np.int32)
    return (planes << np.arange(3)[:, None, None]).sum(axis=0).astype(
        np.int32)


def vad_flag_diffs(got: np.ndarray, want: np.ndarray) -> dict:
    """The packages whose VAD flag differs between two runs [B, n_pkgs]:
    in all, per stream and per stream-hour of audio; `episodes` counts
    maximal runs of differing packages (one decision flip and its
    recovery)."""
    d = np.asarray(got) != np.asarray(want)
    per_stream = d.sum(axis=1)
    starts = d & ~np.pad(d, ((0, 0), (1, 0)))[:, :-1]
    hours = d.size * PKG_MS / 3.6e6
    return {
        "packages": int(d.size),
        "stream_hours": round(hours, 6),
        "differing_packages": int(d.sum()),
        "episodes": int(starts.sum()),
        "streams_with_any": int((per_stream > 0).sum()),
        "differing_per_stream_hour": round(float(d.sum()) / hours, 3),
        "episodes_per_stream_hour": round(float(starts.sum()) / hours, 3),
        "per_stream": [int(x) for x in per_stream],
    }


# ------------------------------------------------------------------ chain

FULL = (True, True, True, True)
STAGES = {
    "ns_only": (True, False, False, False),
    "aec_only": (False, True, False, False),
    "agc_only": (False, False, True, False),
    "vad_only": (False, False, False, True),
}

# name -> (enable flags, ns_backend, aec_backend, exact mode, bit-equal to
# wmix_tpu); in the order the card half runs them
CONFIGS = {
    "full_chain": (FULL, "ns", "aec", False, False),
    "int_chain_nsx_aecm": (FULL, "nsx", "aecm", False, True),
    "full_chain_exact": (FULL, "ns", "aec", True, True),
    "ns_only": (STAGES["ns_only"], "ns", "aec", False, False),
    "aec_only": (STAGES["aec_only"], "ns", "aec", False, False),
    "agc_only": (STAGES["agc_only"], "ns", "aec", False, True),
    "vad_only": (STAGES["vad_only"], "ns", "aec", False, True),
}
ZERO_LSB = [nm for nm, c in CONFIGS.items() if c[4]]


def port_outputs(plays, mics, freq, flags, ns_backend="ns",
                 aec_backend="aec", exact=False, device=None):
    """The port's `RecordChain` over [B, n] int16 scenes, driven by
    `run_chunk` in chunks of `CHUNK_PKGS` packages (the counterpart of
    parity.py:174-200).  Returns the int16 outputs [B, n] and the VAD
    flags of every package, int32 [B, n_pkgs]."""
    ns_on, aec_on, agc_on, vad_on = flags
    B, n = mics.shape
    pkg = freq // 1000 * PKG_MS
    n_pkgs = n // pkg
    with mode_env(exact):
        chain = RecordChain(B, freq, ns_enable=ns_on, aec_enable=aec_on,
                            agc_enable=agc_on, vad_enable=vad_on,
                            ns_backend=ns_backend, aec_backend=aec_backend,
                            device=device)
    out = np.zeros_like(mics)
    vflags = np.zeros((B, n_pkgs), np.int32)
    mic_k = np.transpose(
        mics[:, :n_pkgs * pkg].reshape(B, n_pkgs, pkg), (1, 0, 2))
    play_k = np.transpose(
        plays[:, :n_pkgs * pkg].reshape(B, n_pkgs, pkg), (1, 0, 2))
    for i in range(0, n_pkgs, CHUNK_PKGS):
        k = min(CHUNK_PKGS, n_pkgs - i)
        origin, _, vf = chain.run_chunk(np.ascontiguousarray(mic_k[i:i + k]),
                                        np.ascontiguousarray(play_k[i:i + k]))
        out[:, i * pkg:(i + k) * pkg] = np.transpose(
            origin.cpu().numpy(), (1, 0, 2)).reshape(B, k * pkg)
        vflags[:, i:i + k] = vf.cpu().numpy().T
    return out, vflags


def config_outputs(name, plays, mics, device=None):
    """`port_outputs` of the configuration `name` of `CONFIGS`."""
    flags, ns_b, aec_b, exact, _ = CONFIGS[name]
    return port_outputs(plays, mics, FREQ, flags, ns_backend=ns_b,
                        aec_backend=aec_b, exact=exact, device=device)


# ------------------------------------------------------------------ run

def load_json(path):
    """The JSON document at `path`, or None where there is none."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed: {res.stderr.strip()}"


def run_config(name: str, stored: dict, batch: int, seconds: int,
               device=None, cpu_half: dict | None = None,
               threads: int | None = None) -> dict:
    """One configuration of `CONFIGS` on `device` against its stored
    entry of the reference file, over the first `batch` scenes for
    `seconds` seconds.  `threads` sets torch's CPU threads (for a worker
    process)."""
    dev = resolve_device(device)
    if threads:
        torch.set_num_threads(threads)
    zero = CONFIGS[name][4]
    plays, mics, _ = build_streams(batch, seconds * FREQ, FREQ)
    n_pkgs = seconds * FREQ // (FREQ // 1000 * PKG_MS)
    n0 = kernels.launched("aec_package")
    t0 = time.perf_counter()
    got, vflags = config_outputs(name, plays, mics, device=dev)
    wall = time.perf_counter() - t0
    full_length = stored["seconds"] == seconds
    entry = {"seconds": seconds, "batch": batch, "packages": n_pkgs,
             "bit_equal_to_wmix_tpu_expected": zero,
             "kernel_launches": kernels.launched("aec_package") - n0,
             "wall_s": round(wall, 3),
             "pkg_ms": round(wall * 1e3 / n_pkgs, 3),
             "windows_compared": full_length}
    if zero:
        bad = digest_mismatches(digest(got), stored["wmix_tpu_digest"],
                                full_length)
        entry["vs_wmix_tpu"] = {"equal": not bad, "mismatches": len(bad),
                                "first_mismatches": bad[:64]}
        return entry
    if dev.type == "cpu":
        cpu, cpu_flags = got, vflags
    else:
        cpu, cpu_flags = config_outputs(name, plays, mics, device="cpu")
    entry["vs_port_cpu"] = error_stats(got, cpu, FREQ)
    bad = digest_mismatches(digest(cpu), stored["port_cpu_digest"],
                            full_length)
    entry["port_cpu_reproduces_stored_cpu_digests"] = {
        "equal": not bad, "mismatches": len(bad),
        "first_mismatches": bad[:64]}
    if dev.type != "cpu":
        bad = digest_mismatches(digest(got), stored["port_cpu_digest"],
                                full_length)
        entry["device_reproduces_stored_cpu_digests"] = {
            "equal": not bad, "mismatches": len(bad)}
    if name == "aec_only":
        with np.load(PLAIN_1S_PATH) as z:
            plain = z["out"][:batch]
        entry["vs_wmix_tpu_plain_first_second"] = error_stats(
            got[:, :FREQ], plain, FREQ)
        entry["port_cpu_vs_wmix_tpu_plain_first_second"] = error_stats(
            cpu[:, :FREQ], plain, FREQ)
    if "wmix_tpu_plain_digest" in stored:
        n = 1 + N_WINDOWS if full_length else 1
        want = [row[:n] for row in stored["wmix_tpu_plain_digest"][:batch]]
        entry["digests_equal_to_wmix_tpu_plain"] = dict(compared=batch * n, **{
            side: sum(g == w for gr, wr in zip(digest(out), want)
                      for g, w in zip(gr[:n], wr))
            for side, out in (("device", got), ("cpu", cpu))})
    if "wmix_tpu_vad_flags" in stored:
        want = unpack_flags(stored["wmix_tpu_vad_flags"],
                            len(stored["port_cpu_digest"]),
                            stored["seconds"] * 1000 // PKG_MS)
        want = want[:batch, :n_pkgs]
        entry["vad_vs_wmix_tpu"] = vad_flag_diffs(vflags, want)
        entry["port_cpu_vad_vs_wmix_tpu"] = vad_flag_diffs(cpu_flags, want)
        entry["vad_vs_port_cpu"] = vad_flag_diffs(vflags, cpu_flags)
    if cpu_half is not None:
        # the CPU half's own numbers: port CPU against wmix_tpu
        entry["cpu_half_port_cpu_vs_wmix_tpu"] = {
            k: v for k, v in cpu_half.items() if k != "per_stream_max_lsb"}
    return entry


def run(configs=None, batch=64, seconds=None, device=None, jobs=1,
        save=None) -> dict:
    """The card half over `configs` (all of `CONFIGS` by default) and the
    first `batch` scenes, at the stored lengths or at `seconds` for every
    configuration, against `REF_PATH` (and `CPU_ARTIFACT`'s numbers).
    `save` is called with the result after every configuration."""
    dev = resolve_device(device)
    ref = load_json(REF_PATH)
    if ref is None:
        raise FileNotFoundError(f"{REF_PATH}: run "
                                "tools/gen_torch_parity_ref.py first")
    names = list(configs or CONFIGS)
    unknown = [nm for nm in names if nm not in CONFIGS]
    if unknown:
        raise ValueError(f"unknown configurations {unknown}")
    batch = min(batch, len(ref["scenes"]))
    cpu_doc = load_json(CPU_ARTIFACT) or {"configs": {}}
    reduced = []
    if batch < len(ref["scenes"]):
        reduced.append(f"batch {batch} of {len(ref['scenes'])} scenes")
    lengths = {}
    for nm in names:
        lengths[nm] = seconds or ref["configs"][nm]["seconds"]
        if lengths[nm] > ref["configs"][nm]["seconds"]:
            raise ValueError(f"{nm} is stored for "
                             f"{ref['configs'][nm]['seconds']} s only")
        if lengths[nm] < ref["configs"][nm]["seconds"]:
            reduced.append(f"{nm}: {lengths[nm]} s of the stored "
                           f"{ref['configs'][nm]['seconds']} s (first "
                           "second's digests compared, not the windows)")
    result = {
        "metric": "port_lsb_error_vs_wmix_tpu",
        "freq": FREQ,
        "backend": dev.type,
        "device": str(dev),
        "card": card_name() if dev.type == "cuda" else "cpu",
        "reference": "wmix_tpu on the CPU (stored digests and VAD flags, "
                     "tests/data/torch_parity_ref.json); fast "
                     "configurations against the port on the CPU",
        "fast_mode": True,
        "pallas": dev.type == "cuda",
        "batch": batch,
        "seconds": max(lengths.values()),
        "seconds_by_config": lengths,
        "complete": False,
        "expected_configs": names,
        "configs": {},
        "scenes": ref["scenes"][:batch],
        "reduced": reduced,
    }

    def done(name, entry):
        result["configs"][name] = entry
        result["complete"] = set(result["configs"]) >= set(names)
        if save is not None:
            save(result)

    args = {nm: (nm, ref["configs"][nm], batch, lengths[nm], str(dev),
                 cpu_doc["configs"].get(nm)) for nm in names}
    if jobs <= 1:
        for nm in names:
            done(nm, run_config(*args[nm]))
        return result
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    if dev.type == "cuda":
        kernels.load("aec_package")     # built once, before the workers
    threads = max(1, (os.cpu_count() or 1) // jobs)
    with ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {ex.submit(run_config, *args[nm], threads): nm
                for nm in names}
        for f in as_completed(futs):
            done(futs[f], f.result())
    return result


def summary(result: dict) -> dict:
    """One line per configuration: bit-equal or its LSB figures."""
    out = {}
    for nm, e in result["configs"].items():
        if "vs_wmix_tpu" in e:
            out[nm] = {"equal_to_wmix_tpu": e["vs_wmix_tpu"]["equal"]}
        else:
            s = e["vs_port_cpu"]
            out[nm] = {"max_lsb_vs_cpu": s["max_lsb"],
                       "pct_exact_vs_cpu": s["pct_exact"],
                       "cpu_reproduces_stored": e[
                           "port_cpu_reproduces_stored_cpu_digests"]["equal"]}
            if "vad_vs_wmix_tpu" in e:
                out[nm]["vad_differing_per_stream_hour"] = e[
                    "vad_vs_wmix_tpu"]["differing_per_stream_hour"]
        out[nm]["kernel_launches"] = e["kernel_launches"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port against wmix_tpu over the parity scenes")
    ap.add_argument("--device", default="cuda",
                    help="the device the port runs on (default: the card)")
    ap.add_argument("--seconds", type=int, default=None,
                    help="seconds of audio for every configuration "
                         "(default: each configuration's stored length)")
    ap.add_argument("--configs", default=None,
                    help="comma list of configurations (default: all)")
    ap.add_argument("--quick", action="store_true",
                    help="8 scenes, 1 s each")
    ap.add_argument("--jobs", type=int, default=1,
                    help="configurations run at a time, a process each")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    batch, seconds = (8, 1) if args.quick else (64, args.seconds)
    configs = args.configs.split(",") if args.configs else None

    def save(result):
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1)
        os.replace(tmp, args.out)

    result = run(configs, batch, seconds, args.device, args.jobs, save)
    save(result)
    print(json.dumps({"summary": summary(result), "out": args.out}))
    bad = [nm for nm, e in result["configs"].items()
           if "vs_wmix_tpu" in e and not e["vs_wmix_tpu"]["equal"]]
    if bad:
        print(f"parity: not bit-equal to wmix_tpu: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
