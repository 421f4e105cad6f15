"""The CPU half of the port's parity artifact: `wmix_tpu` and
`wmix_tpu_torch` on the CPU over the 64 scenes of PARITY_r05.

    python tools/gen_torch_parity_ref.py [--jobs N]

runs every configuration of `wmix_tpu_torch.parity.CONFIGS` over the
scenes of `PARITY_r05.json["scenes"]` (64 streams; `build_streams`) for
PARITY_r05's 60 s:

  * through `wmix_tpu`'s `RecordChain` on the CPU under x64, in a process
    of its own per arithmetic mode (`wmix_tpu` reads its mode when it
    traces and keeps the first trace): the fast configurations as
    tools/gen_torch_chain_ref.py's fast case runs them (WMIX_FAST=1,
    WMIX_PALLAS=1: the Pallas package kernel in interpret mode), the
    exact and integer chains with WMIX_EXACT=1 (the configuration tested
    bit-exact against the C reference; the integer chain does not depend
    on the mode).  `run_chunk` in chunks of 50 packages, as parity.py
    drives it, except the integer chain: under x64 the reference widens
    three AECM state leaves to int64 inside its chunk program, which
    `lax.scan` refuses, so it runs `step` package by package;
  * the configurations of `PLAIN` also through `wmix_tpu`'s plain-JAX
    fast path (WMIX_FAST=1, WMIX_PALLAS=0), in a third process: the form
    the port's fast AEC is held to.  `wmix_tpu`'s Pallas package body, as
    XLA compiles it on the CPU, takes the two windowed transforms of
    bit-equal near and error buffers apart in their last bits, which
    breaks the divergence test's tie while the echo filter is empty
    (tools/aec_parting.py);
  * through the port's `RecordChain` on the CPU
    (`wmix_tpu_torch.parity.port_outputs`), `--jobs` configurations at a
    time, a process each;

and writes

  * `PARITY_torch_cpu.json`: parity.py's layout (the port's CPU outputs
    against `wmix_tpu`'s, `error_stats` per configuration), with
    `"backend": "cpu"`, `"reference": "wmix_tpu"` and `reduced`, the cuts
    (none); per configuration also the packages whose VAD flag differs,
    and for `PLAIN` a second block, `vs_wmix_tpu_plain`, against the
    plain-JAX fast path (`reference_modes` names each block's form);
  * `tests/data/torch_parity_ref.json`: the scenes; per configuration its
    length, `wmix_tpu`'s digests where the port must be bit-equal, the
    port's own CPU digests for the fast configurations, `wmix_tpu`'s
    plain-JAX digests for `PLAIN`, and `wmix_tpu`'s fast `full_chain` VAD
    flags (`parity.pack_flags`);
  * `tests/data/torch_aec_only_plain_1s.npz` (`parity.PLAIN_1S_PATH`):
    the first second of `wmix_tpu`'s plain-JAX `aec_only` outputs, every
    stream, which the port is held to within 1 LSB on the CPU
    (tests/test_torch_aec_parting.py) and the card in chip_smoke.py's
    phase 18.

Both chains' outputs are kept under `.parity_cache/` (git-ignored), keyed
by configuration, batch and length, so a second run only assembles.  On
an 8-core machine the whole takes about an hour, most of it the exact
chains of both packages.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wmix_tpu_torch import parity as tp  # noqa: E402

CACHE = os.path.join(REPO, ".parity_cache")
BATCH, SECONDS = 64, 60      # PARITY_r05's streams and length
# the wmix_tpu process each configuration runs in
EXACT_PROCESS = ("int_chain_nsx_aecm", "full_chain_exact")
# configurations also run through wmix_tpu's plain-JAX fast path
PLAIN = ("aec_only", "full_chain")
MODES = {"exact": "x64, WMIX_EXACT=1",
         "pallas": "x64, WMIX_FAST=1, WMIX_PALLAS=1 (interpret mode)",
         "plain": "x64, WMIX_FAST=1, WMIX_PALLAS=0 (plain-JAX fast path)"}
SIDE = {"exact": "wmix_tpu", "pallas": "wmix_tpu", "plain": "wmix_tpu_plain"}


def cache_path(side: str, name: str) -> str:
    return os.path.join(CACHE, f"torch_{side}_{name}_{BATCH}x{SECONDS}s.npz")


def scenes():
    return tp.build_streams(BATCH, SECONDS * tp.FREQ, tp.FREQ)


def _jax_on_cpu(mode: str):
    if mode == "exact":
        os.environ["WMIX_EXACT"] = "1"
        os.environ.pop("WMIX_FAST", None)
    else:
        os.environ["WMIX_FAST"] = "1"
        os.environ["WMIX_PALLAS"] = "1" if mode == "pallas" else "0"
        os.environ.pop("WMIX_EXACT", None)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_allow_excess_precision=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def reference_outputs(name: str):
    """`wmix_tpu`'s int16 outputs [B, n] and VAD flags [B, n_pkgs] of one
    configuration (the mode set by `_jax_on_cpu` beforehand)."""
    from wmix_tpu.engine.chain import RecordChain
    flags, ns_b, aec_b, _exact, _ = tp.CONFIGS[name]
    plays, mics, _ = scenes()
    B, n = mics.shape
    pkg = tp.FREQ // 1000 * tp.PKG_MS
    n_pkgs = n // pkg
    ns_on, aec_on, agc_on, vad_on = flags
    chain = RecordChain(B, tp.FREQ, ns_enable=ns_on, aec_enable=aec_on,
                        agc_enable=agc_on, vad_enable=vad_on,
                        ns_backend=ns_b, aec_backend=aec_b)
    mic_k = np.ascontiguousarray(np.transpose(
        mics.reshape(B, n_pkgs, pkg), (1, 0, 2)))
    play_k = np.ascontiguousarray(np.transpose(
        plays.reshape(B, n_pkgs, pkg), (1, 0, 2)))
    out = np.zeros((n_pkgs, B, pkg), np.int16)
    vflags = np.zeros((n_pkgs, B), np.int32)
    step = name == "int_chain_nsx_aecm"
    chunk = 1 if step else tp.CHUNK_PKGS
    for i in range(0, n_pkgs, chunk):
        k = min(chunk, n_pkgs - i)
        if step:
            o, _, vf = chain.step(mic_k[i], play_k[i])
            out[i], vflags[i] = np.asarray(o), np.asarray(vf)
        else:
            o, _, vf = chain.run_chunk(mic_k[i:i + k], play_k[i:i + k])
            out[i:i + k], vflags[i:i + k] = np.asarray(o), np.asarray(vf)
    return (np.transpose(out, (1, 0, 2)).reshape(B, n),
            np.ascontiguousarray(vflags.T))


def reference_process(names, mode: str) -> None:
    """Run `names` through `wmix_tpu` in one mode of `MODES` and cache."""
    _jax_on_cpu(mode)
    for name in names:
        t0 = time.time()
        out, vflags = reference_outputs(name)
        np.savez_compressed(cache_path(SIDE[mode], name), out=out,
                            vflags=vflags)
        print(f"wmix_tpu ({mode}) {name}: {time.time() - t0:.0f} s",
              flush=True)


def port_process(name: str) -> None:
    """Run one configuration through the port on the CPU and cache."""
    import torch
    torch.set_num_threads(2)
    plays, mics, _ = scenes()
    t0 = time.time()
    out, vflags = tp.config_outputs(name, plays, mics, device="cpu")
    np.savez_compressed(cache_path("port_cpu", name), out=out,
                        vflags=vflags)
    print(f"port cpu {name}: {time.time() - t0:.0f} s", flush=True)


def load(side: str, name: str):
    with np.load(cache_path(side, name)) as z:
        return z["out"], z["vflags"]


def produce(jobs: int) -> None:
    """Fill the cache: the reference processes (one a mode) and `jobs`
    port processes at a time, side by side."""
    os.makedirs(CACHE, exist_ok=True)
    names = list(tp.CONFIGS)
    me = [sys.executable, os.path.abspath(__file__)]
    todo = []
    for mode, group in (
            ("pallas", [nm for nm in names if nm not in EXACT_PROCESS]),
            ("exact", [nm for nm in names if nm in EXACT_PROCESS]),
            ("plain", [nm for nm in names if nm in PLAIN])):
        group = [nm for nm in group
                 if not os.path.exists(cache_path(SIDE[mode], nm))]
        if group:
            todo.append(me + ["--reference", ",".join(group),
                              "--mode", mode])
    todo += [me + ["--port", nm] for nm in names
             if not os.path.exists(cache_path("port_cpu", nm))]
    n_ref = sum("--reference" in cmd for cmd in todo)
    running = []
    while todo or running:
        while todo and len(running) < n_ref + jobs:
            cmd = todo.pop(0)
            print("start:", " ".join(cmd[2:]), flush=True)
            running.append((cmd, subprocess.Popen(cmd)))
        time.sleep(5)
        for cmd, p in list(running):
            if p.poll() is not None:
                running.remove((cmd, p))
                if p.returncode:
                    for _, q in running:
                        q.kill()
                    raise RuntimeError(f"{cmd[2:]} failed: {p.returncode}")


def assemble() -> tuple[dict, dict]:
    """(the CPU artifact, the reference file) from the cache."""
    with open(os.path.join(REPO, "PARITY_r05.json")) as f:
        r05_scenes = json.load(f)["scenes"]
    meta = tp.build_streams(BATCH, 1, tp.FREQ)[2]
    if meta != r05_scenes:
        raise AssertionError("the scenes differ from PARITY_r05's")
    cpu = {
        "metric": "port_lsb_error_vs_wmix_tpu",
        "freq": tp.FREQ,
        "backend": "cpu",
        "reference": "wmix_tpu",
        # a configuration's main block, then its second block
        "reference_modes": {
            **{nm: MODES["exact" if nm in EXACT_PROCESS else "pallas"]
               for nm in tp.CONFIGS},
            **{f"{nm}.vs_wmix_tpu_plain": MODES["plain"] for nm in PLAIN}},
        "fast_mode": True,
        "pallas": False,
        "batch": BATCH,
        "seconds": SECONDS,
        "complete": True,
        "expected_configs": list(tp.CONFIGS),
        "configs": {},
        "scenes": meta,
        "reduced": [],
    }
    ref = {"freq": tp.FREQ, "batch": BATCH, "scenes": meta, "configs": {}}
    for nm in tp.CONFIGS:
        want, want_flags = load("wmix_tpu", nm)
        got, got_flags = load("port_cpu", nm)
        stats = tp.error_stats(got, want, tp.FREQ)
        stats["bit_equal_expected"] = tp.CONFIGS[nm][4]
        stats["vad_vs_wmix_tpu"] = tp.vad_flag_diffs(got_flags, want_flags)
        cpu["configs"][nm] = stats
        entry = {"seconds": SECONDS}
        if tp.CONFIGS[nm][4]:
            entry["wmix_tpu_digest"] = tp.digest(want)
        else:
            entry["port_cpu_digest"] = tp.digest(got)
        if nm == "full_chain":
            entry["wmix_tpu_vad_flags"] = tp.pack_flags(want_flags)
        if nm in PLAIN:
            plain, plain_flags = load("wmix_tpu_plain", nm)
            second = tp.error_stats(got, plain, tp.FREQ)
            second["vad_vs_wmix_tpu_plain"] = tp.vad_flag_diffs(
                got_flags, plain_flags)
            stats["vs_wmix_tpu_plain"] = second
            stats["wmix_tpu_pallas_vs_plain"] = {
                k: v for k, v in tp.error_stats(want, plain, tp.FREQ).items()
                if k != "corr"}
            entry["wmix_tpu_plain_digest"] = tp.digest(plain)
            if nm == "aec_only":
                np.savez_compressed(tp.PLAIN_1S_PATH,
                                    out=plain[:, :tp.FREQ])
        ref["configs"][nm] = entry
    return cpu, ref


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=2,
                    help="port configurations run at a time")
    ap.add_argument("--reference", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mode", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.reference:
        return reference_process(args.reference.split(","), args.mode)
    if args.port:
        return port_process(args.port)
    produce(args.jobs)
    cpu, ref = assemble()
    with open(tp.CPU_ARTIFACT, "w") as f:
        json.dump(cpu, f, indent=1)
    with open(tp.REF_PATH, "w") as f:
        json.dump(ref, f, separators=(",", ":"))
    for nm, s in cpu["configs"].items():
        vad = s["vad_vs_wmix_tpu"]["differing_packages"]
        print(f"{nm}: max {s['max_lsb']} LSB, {s['pct_exact']} % exact, "
              f"VAD flags differing {vad}", flush=True)
    print(f"{tp.REF_PATH}: {os.path.getsize(tp.REF_PATH)} bytes")


if __name__ == "__main__":
    main()
