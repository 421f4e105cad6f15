"""The stream batch over several devices, checked end to end.

    python -m wmix_tpu_torch.multichip [n_devices] [--device cpu]

`dryrun_multichip(n)` is the counterpart of `__graft_entry__.py`
`dryrun_multichip` (:78-191).  The stream axis is pure data parallelism:
every stream's state is its own, so a `ShardedRecordChain` of n shards,
one on each device, needs no collective and must give what one chain over
the whole batch gives.  It runs, at batch 2n and 16 kHz:

1. one chunk with the planner advanced past the AEC's start-up, as the
   reference's `_build` does (:30-50), sharded against unsharded, in fast
   mode, in exact mode and in the integer chain (NSX + AECM);
2. one chunk of the kernel path: K = 3 after 4 warm-up ticks
   (`_dryrun_pallas`, :142-191), every shard in the AEC package layout,
   whose steady packages run the CUDA kernel on the shard's device.

and prints one line for each.  On the CPU (`device="cpu"`: n shards on
the CPU) every comparison is bitwise equality with the unsharded chain.
On the cards (`cuda:0` to `cuda:n-1`; fewer cards raise) exact mode and
the integer chain must still equal the unsharded chain bit for bit; in
fast mode the card's matrix products sum in an order that follows the
batch size, so there each shard must equal a dedicated `RecordChain` of
the shard's width on the same slots and device.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from wmix_tpu_torch.dsp.floatops import mode_env
from wmix_tpu_torch.engine import aec_package
from wmix_tpu_torch.engine.chain import RecordChain, ShardedRecordChain

FREQ = 16000
PKG = FREQ // 1000 * 20
MODES = {"fast": {}, "exact": {},
         "integer": dict(aec_backend="aecm", ns_backend="nsx")}


def shard_devices(n_devices: int, device=None) -> list:
    """n devices for n shards: `cuda:0` .. `cuda:n-1` (the default), or
    the CPU n times.  Fewer cards than n raise: shards are never stacked
    on one card here."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n_devices
    if device is not None and torch.device(device) != torch.device("cuda"):
        raise ValueError(f"dryrun_multichip: device is None, 'cuda' or "
                         f"'cpu', not {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(f"dryrun_multichip: {n_devices} CUDA devices "
                           f"wanted, {have} present")
    return [torch.device(f"cuda:{i}") for i in range(n_devices)]


def _advanced(chain, ticks: int):
    for _ in range(ticks):
        chain._plan_tick()
    return chain


def _host(outs) -> list:
    return [o.cpu().numpy() for o in outs]


def _assert_equal(got, want, what: str) -> None:
    for g, w, nm in zip(got, want, ("origin", "pkg8k", "vflags")):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"dryrun_multichip: {what}: {nm} differs")


def _compare(devices, mics, plays, ticks: int, mode: str, kw,
             kernel_path: bool = False) -> str:
    """The sharded chunk, after `ticks` planner ticks, against its
    reference; returns what it was held to."""
    batch = mics.shape[1]
    n = len(devices)
    sh = _advanced(ShardedRecordChain(batch, FREQ, shards=n,
                                      devices=devices, **kw), ticks)
    got = _host(sh.run_chunk(mics, plays))
    if devices[0].type == "cpu" or mode != "fast":
        ref = _advanced(RecordChain(batch, FREQ, device=devices[0], **kw),
                        ticks)
        _assert_equal(got, _host(ref.run_chunk(mics, plays)),
                      f"{mode}, sharded vs unsharded")
        held = "unsharded"
    else:
        for (_ch, lo, hi), d in zip(sh.shard_ranges(), devices):
            one = _advanced(RecordChain(hi - lo, FREQ, device=d, **kw),
                            ticks)
            want = _host(one.run_chunk(mics[:, lo:hi], plays[:, lo:hi]))
            _assert_equal([g[:, lo:hi] for g in got], want,
                          f"{mode}, shard on {d} vs a chain of its width")
        held = "dedicated"
    if kernel_path and not all(aec_package.is_kernel_layout(st.aec)
                               for st in sh.state):
        raise AssertionError("dryrun_multichip: a shard did not take the "
                             "kernel layout")
    if not np.abs(got[0]).any():
        raise AssertionError(f"dryrun_multichip: {mode}: silent output")
    return held


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the two checks of the module docstring over n devices; raises
    AssertionError where a shard differs."""
    devices = shard_devices(n_devices, device)
    batch = 2 * n_devices
    names = ",".join(str(d) for d in devices)
    rng = np.random.RandomState(0)
    mics = (rng.randn(1, batch, PKG) * 3000).astype(np.int16)
    plays = (rng.randn(1, batch, PKG) * 5000).astype(np.int16)
    held = {}
    for mode, kw in MODES.items():
        with mode_env(mode == "exact"):
            held[mode] = _compare(devices, mics, plays, 3, mode, kw)
    print(f"dryrun_multichip: {n_devices} devices ({names}), batch {batch}, "
          f"one chunk after start-up, sharded == the chain it is held to, "
          f"bitwise: {held}", flush=True)
    # 4 warm-up ticks: tick 3 is the out ring's priming package (steady
    # signature, irregular offsets), so a K = 3 chunk from tick 4 on runs
    # every package in the kernel layout
    rng = np.random.RandomState(1)
    mics = (rng.randn(3, batch, PKG) * 3000).astype(np.int16)
    plays = (rng.randn(3, batch, PKG) * 5000).astype(np.int16)
    with mode_env(False):
        held = _compare(devices, mics, plays, 4, "fast", {},
                        kernel_path=True)
    print(f"dryrun_multichip: AEC package path under {n_devices}-way "
          f"sharding == {held} chain bitwise", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--device", help="'cpu' for n shards on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
