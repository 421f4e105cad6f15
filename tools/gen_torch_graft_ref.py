"""Reference outputs of `__graft_entry__`'s package body for
`wmix_tpu_torch/graft_entry.py`.

    python tools/gen_torch_graft_ref.py

runs, on the CPU under x64 with WMIX_FAST=1 WMIX_PALLAS=0 (the plain-JAX
fast path that the port's fast AEC is held to), the body and arguments of

  * `__graft_entry__.entry()` itself: B = 8, three planner-only ticks,
    so the out ring's priming package (`ticks3`);
  * the same build one planner tick later, the first package that the
    port's kernel serves, which is what `graft_entry.entry()` returns
    (`ticks4`);

and writes `tests/data/torch_graft_entry_fast.npz`: `origin<t>`,
`pkg8k<t>` and `vflags<t>` of each.  JAX reads the mode when it traces
and keeps its first trace, so this runs in a process of its own, about a
CPU-minute.  tests/test_torch_bench.py holds the port's packages to the
file (within 4 LSB, VAD flags equal), and a test there marked `slow`
runs this again and holds the file to it.
"""
from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(REPO, "tests", "data", "torch_graft_entry_fast.npz")
TICKS = (3, 4)


def _build(ticks: int):
    """`__graft_entry__._build(batch=8)` with `ticks` planner-only ticks
    in place of its three."""
    from wmix_tpu.engine import chain as chain_mod
    rc = chain_mod.RecordChain(8, 16000)
    for _ in range(ticks):
        rc._plan_tick()
    add, get, sig, dyn = rc._plan_tick()
    body = chain_mod._build_chain_body(
        sig, rc.sub_len, rc.planner.mult, rc.planner.nlp_mode, rc.freq,
        rc.flags, rc.agc_gain_db,
        None if rc.zoom_idx is None else tuple(rc.zoom_idx.tolist()))
    rng = np.random.RandomState(0)
    mic = (rng.randn(8, rc.pkg_len) * 3000).astype(np.int16)
    play = (rng.randn(8, rc.pkg_len) * 5000).astype(np.int16)
    return body, (rc.state, mic, play, np.int32(add), np.int32(get), dyn)


def reference_run() -> dict:
    os.environ["WMIX_FAST"] = "1"
    os.environ["WMIX_PALLAS"] = "0"
    os.environ.pop("WMIX_EXACT", None)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_allow_excess_precision=false").strip()
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import __graft_entry__
    from wmix_tpu.dsp import floatops
    assert floatops.fast_mode()
    out = {}
    for ticks in TICKS:
        fn, args = __graft_entry__.entry() if ticks == 3 else _build(ticks)
        _state, origin, pkg8k, vflags = jax.jit(fn)(*args)
        out[f"origin{ticks}"] = np.asarray(origin).astype(np.int16)
        out[f"pkg8k{ticks}"] = np.asarray(pkg8k).astype(np.int16)
        out[f"vflags{ticks}"] = np.asarray(vflags).astype(np.int32)
    return out


def load() -> dict:
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference_run())
    print(f"{PATH}: {os.path.getsize(PATH)} bytes")
