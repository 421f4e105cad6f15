"""How `correct` is decided: the timed path's outputs against the frozen
plain reference (`wbench/reference/`), run on the CPU from the same inputs.

The run keeps the outputs of a sample of slots, drawn from the seed, as
the timed path delivered them, package by package from the first
(`harness.Outputs`), and the inputs of those slots.  Once the window has
closed and the program's state is freed, the reference replays each
sampled slot from its first package, works out the plan and the state
itself, and the numbers below compare the two.  The replay stops at the
configuration's `max_pkgs`, so a faster program, which completes more
packages in a window, does not lengthen the check.

Numbers (the configuration's `check.limits` says which are held, and
their limits):

  over4_pct         % of origin samples more than 4 LSB off
  pkg8k_over4_pct   % of 1x8000 samples more than 4 LSB off
  vad_flip_pct      % of (slot, package) VAD flags that differ
  mismatches        origin samples, 1x8000 samples and VAD flags that
                    differ at all (an exact comparison)

Controls, the reference itself in the program's place but computed below
the configuration's precision (`reference_outputs(..., control=...)`):

  bf16_state        every floating leaf of the chain's state rounded to
                    bfloat16 after each package (a float32 chain whose
                    state is kept in bfloat16)
  nsx_15bit         the fixed-point NS's output with its lowest bit
                    cleared (an integer chain one bit short)
"""
from __future__ import annotations

import contextlib
import importlib
import os

import numpy as np
import torch


def sample_slots(batch: int, n: int, seed: int) -> list:
    """The `n` slots the check compares, drawn from the seed (sorted)."""
    g = torch.Generator()
    g.manual_seed((int(seed) * 2654435761 + 12345) % (1 << 63))
    return sorted(torch.randperm(batch, generator=g)[:n].tolist())


@contextlib.contextmanager
def mode(cfg: dict):
    """The arithmetic mode the configuration states, for chains built
    inside (`WMIX_EXACT`, read when a chain is built)."""
    saved = os.environ.get("WMIX_EXACT")
    os.environ["WMIX_EXACT"] = "1" if cfg["mode"] == "exact" else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("WMIX_EXACT", None)
        else:
            os.environ["WMIX_EXACT"] = saved


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _float_leaves(v)


def _bf16_state(chain) -> None:
    for leaf in _float_leaves(chain.state):
        leaf.copy_(leaf.to(torch.bfloat16).to(leaf.dtype))


def reference_outputs(cfg: dict, mic, play, n_pkgs: int,
                      control: str | None = None):
    """(origin [n, S, pkg], pkg8k [n, S, n8k], vad [n, S]) numpy from the
    reference chain over the sampled slots' inputs (mic, play: [T, S,
    pkg] int16 numpy, cycled), from the first package; with `control`,
    that control in the program's place."""
    ref = importlib.import_module(cfg["reference"])
    nsx = importlib.import_module("wbench.reference.dsp.nsx")
    orig_nsx = nsx.process_pkg
    if control == "nsx_15bit":
        def lower(*args, **kw):
            st, x = orig_nsx(*args, **kw)
            return st, x & ~1
        nsx.process_pkg = lower
    elif control not in (None, "bf16_state"):
        raise ValueError(f"unknown control {control!r}")
    try:
        with mode(cfg):
            chain = ref.RecordChain(mic.shape[1], cfg["freq"], device="cpu",
                                    **cfg["chain"])
        outs = ([], [], [])
        T = mic.shape[0]
        with torch.inference_mode():
            for t in range(n_pkgs):
                o = chain.step(torch.from_numpy(mic[t % T]),
                               torch.from_numpy(play[t % T]))
                for acc, x in zip(outs, o):
                    acc.append(x.numpy().copy())
                if control == "bf16_state":
                    _bf16_state(chain)
    finally:
        nsx.process_pkg = orig_nsx
    return tuple(np.stack(a) for a in outs)


def numbers(prog, ref) -> dict:
    """Every number of the module docstring, program against reference
    (each a tuple of origin, pkg8k, vad arrays over the same packages)."""
    po, p8, pv = (np.asarray(a) for a in prog)
    ro, r8, rv = (np.asarray(a) for a in ref)
    d = np.abs(po.astype(np.int32) - ro.astype(np.int32))
    d8 = np.abs(p8.astype(np.int32) - r8.astype(np.int32))
    return {
        "over4_pct": float(100.0 * (d > 4).mean()),
        "pkg8k_over4_pct": float(100.0 * (d8 > 4).mean()),
        "vad_flip_pct": float(100.0 * (pv != rv).mean()),
        "mismatches": int((d != 0).sum() + (d8 != 0).sum() +
                          (pv != rv).sum()),
    }


def judge(cfg: dict, outputs, mic, play, fed_pkgs: int):
    """(correct, compared, n_compared): the sampled outputs against the
    reference over the first min(delivered, max_pkgs) packages.
    `compared` is {number: (value, limit)}: `undelivered`, the packages
    fed (`fed_pkgs`) that never came back, with the limit 0, then the
    configuration's numbers."""
    chk = cfg["check"]
    n = min(len(outputs), chk["max_pkgs"])
    compared = {"undelivered": (fed_pkgs - len(outputs), 0)}
    ok = len(outputs) == fed_pkgs and n > 0
    if n > 0:
        prog = (np.stack(outputs.origin[:n]), np.stack(outputs.pkg8k[:n]),
                np.stack(outputs.vad[:n]))
        ref = reference_outputs(cfg, mic, play, n)
        got = numbers(prog, ref)
        for name, limit in chk["limits"].items():
            compared[name] = (got[name], limit)
            ok = ok and got[name] <= limit
    return ok, compared, n
