"""Driver entry points of the port.  The counterpart of `__graft_entry__.py`.

entry()             -> (fn, args): one steady 20 ms package of the full
                       batched record chain (NS -> AEC -> AGC -> VAD ->
                       shared-memory outputs) at B = 8, 16 kHz, as a
                       function and its arguments; `fn(*args)` launches
                       the AEC package kernel once on the card.
dryrun_multichip(n) -> the stream batch over n devices, each shard against
                       the chain it must equal (`multichip.py`).

`_build` builds the package as `__graft_entry__._build` (:30-50) does:
the planner advances without device work, then one more planner tick
gives the package's FIFO slots and AEC plan `(add, get, sig, dyn)`, and
`fn(state, mic, play, add, get, dyn)` returns `(state, origin, pkg8k,
vad_flags)` like the reference's chain body.  The reference advances
three ticks, past the AEC's start-up, so its package is the out ring's
priming one: a steady plan signature with irregular ring offsets, which
the reference's body serves in the exact ring layout (its package kernel
never does) and the port's too.  `entry()` advances one tick more: the
first package whose plan the kernel serves, so that its `fn` is the
kernel's package (`RecordChain._package` with the state in the kernel
layout).  Unlike the reference's pure function, `fn` updates the state
it is given in place (the play FIFO slot and the kernel's state), as the
chain does.

Every tensor lies on the card unless `device="cpu"` is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from wmix_tpu_torch.engine.chain import RecordChain
from wmix_tpu_torch.multichip import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]

STEADY_TICKS = 4      # three start-up packages and the priming one


def _build(batch: int, freq: int = 16000, ticks: int = STEADY_TICKS,
           device=None):
    """(fn, args) of the chain's package after `ticks` planner-only ticks;
    mic and play are the seeded noise of `__graft_entry__._build`."""
    rc = RecordChain(batch, freq, device=device)
    for _ in range(ticks):
        rc._plan_tick()
    add, get, sig, dyn = rc._plan_tick()
    kernel = rc._prepare_aec(sig, dyn)

    def fn(state, mic, play, add_slot, get_slot, dyn):
        return rc._package(state, mic, play, add_slot, get_slot, sig, dyn,
                           kernel)

    rng = np.random.RandomState(0)
    pkg = rc.pkg_len
    mic = (rng.randn(batch, pkg) * 3000).astype(np.int16)
    play = (rng.randn(batch, pkg) * 5000).astype(np.int16)
    args = (rc.state, torch.from_numpy(mic).to(rc.device),
            torch.from_numpy(play).to(rc.device), add, get, dyn)
    return fn, args


def entry(device=None):
    """(fn, args) for one steady 16 kHz package at B = 8."""
    return _build(batch=8, device=device)
