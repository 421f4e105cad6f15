"""Checkpoint / resume of per-stream DSP state.

Port of `wmix_tpu/engine/checkpoint.py`: a snapshot carries the device
state of a `RecordChain` (NS quantile trackers, AEC partitions and filter,
AGC capacitors, VAD GMM, the play-FIFO ring) plus the host cursors (the
AecPlanner's or AecmPlanner's ring positions, start-up state machine and
comfort-noise seed, the chain's FIFO slot counter), so a restarted server
resumes every stream mid-stream.

Round trip (tests/test_torch_checkpoint.py): a chain restored from a
snapshot produces the same output stream, bit for bit, as one that never
stopped.

Format, shared with `wmix_tpu`: one .npz with the flattened state leaves
plus a JSON header of geometry and host cursors.  No pickle; `restore`
validates the header against the target chain instead of trusting the
file.  Leaves are in the order `jax.tree_util.tree_leaves` gives them
(NamedTuple fields in order, dict keys sorted), so a snapshot that
`wmix_tpu.engine.checkpoint.snapshot` made of a 16 kHz fast-mode chain
restores into the port: "pallas" in a header names the kernel layout
(`engine/aec_package.py`), and "aecm" the AECM backend's `AecmEngState`.
The port's uint32 leaves (NSX's, held in int64) are written as uint32, as
the reference writes them, and read back into int64.

The header carries the geometry (`batch`, `freq`, `chn`, `interval_ms`,
`aec_interval_ms`, `part_cap`, `flags`, the backends) and `restore` holds
each against the target chain; `interval_ms` and `aec_interval_ms` are the
port's additions, checked where present (a header without them, as
`wmix_tpu` writes it, leaves them to the play FIFO's shape,
[B, aec_interval_ms // interval_ms + 2, pkg_len * chn], which is checked in
any case).

Arithmetic modes.  The header also records the mode the snapshot was
taken in (`exact`), for the reader; the reference records none and checks
none, because the mode changes no leaf of the state, and so a snapshot
taken in one mode restores in the other here too.  The one exception is
what the reference accepts and then fails on at its next step: a
kernel-layout ("pallas") snapshot, which only a fast-mode chain can make,
does not restore into an exact-mode chain, which never leaves the ring
layout; `restore` refuses it with a ValueError.
"""
from __future__ import annotations

import io
import json

import numpy as np
import torch

from wmix_tpu_torch.engine import aec_package, aecm_step
from wmix_tpu_torch.engine.aec_plan import _AbsRing

def _planner_state(p) -> dict:
    out = {}
    for k, v in vars(p).items():
        if isinstance(v, _AbsRing):
            out[k] = {"__ring__": True, "count": v.count, "r": v.r,
                      "w": v.w}
        elif isinstance(v, (bool, int, float)):
            out[k] = v
        else:
            raise TypeError(f"unexpected planner field {k}={type(v)}")
    return out


def _restore_planner(p, snap: dict) -> None:
    # whitelist: only fields the live planner already has, with matching
    # kinds; a snapshot header is untrusted input
    live = vars(p)
    for k, v in snap.items():
        if k not in live:
            raise ValueError(f"unknown planner field {k!r} in snapshot")
        if isinstance(v, dict) and v.get("__ring__"):
            ring = live[k]
            if not isinstance(ring, _AbsRing):
                raise ValueError(f"planner field {k!r} is not a ring")
            if ring.count != v["count"]:
                raise ValueError(f"ring {k!r} geometry mismatch: "
                                 f"{ring.count} != {v['count']}")
            ring.r, ring.w = int(v["r"]), int(v["w"])
        elif isinstance(v, (bool, int, float)) and \
                isinstance(live[k], (bool, int, float)):
            setattr(p, k, type(live[k])(v))
        else:
            raise ValueError(f"planner field {k!r} has unexpected type")


def _aec_layout(chain) -> str:
    """"pallas" for the kernel layout (the name `wmix_tpu` writes), "aecm"
    for the AECM backend, "jax" for the exact ring layout."""
    if aec_package.is_kernel_layout(chain.state.aec):
        return "pallas"
    if isinstance(chain.state.aec, aecm_step.AecmEngState):
        return "aecm"
    return "jax"


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A leaf as the reference stores it: int64 leaves are the port's
    uint32 carriers."""
    arr = x.detach().cpu().numpy()
    return arr.astype(np.uint32) if arr.dtype == np.int64 else arr


def _leaves(tree) -> list:
    """The state's tensors in `jax.tree_util.tree_leaves` order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def _rebuild(tree, leaves):
    """`tree` with its tensors replaced, in `_leaves` order, from the
    iterator `leaves`."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    return type(tree)(*(_rebuild(v, leaves) for v in tree))


def snapshot(chain) -> bytes:
    """Serialize a RecordChain's full streaming state to bytes."""
    leaves = _leaves(chain.state)
    header = {
        "batch": chain.batch,
        "freq": chain.freq,
        "chn": chain.chn,
        "interval_ms": chain.interval_ms,
        "aec_interval_ms": chain.aec_interval_ms,
        "exact": not chain.fast,
        "flags": list(chain.flags),
        "agc_gain_db": chain.agc_gain_db,
        "part_cap": chain.part_cap,
        "play_count": chain.play_count,
        "tick": chain.tick,
        "planner": _planner_state(chain.planner) if chain.planner
        else None,
        "n_leaves": len(leaves),
        # the AEC layout changes the state's structure; recorded so that a
        # steady-state snapshot restores into a fresh chain, whose layout
        # is the exact one
        "aec_layout": _aec_layout(chain),
        "ns_backend": chain.ns_backend,
    }
    buf = io.BytesIO()
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    arrays["header"] = np.frombuffer(
        json.dumps(header).encode(), np.uint8)
    np.savez(buf, **arrays)
    return buf.getvalue()


def restore(chain, data: bytes) -> None:
    """Restore a snapshot into a freshly constructed RecordChain of the
    same geometry (batch/freq/flags).  In place; the leaves go to the
    chain's device with the dtype of the leaf they replace."""
    with np.load(io.BytesIO(data)) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        leaves = [z[f"leaf_{i}"] for i in range(header["n_leaves"])]

    if header.get("chn", 1) != chain.chn:
        raise ValueError("chn mismatch")
    for key in ("batch", "freq", "part_cap", "interval_ms",
                "aec_interval_ms"):
        want = header.get(key) if key in ("batch", "freq", "part_cap") \
            else header.get(key, getattr(chain, key))
        if want != getattr(chain, key):
            raise ValueError(f"{key} mismatch: snapshot {want} != chain "
                             f"{getattr(chain, key)}")
    if tuple(header["flags"]) != tuple(chain.flags):
        raise ValueError("flags mismatch")
    want_ns = header.get("ns_backend", "ns")
    if want_ns != chain.ns_backend:
        raise ValueError(
            f"snapshot holds a {want_ns!r} NS-backend state; construct "
            f"the target RecordChain with ns_backend={want_ns!r}")

    # bring the chain's AEC state into the snapshot's layout before the
    # leaves are matched: a fresh chain holds the exact layout, a snapshot
    # taken in steady state the kernel layout
    want = header.get("aec_layout", "jax")
    have = _aec_layout(chain)
    if want == "aecm" and have != "aecm":
        raise ValueError("snapshot holds an AECM-backend state; construct "
                         "the target RecordChain with aec_backend='aecm'")
    if have == "aecm" and want != "aecm":
        raise ValueError("snapshot holds a float-AEC state; construct the "
                         "target RecordChain with aec_backend='aec'")
    if want not in ("jax", "pallas", "aecm"):
        raise ValueError(f"unknown aec_layout {want!r} in snapshot")
    if want == "pallas" and not aec_package.kernel_serves(chain.freq,
                                                          chain.fast):
        raise ValueError("snapshot holds the kernel-layout AEC state of a "
                         "fast-mode chain; an exact-mode chain keeps the "
                         "ring layout and cannot take it")
    state = chain.state
    if want != have:
        state = state._replace(aec=aec_package.fresh_chain_aec(
            want == "pallas", chain.batch, chain.part_cap, chain.device))

    old_leaves = _leaves(state)
    if len(old_leaves) != len(leaves):
        raise ValueError(f"leaf count mismatch: snapshot {len(leaves)} "
                         f"!= chain {len(old_leaves)}")
    for x, old in zip(leaves, old_leaves):
        if tuple(x.shape) != tuple(old.shape):
            raise ValueError(f"leaf shape mismatch: snapshot "
                             f"{x.shape} != chain {tuple(old.shape)}")
    new_leaves = [
        torch.from_numpy(np.ascontiguousarray(x)).to(
            device=old.device, dtype=old.dtype)
        for x, old in zip(leaves, old_leaves)]
    chain.state = _rebuild(state, iter(new_leaves))
    chain.play_count = header["play_count"]
    chain.tick = header["tick"]
    if header["planner"] is not None:
        if chain.planner is None:
            raise ValueError("snapshot has planner state but the chain "
                             "has no planner")
        _restore_planner(chain.planner, header["planner"])


def save(chain, path: str) -> None:
    with open(path, "wb") as f:
        f.write(snapshot(chain))


def load(chain, path: str) -> None:
    with open(path, "rb") as f:
        restore(chain, f.read())
