"""Checkpoint / resume of per-stream DSP state.

Port of `wmix_tpu/engine/checkpoint.py`: a snapshot carries the device
state of a `RecordChain` (NS quantile trackers, AEC partitions and filter,
AGC capacitors, VAD GMM, the play-FIFO ring) plus the host cursors (the
AecPlanner's ring positions, start-up state machine and comfort-noise
seed, the chain's FIFO slot counter), so a restarted server resumes every
stream mid-stream.

Round trip (tests/test_torch_checkpoint.py): a chain restored from a
snapshot produces the same output stream, bit for bit, as one that never
stopped.

Format, shared with `wmix_tpu`: one .npz with the flattened state leaves
plus a JSON header of geometry and host cursors.  No pickle; `restore`
validates the header against the target chain instead of trusting the
file.  Leaves are in the order `jax.tree_util.tree_leaves` gives them
(NamedTuple fields in order, dict keys sorted), so a snapshot that
`wmix_tpu.engine.checkpoint.snapshot` made of a 16 kHz fast-mode chain
restores into the port: "pallas" in a header names the kernel layout, the
port's `PackageAecState`.
"""
from __future__ import annotations

import io
import json

import numpy as np
import torch

from wmix_tpu_torch.engine import aec_package, aec_step
from wmix_tpu_torch.engine.aec_plan import AecPlanner, _AbsRing

_NOT_PORTED = ("the integer NSX+AECM chain is not ported yet "
               "(ROADMAP item 9)")


def _planner_state(p: AecPlanner) -> dict:
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


def _restore_planner(p: AecPlanner, snap: dict) -> None:
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
    """"pallas" for the kernel layout (the name `wmix_tpu` writes), "jax"
    for the exact ring layout."""
    if isinstance(chain.state.aec, aec_package.PackageAecState):
        return "pallas"
    return "jax"


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
        "ns_backend": "ns",
    }
    buf = io.BytesIO()
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(leaves)}
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
    for key in ("batch", "freq", "part_cap"):
        if header[key] != getattr(chain, key):
            raise ValueError(f"{key} mismatch: snapshot "
                             f"{header[key]} != chain {getattr(chain, key)}")
    if tuple(header["flags"]) != tuple(chain.flags):
        raise ValueError("flags mismatch")
    want_ns = header.get("ns_backend", "ns")
    if want_ns != "ns":
        raise ValueError(f"snapshot holds a {want_ns!r} NS-backend state; "
                         + _NOT_PORTED)

    # bring the chain's AEC state into the snapshot's layout before the
    # leaves are matched: a fresh chain holds the exact layout, a snapshot
    # taken in steady state the kernel layout
    want = header.get("aec_layout", "jax")
    if want == "aecm":
        raise ValueError("snapshot holds an AECM-backend state; "
                         + _NOT_PORTED)
    if want not in ("jax", "pallas"):
        raise ValueError(f"unknown aec_layout {want!r} in snapshot")
    state = chain.state
    if want != _aec_layout(chain):
        aec = (aec_package.init_chain_aec(chain.batch, chain.part_cap,
                                          chain.device)
               if want == "pallas"
               else aec_step.init_eng_state(chain.batch, chain.part_cap,
                                            chain.device))
        state = state._replace(aec=aec)

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
