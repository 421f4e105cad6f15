"""Where two fast AECs part: `wmix_tpu`'s chain with the Pallas package
kernel (interpret mode), `wmix_tpu`'s plain-JAX fast chain, the port's
chain on the CPU and the port's chain on the card, over the parity scenes.

    python tools/aec_parting.py [--batch 8] [--seconds 0.5]
        [--sides pallas,plain,port] [--from-s 0] [--out PATH]
    python tools/aec_parting.py --sides port,card --batch 64 --seconds 24
        --from-s 18                      (on the card; imports no JAX)

Every side is a `RecordChain(B, 16000)` with the AEC alone on (parity's
`aec_only`), fed the first `--batch` scenes of
`wmix_tpu_torch.parity.build_streams` by `step`, one package at a time, all
sides in lockstep in this one process (all of them fast mode):

  * `pallas`: `wmix_tpu` with WMIX_FAST=1 WMIX_PALLAS=1, the package kernel
    in Pallas interpret mode, as tools/gen_torch_parity_ref.py runs it;
  * `plain`: the same `wmix_tpu` chain with its Pallas path off (what
    WMIX_PALLAS=0 selects): the exact-layout step over `dsp/aec.py`;
  * `port`: `wmix_tpu_torch` on the CPU (`package_body`);
  * `card`: `wmix_tpu_torch` on the card (the CUDA kernel).

`wmix_tpu` runs on the CPU under x64 with XLA's excess precision off, as
the tests run it.  After each package every side's AEC state is brought
into the kernel layout (`aec_pallas.convert_eng_state` on the reference
side, `aec_package.convert_eng_state` on the port's, with the next
package's plan) and compared leaf by leaf.  Per pair of sides and stream
it reports the runs of packages whose output parts by more than 1 LSB,
the packages where a decision leaf (an integer leaf: `delay_idx`,
`diverge`, `echo`, `st_near`, `new_min`, `min_ctr`) starts to part, with
its values, and the largest LSB per 6 s window.  The float leaves drift
apart continuously; the replays below report the scalar ones block by
block.

The decision leaves after each block are kept from inside each chain's
own package program: `wmix_tpu`'s Pallas `_block_math` gets a host
callback (`jax.debug.callback`) in the program the chain compiles, and
the port's `_block_math` is wrapped.  The first block where the two
chains' decision leaves part is the onset's block.  The plain-JAX chain's
blocks come from its replay below, from its own state.

The last line printed (standard output; progress goes to standard error)
is one JSON object: the sides, size and card, and per pair each run of
packages past 1 LSB with the decision onset before it, its block and
that block's decision margins, and its closest decision.

At each package where a decision leaf starts to part, or where an output
parts past 1 LSB with no decision leaf parted at the package's end, the
package is run again block by block from the second side's state before
it (the "parent"), with the port's block inputs of that package (its far
spectra, near samples, randoms and flags), in up to four forms:

  * `wmix_tpu_form`: `wmix_tpu`'s `aec_pallas._block_math` compiled by XLA
    as one program over the five blocks (reference sides only): a
    program of its own, fused otherwise than the chain's;
  * `wmix_plain_form`: `wmix_tpu`'s `process_block_kernel` over the batch,
    one compiled block at a time from the plain chain's own exact-layout
    state before the package (pairs with `plain`);
  * `port_f32`: the port's `_block_math` in float32 (the port on the CPU);
  * `f64`: the port's `_block_math` in float64, which gives every
    decision's operands (`probe`) and their margin in float32 ulps at the
    larger operand.

For a pair with the card, the parent goes through the kernel and
`package_body` once each (package level), as the card has no per-block
form.  The first block where the forms' decision leaves part from one
parent, with the float64 margins of that block's decisions, says whether
the forms decide alike from one state: a margin under a few ulps is a tie
that each arithmetic resolves its own way.  Each replay says whether each
form gives its chain's decision leaves at the package's end.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FREQ, PKG = 16000, 320
BLOCKS = 5
INT_LEAVES = ("delay_idx", "diverge", "echo", "st_near", "new_min",
              "min_ctr")
SCALAR_F = ("fb_min", "fb_local_min", "xd_avg_min", "over_drive",
            "over_drive_sm")
SCALAR_REL = 1e-4
WINDOW_PKGS = 300       # 6 s of 20 ms packages
AEC_ONLY = dict(ns_enable=False, aec_enable=True, agc_enable=False,
                vad_enable=False)
JAX_SIDES = ("pallas", "plain")


def _jax_setup() -> None:
    """`wmix_tpu` on the CPU in fast mode with the Pallas path selectable,
    set before it is imported (it reads its mode when it traces)."""
    os.environ["WMIX_FAST"] = "1"
    os.environ["WMIX_PALLAS"] = "1"
    os.environ.pop("WMIX_EXACT", None)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_allow_excess_precision=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


# ------------------------------------------------------------------ sides

# the blocks' decision leaves of the package a chain is stepping, kept from
# inside its own package program: side -> [(block, {leaf: [B]})]
_BLOCK_LEAVES: dict = {}


def _keep_block(side: str, block: int, leaves: dict) -> None:
    if side in _BLOCK_LEAVES:
        _BLOCK_LEAVES[side].append((block, {
            k: np.asarray(v).reshape(len(v), -1)[:, 0].copy()
            for k, v in leaves.items()}))


@functools.lru_cache(maxsize=None)
def _record_blocks(side: str) -> None:
    """Wrap the block math that `side`'s chain runs so that each block's
    decision leaves are kept while it steps: for `pallas` a host callback
    inside the program the chain compiles (installed before it traces;
    the callback only reads integer leaves), for `port` a Python wrapper.
    `package_body` and `_package_body` run the five blocks in order."""
    if side == "pallas":
        import jax
        from wmix_tpu.engine import aec_pallas as mod
    else:
        from wmix_tpu_torch.engine import aec_package as mod
    inner = mod._block_math
    calls = [0]

    @functools.wraps(inner)
    def block_math(*args, **kw):
        st, out = inner(*args, **kw)
        b = calls[0] % BLOCKS
        calls[0] += 1
        leaves = {k: st[k] for k in INT_LEAVES}
        if side == "pallas":
            jax.debug.callback(functools.partial(_keep_block, side, b),
                               leaves)
        else:
            _keep_block(side, b, leaves)
        return st, out
    mod._block_math = block_math


class Side:
    """One chain, stepped a package at a time."""

    def __init__(self, name: str, batch: int):
        self.name = name
        self.inputs = None          # the port's package inputs (port sides)
        self.before = None          # plain: (exact-layout state, dyn)
        self.blocks = None          # per block {leaf: [B]} (pallas, port)
        if name in ("pallas", "port"):
            _record_blocks(name)
        if name in JAX_SIDES:
            from wmix_tpu.engine.chain import RecordChain
            self.chain = RecordChain(batch, FREQ, **AEC_ONLY)
            if name == "plain":
                self.chain._pallas_on = lambda: False
        else:
            from wmix_tpu_torch.engine.chain import RecordChain
            self.chain = RecordChain(batch, FREQ, device=(
                "cpu" if name == "port" else "cuda"), **AEC_ONLY)

    def step(self, mic, play) -> np.ndarray:
        if self.name == "plain":
            # the exact-layout block state and plan the package starts
            # from, copied: the chain's program donates its state
            from wmix_tpu.engine import aec_step
            plan = copy.deepcopy(self.chain.planner).plan_pkg()
            dev = self.chain.state.aec.dev
            self.before = (type(dev)(*(np.array(x) for x in dev)),
                           aec_step.pack_dyn(plan, self.chain.part_cap))
        _BLOCK_LEAVES[self.name] = []
        out = self.chain.step(mic, play)[0]
        if self.name in JAX_SIDES:
            import jax
            out = np.asarray(out)
            jax.effects_barrier()
        else:
            out = out.cpu().numpy()
        kept = sorted(_BLOCK_LEAVES.pop(self.name), key=lambda t: t[0])
        self.blocks = ([lv for _b, lv in kept] if len(kept) == BLOCKS
                       else None)
        return out

    def state(self):
        """The AEC state in the kernel layout, numpy, or None while the
        chain is in start-up."""
        if self.name in JAX_SIDES:
            return _jax_kernel_state(self.chain)
        return _port_kernel_state(self.chain)


def _next_dyn(chain, aec_step, steady_16k, steady_dyn):
    plan = copy.deepcopy(chain.planner).plan_pkg()
    dyn = aec_step.pack_dyn(plan, chain.part_cap)
    if not (steady_16k(plan.signature()) and steady_dyn(dyn)):
        return None
    return dyn


def _jax_kernel_state(chain):
    from wmix_tpu.engine import aec_pallas, aec_step
    a = chain.state.aec
    if isinstance(a, aec_pallas.PallasAecState):
        p = a.p
    else:
        dyn = _next_dyn(chain, aec_step, aec_pallas.is_steady_16k,
                        aec_pallas.is_steady_dyn)
        if dyn is None:
            return None
        p = aec_pallas.convert_eng_state(a, dyn)
    return {k: np.asarray(v) for k, v in p.items()}


def _port_kernel_state(chain):
    from wmix_tpu_torch.engine import aec_package, aec_step
    a = chain.state.aec
    if isinstance(a, aec_package.PackageAecState):
        p = a.p
    else:
        dyn = _next_dyn(chain, aec_step, aec_package.is_steady_16k,
                        aec_package.is_steady_dyn)
        if dyn is None:
            return None
        p = aec_package.convert_eng_state(a, dyn)
    return {k: v.cpu().numpy() for k, v in p.items()}


def _capture_port_inputs(sides) -> None:
    """Keep each port side's last package inputs (the port's chain calls
    `aec_package.package_step` by its module name)."""
    from wmix_tpu_torch.engine import aec_package
    step = aec_package.package_step
    by_device = {("cpu" if s.name == "port" else "cuda"): s for s in sides
                 if s.name not in JAX_SIDES}

    @functools.wraps(step)
    def wrapped(state, *ins, **kw):
        side = by_device.get(ins[0].device.type)
        if side is not None:
            side.inputs = tuple(t.detach().cpu().clone() for t in ins)
        return step(state, *ins, **kw)
    aec_package.package_step = wrapped


# -------------------------------------------------------------- comparing

def leaf_parting(a: dict, b: dict):
    """({integer leaf: [B] bool, the streams where it parts}, {every leaf:
    [B] float, its largest relative difference})."""
    rel, parted = {}, {}
    for k in a:
        x = a[k].astype(np.float64).reshape(len(a[k]), -1)
        y = b[k].astype(np.float64).reshape(len(b[k]), -1)
        d = np.abs(x - y).max(axis=1)
        rel[k] = d / np.maximum(np.abs(y).max(axis=1), 1e-30)
        if k in INT_LEAVES:
            parted[k] = d > 0
    return parted, rel


def ulp32(x) -> float:
    return float(np.spacing(np.float32(abs(float(x)))))


def margin(a, b) -> dict:
    """The clause a > b in float64 and its margin in float32 ulps at the
    larger operand: positive when it holds, its size the distance to
    flipping it."""
    a, b = float(a), float(b)
    return {"a": a, "b": b,
            "margin_ulps": round((a - b) / ulp32(max(abs(a), abs(b))), 4)}


def both(*clauses) -> dict:
    """A conjunction: it holds while its smallest margin is positive."""
    return {"clauses": clauses,
            "margin_ulps": min(c["margin_ulps"] for c in clauses)}


def either(*clauses) -> dict:
    """A disjunction: it holds while its largest margin is positive."""
    return {"clauses": clauses,
            "margin_ulps": max(c["margin_ulps"] for c in clauses)}


def decisions(probe: dict, prev: dict, s: int, f_upd: bool) -> dict:
    """The float64 operands of one block's decisions on stream `s`
    (aec_core.c's NonLinearProcessing), each with its margin."""
    p = {k: v[s].double().numpy().ravel() for k, v in probe.items()}
    se, sd = p["se_sum"][0], p["sd_sum"][0]
    div_prev = int(prev["diverge"][s, 0])
    de, xd, lo = p["h_de_avg"][0], p["h_xd_avg"][0], p["h_fb_low"][0]
    out = {"diverge": margin((1.05 if div_prev else 1.0) * se, sd),
           "reset_filter": margin(se, 19.95 * sd),
           "st_near_set": both(margin(de, 0.98), margin(xd, 0.9)),
           "st_near_reset": either(margin(0.95, de), margin(0.8, xd)),
           "xd_avg_min": both(margin(0.75, xd),
                              margin(float(prev["xd_avg_min"][s, 0]), xd)),
           "new_min": both(margin(0.6, lo),
                           margin(float(prev["fb_local_min"][s, 0]), lo))}
    en = np.sort(p["en"])[::-1]
    if f_upd and en[0] > 0:     # an empty filter has no delay to pick
        out["delay_idx"] = margin(en[0], en[1])
    return out


# --------------------------------------------------------------- replays

def _port_blocks(parent: dict, ins, dtype, probes: bool):
    """The port's `_block_math` over the package's five blocks from
    `parent`: per block (state numpy, probe)."""
    import torch
    from wmix_tpu_torch.engine import aec_package as ap
    block_math = getattr(ap._block_math, "__wrapped__", ap._block_math)
    c = {k: v.to(dtype) for k, v in ap._mats_on("cpu").items()}
    st = {k: torch.from_numpy(v.copy()) for k, v in parent.items()}
    st = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in st.items()}
    near, xr, xi, xwr, xwi, rand, flags = ins
    res = []
    for b in range(BLOCKS):
        probe = {} if probes else None
        st, _ = block_math(
            c, st, near[:, b * 64:(b + 1) * 64].to(dtype),
            xr[:, b].to(dtype), xi[:, b].to(dtype), xwr[:, b].to(dtype),
            xwi[:, b].to(dtype), rand[b:b + 1], flags[b, 0] != 0,
            flags[b, 1] != 0, flags[b, 2] != 0, 2, 2, probe=probe)
        res.append(({k: v.numpy() for k, v in st.items()}, probe))
    return res


@functools.lru_cache(maxsize=1)
def _wmix_blocks_fn():
    """`wmix_tpu`'s block math over five blocks, compiled as one XLA
    program of its own (without the chain's callback), returning every
    block's state."""
    import jax
    import jax.numpy as jnp
    from wmix_tpu.engine import aec_pallas
    block_math = getattr(aec_pallas._block_math, "__wrapped__",
                         aec_pallas._block_math)

    consts = {k: jnp.asarray(v) for k, v in aec_pallas._dft_mats().items()}

    def fn(st, near, xr, xi, xwr, xwi, rand, flags):
        states = []
        for b in range(BLOCKS):
            st, _ = block_math(
                consts, st, near[:, b * 64:(b + 1) * 64], xr[:, b],
                xi[:, b], xwr[:, b], xwi[:, b], rand[b:b + 1],
                flags[b, 0] != 0, flags[b, 1] != 0, flags[b, 2] != 0, 2, 2)
            states.append(dict(st))
        return states
    return jax.jit(fn)


# the plain-JAX chain's exact-layout leaves under the kernel layout's names
PLAIN_LEAVES = dict(delay_idx="delay_idx", diverge="diverge_state",
                    echo="echo_state", st_near="st_near_state",
                    new_min="h_nl_new_min", min_ctr="h_nl_min_ctr",
                    fb_min="h_nl_fb_min", fb_local_min="h_nl_fb_local_min",
                    xd_avg_min="h_nl_xd_avg_min", over_drive="over_drive",
                    over_drive_sm="over_drive_sm")


@functools.lru_cache(maxsize=1)
def _plain_block_fn():
    """One block of `wmix_tpu`'s plain-JAX fast path over the batch, as its
    package body runs it (`aec_step.build_pkg_body`'s `vblock`)."""
    import jax
    from wmix_tpu.dsp.aec import process_block_kernel

    def fn(dev, xf, xfw, near, rand, pos, f0, f1, upd):
        return jax.vmap(lambda d, a, b, c: process_block_kernel(
            d, a, b, c, rand, pos, 2, 2, f0, f1, upd))(dev, xf, xfw, near)
    return jax.jit(fn)


def _plain_blocks(before, ins):
    """`wmix_tpu`'s plain-JAX blocks of the package from its exact-layout
    state, with the port's block inputs: per block (leaves, None)."""
    import jax.numpy as jnp
    dev, dyn = before
    near, xr, xi, xwr, xwi, _rand, _flags = (t.numpy() for t in ins)
    res = []
    for b in range(BLOCKS):
        dev, _ = _plain_block_fn()(
            dev, jnp.asarray(np.concatenate([xr[:, b], xi[:, b]], 1)),
            jnp.asarray(np.concatenate([xwr[:, b], xwi[:, b]], 1)),
            jnp.asarray(near[:, b * 64:(b + 1) * 64]),
            jnp.asarray(dyn["blk_rand"][b]), jnp.int32(dyn["blk_xf"][b]),
            *(jnp.asarray(dyn["blk_flags"][b, j] != 0) for j in range(3)))
        res.append(({k: np.asarray(getattr(dev, v)).reshape(-1, 1)
                     for k, v in PLAIN_LEAVES.items()}, None))
    return res


def _wmix_blocks(parent: dict, ins):
    import jax.numpy as jnp
    st = {k: jnp.asarray(v) for k, v in parent.items()}
    outs = _wmix_blocks_fn()(st, *(jnp.asarray(t.numpy()) for t in ins))
    return [({k: np.asarray(v) for k, v in s.items()}, None) for s in outs]


def _card_package(parent: dict, ins) -> dict:
    """The parent state through the kernel once (the card's package)."""
    import torch
    from wmix_tpu_torch.engine import aec_package as ap
    st = {k: torch.from_numpy(v.copy()).cuda() for k, v in parent.items()}
    st, _ = ap.package_step(st, *(t.cuda().contiguous() for t in ins))
    return {k: v.cpu().numpy() for k, v in st.items()}


def _chain_blocks(side: str, chain_blocks: dict, forms: dict):
    """Per block {leaf: [B]}: the decision leaves `side`'s own chain took
    in the package (the plain chain's from its replay), or None."""
    if chain_blocks.get(side) is not None:
        return chain_blocks[side]
    if side == "plain" and "wmix_plain_form" in forms:
        return [{k: st[k].reshape(len(st[k]), -1)[:, 0] for k in INT_LEAVES}
                for st, _ in forms["wmix_plain_form"]]
    return None


def replay(pair, parent: dict, ins, streams, pkg: int,
           chain_states: dict, chain_blocks: dict,
           plain_before=None) -> dict:
    """The package `pkg` again from the second side's `parent`, block by
    block, in each form; per stream the decision leaves after every block,
    the float64 margins of its decisions, the first block where the
    forms' decision leaves part (integer leaves unequal, or a scalar float
    leaf beyond rel 1e-4), with the leaves that part there, and the first
    block where the two chains' own decision leaves part, with that
    block's margins."""
    import torch
    forms = {"port_f32": _port_blocks(parent, ins, torch.float32, False)}
    f64 = _port_blocks(parent, ins, torch.float64, True)
    forms["f64"] = f64
    if "pallas" in pair:
        forms["wmix_tpu_form"] = _wmix_blocks(parent, ins)
    if "plain" in pair and plain_before is not None:
        forms["wmix_plain_form"] = _plain_blocks(plain_before, ins)
    card_pkg = _card_package(parent, ins) if "card" in pair else None
    flags = ins[6].numpy()
    out = {}
    for s in streams:
        blocks = []
        first = None
        prev = parent
        for blk in range(BLOCKS):
            leaves = {nm: {k: float(st[blk][0][k][s].ravel()[0])
                           for k in INT_LEAVES + SCALAR_F}
                      for nm, st in forms.items()}
            ref = leaves["f64"]
            parting = sorted(
                {k for nm in forms for k in INT_LEAVES
                 if leaves[nm][k] != ref[k]} |
                {k for nm in forms for k in SCALAR_F
                 if abs(leaves[nm][k] - ref[k]) >
                 SCALAR_REL * max(abs(ref[k]), 1e-30)})
            if first is None and parting:
                first = {"block": pkg * BLOCKS + blk, "leaves": parting}
            blocks.append({
                "block": pkg * BLOCKS + blk,
                "update_delay_idx": bool(flags[blk, 2]),
                "leaves": leaves,
                "decisions_f64": decisions(f64[blk][1], prev, s,
                                           bool(flags[blk, 2]))})
            prev = f64[blk][0]
        closest = min(((abs(m["margin_ulps"]), k, blk["block"], m)
                       for blk in blocks
                       for k, m in blk["decisions_f64"].items()),
                      key=lambda t: t[0])
        sides = [_chain_blocks(x, chain_blocks, forms) for x in pair]
        chains = None
        for blk in range(BLOCKS if None not in sides else 0):
            a, b = (x[blk] for x in sides)
            parted = [k for k in INT_LEAVES if a[k][s] != b[k][s]]
            if parted:
                chains = {"block": pkg * BLOCKS + blk,
                          "values": {k: [int(a[k][s]), int(b[k][s])]
                                     for k in parted},
                          "margins_ulps": {
                              k: m["margin_ulps"] for k, m in
                              blocks[blk]["decisions_f64"].items()}}
                break
        ev = {"first_block_where_chains_part": chains,
              "first_block_where_forms_part": first,
              "closest_decision": {"decision": closest[1],
                                   "block": closest[2],
                                   "margin_ulps": closest[3]["margin_ulps"]},
              "blocks": blocks}
        # whether each form gives its chain's decision leaves after the
        # package, from this parent
        repro = {}
        for side in pair:
            st = chain_states.get(side)
            form = {"pallas": "wmix_tpu_form", "port": "port_f32",
                    "plain": "wmix_plain_form"}.get(side)
            if st is None:
                continue
            if side == "card":
                got = card_pkg
            elif form in forms:
                got = forms[form][-1][0]
            else:
                continue
            repro[side] = all(got[k][s].ravel()[0] == st[k][s].ravel()[0]
                              for k in INT_LEAVES)
        ev["form_reproduces_chain_decisions"] = repro
        if card_pkg is not None:
            ev["card_kernel_vs_port_f32_from_parent"] = {
                k: [float(card_pkg[k][s].ravel()[0]),
                    float(forms["port_f32"][-1][0][k][s].ravel()[0])]
                for k in INT_LEAVES + SCALAR_F}
        out[int(s)] = ev
    return out


# --------------------------------------------------------------- the run

def run(sides, batch: int, n_pkgs: int, from_pkg: int = 0,
        log=print) -> dict:
    """The lockstep run; packages before `from_pkg` run and are not
    compared."""
    if any(s in JAX_SIDES for s in sides):
        _jax_setup()
    from wmix_tpu_torch import parity as tp
    chains = [Side(nm, batch) for nm in sides]
    _capture_port_inputs(chains)
    plays, mics, meta = tp.build_streams(batch, n_pkgs * PKG, FREQ)
    mk = np.ascontiguousarray(np.transpose(
        mics.reshape(batch, n_pkgs, PKG), (1, 0, 2)))
    pk = np.ascontiguousarray(np.transpose(
        plays.reshape(batch, n_pkgs, PKG), (1, 0, 2)))
    pairs = [(a, b) for a, b in (("pallas", "plain"), ("port", "plain"),
                                 ("port", "pallas"), ("card", "port"))
             if a in sides and b in sides]
    streams = range(batch)
    n_win = -(-(n_pkgs - from_pkg) // WINDOW_PKGS)
    rep = {f"{a}-{b}": {
        "per_stream_max_lsb": [0] * batch,
        "window_max_lsb": [0] * n_win,
        # per stream: runs of packages past 1 LSB [first, last, max LSB]
        # (a gap of under 5 packages joins two runs) and the packages
        # where integer leaves start to part, with their values (a, b)
        "streams": {s: {"episodes": [], "decision_onsets": []}
                    for s in streams},
        "events": {}} for a, b in pairs}
    was_parted = {p: np.zeros(batch, bool) for p in rep}
    parents = {nm: None for nm in sides}
    t0 = time.time()
    for i in range(n_pkgs):
        outs = {c.name: c.step(mk[i], pk[i]) for c in chains}
        if i < from_pkg - 1:
            continue
        states = {c.name: c.state() for c in chains}
        if i < from_pkg:
            parents = states
            continue
        ins = next((c.inputs for c in chains if c.name == "port"), None)
        if ins is None:
            ins = next((c.inputs for c in chains if c.name == "card"), None)
        for a, b in pairs:
            key = f"{a}-{b}"
            r = rep[key]
            err = np.abs(outs[a].astype(np.int64) - outs[b]).max(axis=1)
            w = (i - from_pkg) // WINDOW_PKGS
            r["window_max_lsb"][w] = max(r["window_max_lsb"][w],
                                         int(err.max()))
            r["per_stream_max_lsb"] = [max(int(x), int(y)) for x, y in
                                       zip(r["per_stream_max_lsb"], err)]
            starts = []
            for s in streams:
                ep = r["streams"][s]["episodes"]
                if err[s] <= 1:
                    continue
                if ep and i - ep[-1][1] < 5:
                    ep[-1][1] = i
                    ep[-1][2] = max(ep[-1][2], int(err[s]))
                else:
                    ep.append([i, i, int(err[s])])
                    starts.append(s)
            if states[a] is None or states[b] is None:
                continue
            parted, _rel = leaf_parting(states[a], states[b])
            now = np.zeros(batch, bool)
            for k in INT_LEAVES:
                now |= parted[k]
            onset = [s for s in streams if now[s] and not was_parted[key][s]]
            was_parted[key] = now
            for s in onset:
                r["streams"][s]["decision_onsets"].append([i, {
                    k: [float(states[a][k][s].ravel()[0]),
                        float(states[b][k][s].ravel()[0])]
                    for k in INT_LEAVES if parted[k][s]}])
            # replay where a decision leaf starts to part, and where an
            # output parts past 1 LSB with no decision leaf parted (a
            # decision that parts and rejoins inside the package)
            todo = sorted(set(onset) | {s for s in starts if not now[s]})
            if todo and parents[b] is not None and ins is not None:
                plain = next((c.before for c in chains
                              if c.name == "plain"), None)
                ev = replay((a, b), parents[b], ins, todo, i, states,
                            {c.name: c.blocks for c in chains}, plain)
                if parents[a] is not None:
                    # how far the two chains had drifted before the package
                    _p, prel = leaf_parting(parents[a], parents[b])
                    for s in todo:
                        ev[s]["parents_rel"] = {
                            k: float(v[s]) for k, v in prel.items()
                            if k not in INT_LEAVES}
                r["events"][i] = {"package": i, "streams": todo,
                                  "parent_side": b, "by_stream": ev}
                for s in onset:
                    r["streams"][s]["decision_onsets"][-1].append(
                        ev[s]["first_block_where_chains_part"])
        parents = states
        if (i + 1) % 50 == 0:
            log(f"package {i + 1}/{n_pkgs}: {time.time() - t0:.1f} s; " +
                ", ".join(f"{p} max {max(r['per_stream_max_lsb'])}"
                          for p, r in rep.items()))
    return {"tool": "tools/aec_parting.py", "sides": list(sides),
            "batch": batch, "packages": n_pkgs, "from_package": from_pkg,
            "window_packages": WINDOW_PKGS, "scenes": meta,
            "pairs": rep, "seconds": round(time.time() - t0, 1)}


def summary(doc: dict) -> dict:
    """Per pair and stream past 1 LSB: each run of packages past 1 LSB
    with the last decision onset at or before its start (package, leaves,
    the first block where the two chains part and its decisions' float64
    margins)."""
    out = {}
    for p, r in doc["pairs"].items():
        rows = {}
        for s, e in r["streams"].items():
            if not e["episodes"]:
                continue
            rows[s] = []
            for first, last, mx in e["episodes"]:
                cause = [o for o in e["decision_onsets"] if o[0] <= first]
                c = cause[-1] if cause else None
                ev = next((r["events"][q]["by_stream"][s]
                           for q in ((c[0],) if c else ()) + (first,)
                           if q in r["events"] and
                           s in r["events"][q]["by_stream"]), None)
                rows[s].append({
                    "packages": [first, last], "max_lsb": mx,
                    "onset_pkg": c[0] if c else None,
                    "onset_leaves": sorted(c[1]) if c else None,
                    "onset_block": c[2]["block"] if c and len(c) > 2 and
                    c[2] else None,
                    "onset_margins_ulps": c[2]["margins_ulps"] if c and
                    len(c) > 2 and c[2] else None,
                    "closest_decision": ev and ev["closest_decision"]})
        out[p] = {"max_lsb": max(r["per_stream_max_lsb"]),
                  "window_max_lsb": r["window_max_lsb"],
                  "streams_over_1_lsb": rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sides", default="pallas,plain,port")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--from-s", type=float, default=0.0,
                    help="compare from this second on")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    sides = args.sides.split(",")
    per_s = FREQ // PKG
    doc = run(sides, args.batch, int(round(args.seconds * per_s)),
              from_pkg=int(round(args.from_s * per_s)),
              log=lambda m: print(m, file=sys.stderr, flush=True))
    if "card" in sides:
        from wmix_tpu_torch.parity import card_name
        doc["card"] = card_name()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, default=str)
    line = {"summary": summary(doc), "out": args.out, "sides": sides,
            "batch": args.batch, "seconds": args.seconds,
            "from_s": args.from_s, "card": doc.get("card")}
    print(json.dumps(line, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
