"""Batched AEC package step in the reference's exact ring layout.

Port of `wmix_tpu/engine/aec_step.py`: replays an `AecPlanner` plan over a
batch of stream slots.  Ring storage lives on the device as flat
per-stream tensors; positions are host ints from the plan.  The per-block
math is `dsp.aec.process_block_kernel`.  This path serves the AEC
start-up and the first irregular package of the record chain; steady
packages run the package kernel (`engine/aec_package.py`).

In place: ring writes and far-partition stores update the state tensors
they are given (the reference's functional updates would copy a
[B, part_cap, 130] store per extraction).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp.aec import (
    AecDev,
    FRAME_LEN,
    PART_LEN,
    PART_LEN1,
    PART_LEN2,
    init_dev,
    process_block_kernel,
    time_to_frequency_pair,
)
from wmix_tpu_torch.dsp.intops import wrap16
from wmix_tpu_torch.engine.aec_plan import (
    FAR_PRE_BUF_SIZE,
    NEAR_FR_SIZE,
    AecPlanner,
    PkgPlan,
)

F32 = torch.float32

DEFAULT_PART_CAP = 64   # device far-partition slots (see AecBatch._check)


class AecEngState(NamedTuple):
    dev: AecDev                # batched leaves [B, ...]
    far_parts: torch.Tensor    # [B, part_cap, 130] plain far spectra
    farw_parts: torch.Tensor   # [B, part_cap, 130] windowed far spectra
    far_pre: torch.Tensor      # [B, FAR_PRE_BUF_SIZE] time-domain far
    near_fr: torch.Tensor      # [B, NEAR_FR_SIZE]
    out_fr: torch.Tensor       # [B, NEAR_FR_SIZE]


def init_eng_state(batch: int, part_cap: int = DEFAULT_PART_CAP,
                   device=None) -> AecEngState:
    device = resolve_device(device)
    def z(*shape):
        return torch.zeros(shape, dtype=F32, device=device)
    return AecEngState(
        dev=init_dev(batch, device),
        far_parts=z(batch, part_cap, 2 * PART_LEN1),
        farw_parts=z(batch, part_cap, 2 * PART_LEN1),
        far_pre=z(batch, FAR_PRE_BUF_SIZE),
        near_fr=z(batch, NEAR_FR_SIZE),
        out_fr=z(batch, NEAR_FR_SIZE))


def _ring_idx(start: int, n: int, cap: int, device) -> torch.Tensor:
    return (int(start) + torch.arange(n, device=device)) % cap


def ring_read(buf, start: int, n: int):
    """buf[:, (start + t) % cap] for t < n."""
    return buf[:, _ring_idx(start, n, buf.shape[1], buf.device)]


def ring_write_(buf, start: int, data) -> None:
    """buf[:, (start + t) % cap] = data, in place."""
    buf[:, _ring_idx(start, data.shape[1], buf.shape[1], buf.device)] = data


def buffer_farend_(far_pre, far_parts, farw_parts, farsub, dyn, si: int,
                   ei: int, n_extr: int) -> int:
    """BufferFarend of one subpackage, in place: the far_pre ring write and
    the partition extractions into the far spectrum stores.  Returns the
    next extraction index."""
    ring_write_(far_pre, dyn["pre_writes"][si], farsub)
    for _ in range(n_extr):
        seg = ring_read(far_pre, dyn["extr_pre"][ei], PART_LEN2)
        xf, xfw = time_to_frequency_pair(seg)
        slot = int(dyn["extr_slots"][ei])
        far_parts[:, slot] = xf
        farw_parts[:, slot] = xfw
        ei += 1
    return ei


def build_pkg_body(signature, sub_len: int, mult: int, nlp_mode: int):
    """Returns fn(state, far_pkg [B, n] f32, near_pkg [B, n] f32, dyn) ->
    (state, out [B, n]) replaying one package plan of this signature.
    update_delay_idx comes from dyn (the reference's traced_upd form)."""

    def fn(st: AecEngState, far_pkg, near_pkg, dyn):
        ei = fi = bi = 0
        dev = st.dev
        outs = []
        for si, (n_extr, startup, blk_counts) in enumerate(signature):
            farsub = far_pkg[:, si * sub_len:(si + 1) * sub_len]
            nearsub = near_pkg[:, si * sub_len:(si + 1) * sub_len]
            ei = buffer_farend_(st.far_pre, st.far_parts, st.farw_parts,
                                farsub, dyn, si, ei, n_extr)
            if startup:
                outs.append(nearsub)
                continue
            sub_out = []
            for fj, blocks_sig in enumerate(blk_counts):
                ring_write_(st.near_fr, dyn["frame_near"][fi],
                            nearsub[:, fj * FRAME_LEN:(fj + 1) * FRAME_LEN])
                for _ in blocks_sig:
                    slot = int(dyn["blk_far"][bi])
                    flags = dyn["blk_flags"][bi]
                    dev, out64 = process_block_kernel(
                        dev, st.far_parts[:, slot], st.farw_parts[:, slot],
                        ring_read(st.near_fr, dyn["blk_near"][bi], PART_LEN),
                        dyn["blk_rand"][bi], int(dyn["blk_xf"][bi]),
                        mult, nlp_mode, bool(flags[0]), bool(flags[1]),
                        bool(flags[2]))
                    ring_write_(st.out_fr, dyn["blk_out"][bi], out64)
                    bi += 1
                sub_out.append(ring_read(st.out_fr, dyn["frame_out"][fi],
                                         FRAME_LEN))
                fi += 1
            outs.append(torch.cat(sub_out, dim=1))
        return st._replace(dev=dev), torch.cat(outs, dim=1)

    return fn


def pack_dyn(plan: PkgPlan, part_cap: int):
    """Plan -> dict of mod-reduced numpy arrays."""
    pre_writes, extr_pre, extr_slots = [], [], []
    frame_near, frame_out = [], []
    blk_far, blk_near, blk_out, blk_xf, blk_flags, blk_rand = \
        [], [], [], [], [], []
    for s in plan.subs:
        pre_writes.append(s.pre_write % FAR_PRE_BUF_SIZE)
        for pre_read, slot in s.extractions:
            extr_pre.append(pre_read % FAR_PRE_BUF_SIZE)
            extr_slots.append(slot % part_cap)
        for f in s.frames:
            frame_near.append(f.near_write % NEAR_FR_SIZE)
            frame_out.append(f.out_read % NEAR_FR_SIZE)
            for b in f.blocks:
                blk_far.append(b.far_slot % part_cap)
                blk_near.append(b.near_start % NEAR_FR_SIZE)
                blk_out.append(b.out_start % NEAR_FR_SIZE)
                blk_xf.append(b.xf_pos)
                blk_flags.append((b.noise_sel_init, b.noise_gate_open,
                                  b.update_delay_idx))
                blk_rand.append(b.rand)

    def a(x):
        return np.asarray(x, np.int32)
    return {
        "pre_writes": a(pre_writes),
        "extr_pre": a(extr_pre),
        "extr_slots": a(extr_slots),
        "frame_near": a(frame_near),
        "frame_out": a(frame_out),
        "blk_far": a(blk_far),
        "blk_near": a(blk_near),
        "blk_out": a(blk_out),
        "blk_xf": a(blk_xf),
        "blk_flags": a(blk_flags).reshape(-1, 3),
        "blk_rand": (np.stack(blk_rand).astype(np.int32)
                     if blk_rand else np.zeros((0, PART_LEN), np.int32)),
    }


class AecBatch:
    """Batched AEC over B stream slots: planner + device state (mono)."""

    def __init__(self, batch: int, freq: int,
                 part_cap: int = DEFAULT_PART_CAP, device=None):
        if freq != 16000:
            raise NotImplementedError("wmix_tpu_torch AEC: 16 kHz only")
        self.batch = batch
        self.freq = freq
        self.part_cap = part_cap
        self.sub_len = freq // 1000 * 10
        self.planner = AecPlanner(freq)
        self.state = init_eng_state(batch, part_cap, device)

    def _check(self) -> None:
        # the device far-partition store is smaller than the C ring (250):
        # valid while the live window fits in part_cap
        w = self.planner.far_buf.w
        r = self.planner.far_buf.r
        if w - (r - (self.planner.mult + 2)) > self.part_cap:
            raise RuntimeError("far partition window exceeded device "
                               "capacity; raise part_cap")

    def step(self, far_pkg, near_pkg):
        """One 20 ms package for the whole batch: [B, 320] float32
        (int16-valued) in, [B, 320] float32 AEC output out."""
        plan = self.planner.plan_pkg()
        self._check()
        fn = build_pkg_body(plan.signature(), self.sub_len,
                            self.planner.mult, self.planner.nlp_mode)
        self.state, out = fn(self.state, far_pkg.to(F32), near_pkg.to(F32),
                             pack_dyn(plan, self.part_cap))
        return out


def cast_out_int16(out_f32: torch.Tensor) -> torch.Tensor:
    """(int16_t) cast of the float output: truncate toward zero, NaN -> 0,
    wrap to int16; int32 holding the int16 values.  The AEC output is
    clipped to [-32768, 32767] before it, so only NaN can fall outside."""
    res = torch.where(torch.isnan(out_f32), 0.0, out_f32)
    return wrap16(torch.trunc(res).to(torch.int32))
