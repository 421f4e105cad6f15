"""Host planner and batched package step of the AECM backend
(`RecordChain(aec_backend="aecm")`).

Port of `wmix_tpu/engine/aecm_step.py`.  The AECM wrapper
(echo_control_mobile.c) and the core's frame and block scheduling
(aecm_core.c ProcessFrame) depend only on the call pattern, one package
per 20 ms tick with a reported delay of 0, so one `AecmPlanner` per stream
batch advances the cursors on the host and emits a plan per package: a
signature (start-up pass-through, far-frame underruns, blocks per frame)
and the offsets (ring positions, far-history slots, start-up counters,
comfort-noise draws).  `build_pkg_body` replays a plan over B streams;
everything that depends on the data is `dsp/aecm.process_block`.

Rings: the wrapper's farendBuf (50 frames), the core's far delay buffer
(256), the far and near block queues and the output ring are [B, cap]
int32 tensors written in place at host-planned positions mod their
capacity, so the C's MoveReadPtr stuffing falls out of the representation.

Reference: echo_control_mobile.c Process/BufferFarend, aecm_core.c
ProcessFrame/BufferFarFrame/FetchFarFrame; wired by the daemon at
src/webrtc.c:172-191 (aec_process2, AECM branch).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp import aecm
from wmix_tpu_torch.dsp._aecm_tables import (BUF_SIZE_FRAMES, FAR_BUF_LEN,
                                             FRAME_LEN, K_SAMP_MS_NB,
                                             MAX_DELAY, PART_LEN)
from wmix_tpu_torch.dsp.aec import _rand_u_array
from wmix_tpu_torch.engine.aec_plan import _AbsRing
from wmix_tpu_torch.engine.aec_step import (ring_read, ring_write_,
                                            sub_len_of)

I32 = torch.int32

WRAP_BUF = BUF_SIZE_FRAMES * FRAME_LEN    # 4000, the wrapper's farendBuf
QUEUE_BUF = 256                           # far and near block queues
OUT_BUF = FRAME_LEN + PART_LEN            # 144


class BlockPlan(NamedTuple):
    q_read: int
    out_write: int
    hist_pos: int
    tot_count: int
    noise_lt100: int
    rand: np.ndarray          # [64] int32


class FramePlan(NamedTuple):
    use_old: int              # underrun: reuse far_end_old[slot]
    slot: int                 # 0 or 1 within the process call
    far_read: int             # wrapper ring read position (if not use_old)
    cfar_write: int           # core far_buf write position
    cfar_read: int            # core far_buf read position
    q_write: int              # queue write position (far and near)
    near_off: int             # near offset within the package
    blocks: Tuple[BlockPlan, ...]
    out_read: int


class SubPlan(NamedTuple):
    far_write: int            # wrapper ring write position
    far_off: int              # far offset within the package
    startup: bool
    frames: Tuple[FramePlan, ...]


class AecmPkgPlan(NamedTuple):
    subs: Tuple[SubPlan, ...]

    def signature(self):
        return tuple(
            (s.startup,
             tuple((f.use_old, f.slot, len(f.blocks)) for f in s.frames))
            for s in self.subs)


class AecmPlanner:
    """Counter mirror of the AECM wrapper's and core's scheduling, one
    shared instance per stream batch."""

    def __init__(self, samp_freq: int):
        if samp_freq not in (8000, 16000):
            raise ValueError("AECM supports 8000/16000 only")
        self.freq = samp_freq
        self.mult = samp_freq // 8000
        # wrapper (echo_control_mobile.c)
        self.farend = _AbsRing(WRAP_BUF)
        self.ec_startup = 1
        self.check_buff_size = 1
        self.check_buf_size_ctr = 0
        self.counter = 0
        self.sum = 0
        self.first_val = 0
        self.buf_size_start = 0
        self.filt_delay = 0
        self.known_delay = 0
        self.last_delay_diff = 0
        self.time_for_delay_change = 0
        self.ms_in_snd_card_buf = 0
        # core (aecm_core.c)
        self.core_known_delay = 0
        self.last_known_delay = 0
        self.cfar_w = 0                # core far_buf write position
        self.cfar_r = 0                # core far_buf read position
        self.queue = _AbsRing(QUEUE_BUF)
        self.out_ring = _AbsRing(OUT_BUF)
        self.far_history_pos = MAX_DELAY
        self.tot_count = 0
        self.noise_est_ctr = 0
        self.seed = 666

    # -- wrapper -------------------------------------------------------

    def _delay_comp(self):
        n_samp_far = self.farend.available_read()
        n_samp_snd = self.ms_in_snd_card_buf * K_SAMP_MS_NB * self.mult
        if n_samp_snd - n_samp_far > FAR_BUF_LEN - FRAME_LEN * self.mult:
            n_add = max((n_samp_snd >> 1) - n_samp_far, FRAME_LEN)
            self.farend.move_read(-min(n_add, 10 * FRAME_LEN))

    def _est_buf_delay(self):
        n_samp_far = self.farend.available_read()
        n_samp_snd = self.ms_in_snd_card_buf * K_SAMP_MS_NB * self.mult
        delay_new = n_samp_snd - n_samp_far
        if delay_new < FRAME_LEN:
            self.farend.move_read(FRAME_LEN)
            delay_new += FRAME_LEN
        t = 8 * self.filt_delay + 2 * delay_new
        t = -((-t) // 10) if t < 0 else t // 10
        self.filt_delay = max(0, ((t + 0x8000) & 0xFFFF) - 0x8000)
        diff = self.filt_delay - self.known_delay
        if diff > 224:
            if self.last_delay_diff < 96:
                self.time_for_delay_change = 0
            else:
                self.time_for_delay_change += 1
        elif diff < 96 and self.known_delay > 0:
            if self.last_delay_diff > 224:
                self.time_for_delay_change = 0
            else:
                self.time_for_delay_change += 1
        else:
            self.time_for_delay_change = 0
        self.last_delay_diff = diff
        if self.time_for_delay_change > 25:
            self.known_delay = max(int(self.filt_delay) - 160, 0)
            self.core_known_delay = self.known_delay

    # -- core ----------------------------------------------------------

    def _plan_frame(self, slot: int, near_off: int) -> FramePlan:
        # the wrapper's far frame, or far_end_old on an underrun
        if self.farend.available_read() // FRAME_LEN > 0:
            far_read, got = self.farend.read(FRAME_LEN)
            assert got == FRAME_LEN
            use_old = 0
        else:
            far_read, use_old = 0, 1

        if (slot == 0 and self.freq == 8000) or \
                (slot == 1 and self.freq == 16000):
            self._est_buf_delay()

        # core.buffer_far_frame + fetch_far_frame
        cfar_write = self.cfar_w
        self.cfar_w += FRAME_LEN
        self.cfar_r -= self.core_known_delay - self.last_known_delay
        self.last_known_delay = self.core_known_delay
        cfar_read = self.cfar_r
        self.cfar_r += FRAME_LEN

        q_write, wrote = self.queue.write(FRAME_LEN)
        assert wrote == FRAME_LEN

        blocks = []
        while self.queue.available_read() >= PART_LEN:
            q_read, got = self.queue.read(PART_LEN)
            assert got == PART_LEN
            out_write, w = self.out_ring.write(PART_LEN)
            assert w == PART_LEN
            self.far_history_pos += 1
            if self.far_history_pos >= MAX_DELAY:
                self.far_history_pos = 0
            rand, seed2 = _rand_u_array(self.seed, PART_LEN)
            blocks.append(BlockPlan(
                q_read, out_write, self.far_history_pos, self.tot_count,
                int(self.noise_est_ctr < 100), np.asarray(rand, np.int32)))
            self.seed = seed2
            self.tot_count += 1
            if self.noise_est_ctr < 100:
                self.noise_est_ctr += 1

        avail = self.out_ring.available_read()
        if avail < FRAME_LEN:
            self.out_ring.move_read(avail - FRAME_LEN)
        out_read, got = self.out_ring.read(FRAME_LEN)
        assert got == FRAME_LEN
        return FramePlan(use_old, slot, far_read, cfar_write, cfar_read,
                         q_write, near_off, tuple(blocks), out_read)

    # -- one daemon package (aec_process2, AECM branch) ---------------

    def plan_pkg(self) -> AecmPkgPlan:
        freq = self.freq
        sub_len = freq // 1000 * (20 if freq <= 8000 else 10)
        pkg_len = freq // 1000 * 20
        return self.plan_subs(sub_len, pkg_len // sub_len)

    def plan_subs(self, sub_len: int, n_subs: int) -> AecmPkgPlan:
        """`n_subs` BufferFarend + Process calls of `sub_len` samples
        (`plan_pkg`: the 20 ms package of the record chain)."""
        subs = []
        for off in range(0, n_subs * sub_len, sub_len):
            # BufferFarend (an overflow would drop samples; the daemon's
            # pacing never reaches it)
            if not self.ec_startup:
                self._delay_comp()
            far_write, _wrote = self.farend.write(sub_len)

            # Process
            self.ms_in_snd_card_buf = 10        # clamp(0) + 10
            n_frames = sub_len // FRAME_LEN
            n_blocks_10ms = n_frames // self.mult
            if self.ec_startup:
                n_filled = self.farend.available_read() // FRAME_LEN
                if self.check_buff_size:
                    self.check_buf_size_ctr += 1
                    if self.counter == 0:
                        self.first_val = self.ms_in_snd_card_buf
                        self.sum = 0
                    if abs(self.first_val - self.ms_in_snd_card_buf) < \
                            max(0.2 * self.ms_in_snd_card_buf,
                                K_SAMP_MS_NB):
                        self.sum += self.ms_in_snd_card_buf
                        self.counter += 1
                    else:
                        self.counter = 0
                    if self.counter * n_blocks_10ms >= 6:
                        self.buf_size_start = min(
                            (3 * self.sum * self.mult) //
                            (self.counter * 40), BUF_SIZE_FRAMES)
                        self.check_buff_size = 0
                    if self.check_buf_size_ctr * n_blocks_10ms > 50:
                        self.buf_size_start = min(
                            (3 * self.ms_in_snd_card_buf * self.mult)
                            // 40, BUF_SIZE_FRAMES)
                        self.check_buff_size = 0
                if not self.check_buff_size:
                    if n_filled == self.buf_size_start:
                        self.ec_startup = 0
                    elif n_filled > self.buf_size_start:
                        self.farend.move_read(
                            self.farend.available_read() -
                            self.buf_size_start * FRAME_LEN)
                        self.ec_startup = 0
                subs.append(SubPlan(far_write, off, True, ()))
            else:
                frames = tuple(
                    self._plan_frame(i, off + i * FRAME_LEN)
                    for i in range(n_frames))
                subs.append(SubPlan(far_write, off, False, frames))
        return AecmPkgPlan(tuple(subs))


def pack_dyn(plan: AecmPkgPlan) -> dict:
    """The plan's offsets, stacked per plan site, as numpy arrays (the
    reference's layout)."""
    frames = [f for s in plan.subs for f in s.frames]
    blocks = [b for f in frames for b in f.blocks]

    def a(x):
        return np.asarray(x, np.int32)
    return {
        "far_writes": a([s.far_write for s in plan.subs]),
        "f_far_read": a([f.far_read for f in frames]),
        "f_cfar_w": a([f.cfar_write for f in frames]),
        "f_cfar_r": a([f.cfar_read for f in frames]),
        "f_q_w": a([f.q_write for f in frames]),
        "f_out_r": a([f.out_read for f in frames]),
        "b_q_r": a([b.q_read for b in blocks]),
        "b_out_w": a([b.out_write for b in blocks]),
        "b_hist": a([b.hist_pos for b in blocks]),
        "b_tot": a([b.tot_count for b in blocks]),
        "b_noise": a([b.noise_lt100 for b in blocks]),
        "b_rand": (np.stack([b.rand for b in blocks]) if blocks
                   else np.zeros((0, PART_LEN), np.int32)),
    }


class AecmEngState(NamedTuple):
    """Device state of the batched AECM backend; every leaf [B, ...]
    int32.  Fields in the reference's order."""
    core: dict                 # dsp.aecm.make_init_state leaves
    farend: torch.Tensor       # [B, 4000] the wrapper's ring
    far_old: torch.Tensor      # [B, 2, 80] farendOld
    cfar: torch.Tensor         # [B, 256] the core's far delay buffer
    qfar: torch.Tensor         # [B, 256]
    qnear: torch.Tensor        # [B, 256]
    outr: torch.Tensor         # [B, 144]


def init_eng_state(batch: int, freq: int, device=None) -> AecmEngState:
    device = resolve_device(device)

    def z(*s):
        return torch.zeros((batch,) + s, dtype=I32, device=device)
    return AecmEngState(
        core=aecm.make_init_state(batch, freq, device),
        farend=z(WRAP_BUF), far_old=z(2, FRAME_LEN), cfar=z(FAR_BUF_LEN),
        qfar=z(QUEUE_BUF), qnear=z(QUEUE_BUF), outr=z(OUT_BUF))


def build_pkg_body(signature, sub_len: int, mult: int):
    """fn(AecmEngState, far_pkg [B, n] int32, near_pkg [B, n] int32, dyn)
    -> (state, out [B, n] int32), replaying one package plan of this
    signature; the rings are written in place."""

    def fn(st: AecmEngState, far_pkg, near_pkg, dyn):
        fi = bi = 0          # frame and block index across the package
        core = st.core
        dev = far_pkg.device
        b_rand = dyn["b_rand"]
        cos_sin = torch.as_tensor(
            np.stack([aecm.comfort_tables(r) for r in b_rand])
            if len(b_rand) else np.zeros((0, 2, PART_LEN), np.int32),
            device=dev)
        outs = []
        for si, (startup, frame_sigs) in enumerate(signature):
            far_sub = far_pkg[:, si * sub_len:(si + 1) * sub_len]
            near_sub = near_pkg[:, si * sub_len:(si + 1) * sub_len]
            ring_write_(st.farend, int(dyn["far_writes"][si]), far_sub)
            if startup:
                outs.append(near_sub)
                continue
            for use_old, slot, n_blocks in frame_sigs:
                near80 = near_sub[:, slot * FRAME_LEN:(slot + 1) * FRAME_LEN]
                if use_old:
                    far80 = st.far_old[:, slot]
                else:
                    far80 = ring_read(st.farend, int(dyn["f_far_read"][fi]),
                                      FRAME_LEN)
                    st.far_old[:, slot] = far80
                ring_write_(st.cfar, int(dyn["f_cfar_w"][fi]), far80)
                far_frame = ring_read(st.cfar, int(dyn["f_cfar_r"][fi]),
                                      FRAME_LEN)
                q_w = int(dyn["f_q_w"][fi])
                ring_write_(st.qfar, q_w, far_frame)
                ring_write_(st.qnear, q_w, near80)
                for _ in range(n_blocks):
                    q_r = int(dyn["b_q_r"][bi])
                    core, out64 = aecm.process_block(
                        core, ring_read(st.qfar, q_r, PART_LEN),
                        ring_read(st.qnear, q_r, PART_LEN), cos_sin[bi],
                        int(dyn["b_hist"][bi]), int(dyn["b_tot"][bi]),
                        bool(dyn["b_noise"][bi]), mult)
                    ring_write_(st.outr, int(dyn["b_out_w"][bi]), out64)
                    bi += 1
                outs.append(ring_read(st.outr, int(dyn["f_out_r"][fi]),
                                      FRAME_LEN))
                fi += 1
        return st._replace(core=core), torch.cat(outs, 1)

    return fn


class AecmBatch:
    """Batched AECM: B concurrent streams of the daemon's aec_process2
    (AECM branch), mono (the wrapper's left-channel-only stereo is the
    caller's reshape), one `interval_ms` package per step."""

    def __init__(self, batch: int, freq: int, device=None,
                 interval_ms: int = 20):
        self.batch = batch
        self.freq = freq
        self.planner = AecmPlanner(freq)
        self.sub_len = sub_len_of(freq, interval_ms)
        self.pkg_len = freq // 1000 * interval_ms
        self.state = init_eng_state(batch, freq, device)

    def step(self, far_pkg, near_pkg):
        """One package: far/near [B, pkg] int16 values (numpy or tensors)
        -> out [B, pkg] int32 on the state's device."""
        plan = self.planner.plan_subs(self.sub_len,
                                      self.pkg_len // self.sub_len)
        fn = build_pkg_body(plan.signature(), self.sub_len,
                            self.planner.mult)
        dev = self.state.farend.device
        self.state, out = fn(self.state,
                             torch.as_tensor(far_pkg, device=dev).to(I32),
                             torch.as_tensor(near_pkg, device=dev).to(I32),
                             pack_dyn(plan))
        return out
