"""Host-side AEC package planner for the batched engine.

Every buffer-pointer / counter decision in the reference AEC
(echo_cancellation.c ProcessNormal, aec_core.c WebRtcAec_ProcessFrames,
common_audio/ring_buffer.c) is data-independent, and in the daemon every
stream slot follows the same call pattern (one package per 20 ms tick,
reported delay 0).  So the cursor state machine is *shared* across the
whole batch: this planner advances it once per package and emits a
``PkgPlan`` — a static structure (how many partition extractions, which
frames run how many blocks, which subpackages are still in startup
passthrough) plus dynamic scalars (ring positions, xfBuf cursor, gate
flags, comfort-noise randoms).  The device steps (engine/aec_step.py,
engine/aec_package.py) replay the plan over the whole batch, with no
host ring bookkeeping on the data path.

Cursor semantics mirror wmix_tpu/dsp/aec.py (`_Ring`, `AecCoreHost`,
`Aec`), which in turn mirror the C sources.

A copy of `wmix_tpu/engine/aec_plan.py` apart from its imports (that
module pulls jax in through its package); tests/test_torch_aec.py holds
the two equal, plan by plan.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from wbench.reference.dsp.aec import (
    BUF_SIZE_PARTITIONS,
    FAR_PRE_BUF_SIZE,
    FRAME_LEN,
    MAX_BUF_SIZE_START,
    NUM_PARTITIONS,
    PART_LEN,
    PART_LEN2,
    SAMP_MS_NB,
    _c_short,
    _idiv,
    _rand_u_array,
)

NEAR_FR_SIZE = FRAME_LEN + PART_LEN  # 144, aec_core.c nearFrBuf/outFrBuf


class _AbsRing:
    """ring_buffer.c cursor arithmetic with absolute (monotone) positions.

    Equivalent to the wrapped read_pos/write_pos/rw_wrap encoding because
    every clamp in the C code depends only on available_read/write, which
    are position differences.  Data slots are ``abs_pos % count``."""

    def __init__(self, count: int):
        self.count = count
        self.r = 0
        self.w = 0

    def available_read(self) -> int:
        return self.w - self.r

    def available_write(self) -> int:
        return self.count - (self.w - self.r)

    def write(self, n: int) -> Tuple[int, int]:
        n = min(n, self.available_write())
        start = self.w
        self.w += n
        return start, n

    def read(self, n: int) -> Tuple[int, int]:
        n = min(n, self.available_read())
        start = self.r
        self.r += n
        return start, n

    def move_read(self, n: int) -> int:
        n = min(n, self.available_read())
        n = max(n, -self.available_write())
        self.r += n
        return n


class BlockOp(NamedTuple):
    far_slot: int          # absolute partition index into far_buf storage
    near_start: int        # abs sample start of the 64-sample near read
    out_start: int         # abs sample start of the 64-sample output write
    xf_pos: int            # xfBufBlockPos for this block
    noise_sel_init: int
    noise_gate_open: int
    update_delay_idx: int
    rand: np.ndarray       # [PART_LEN] comfort-noise uniforms (int32)


class FrameOp(NamedTuple):
    near_write: int        # abs start of the 80-sample near_fr write
    blocks: Tuple[BlockOp, ...]
    out_read: int          # abs start of the 80-sample out_fr read


class SubPlan(NamedTuple):
    pre_write: int                       # abs start of the far subpkg write
    extractions: Tuple[Tuple[int, int], ...]  # (pre_read_start, part_slot)
    startup: bool                        # passthrough Process call?
    frames: Tuple[FrameOp, ...]          # empty when startup


class PkgPlan(NamedTuple):
    subs: Tuple[SubPlan, ...]

    def signature(self):
        """Static structure: keys the jit cache.  update_delay_idx is
        static (it fires one block in 10*mult — baking it into the
        signature lets XLA dead-code-eliminate the 12x65 partition-energy
        folds from every other block; the position cycles through a
        handful of per-package patterns, bounding the variant count)."""
        return tuple(
            (len(s.extractions), s.startup,
             tuple(tuple((len(f.blocks), b.update_delay_idx)
                         for b in f.blocks) for f in s.frames))
            for s in self.subs)


class AecPlanner:
    """Cursor mirror of Aec + AecCoreHost (dsp/aec.py), emitting plans."""

    def __init__(self, samp_freq: int, nlp_mode: int = 2):
        self.samp_freq = samp_freq
        self.mult = samp_freq // 8000 if samp_freq <= 16000 else 2
        self.nlp_mode = nlp_mode
        self.rate_factor = self.mult
        # AecCoreHost cursors
        self.far_buf = _AbsRing(BUF_SIZE_PARTITIONS)   # covers far_wbuf too
        self.near_fr = _AbsRing(NEAR_FR_SIZE)
        self.out_fr = _AbsRing(NEAR_FR_SIZE)
        self.system_delay = 0
        self.core_known_delay = 0
        self.xf_pos = 0
        self.noise_est_ctr = 0
        self.delay_est_ctr = 0
        self.seed = 777
        # Aec wrapper state (echo_cancellation.c)
        self.far_pre = _AbsRing(FAR_PRE_BUF_SIZE)
        self.far_pre.move_read(-PART_LEN)
        self.sum = 0
        self.counter = 0
        self.check_buff_size = True
        self.first_val = 0
        self.startup_phase = 1
        self.buf_size_start = 0
        self.check_buf_size_ctr = 0
        self.ms_in_snd_card_buf = 0
        self.filt_delay = -1
        self.time_for_delay_change = 0
        self.known_delay = 0
        self.last_delay_diff = 0

    # -- BufferFarend (echo_cancellation.c:278-339) --
    def _plan_buffer_farend(self, n: int):
        self.system_delay += n
        pre_write, wrote = self.far_pre.write(n)
        assert wrote == n, "far_pre overflow (engine assumes daemon pacing)"
        extractions = []
        while self.far_pre.available_read() >= PART_LEN2:
            pre_read, _ = self.far_pre.read(PART_LEN2)
            extractions.append((pre_read, self._partition_write()))
            self.far_pre.move_read(-PART_LEN)
        return pre_write, tuple(extractions)

    def _partition_write(self) -> int:
        """WebRtcAec_BufferFarendPartition (aec_core.c:1690-1707)."""
        if self.far_buf.available_write() < 1:
            self._move_far_read_ptr(1)
        slot, wrote = self.far_buf.write(1)
        assert wrote == 1
        return slot

    def _move_far_read_ptr(self, elements: int) -> int:
        moved = self.far_buf.move_read(elements)
        self.system_delay -= moved * PART_LEN
        return moved

    # -- Process -> ProcessNormal (echo_cancellation.c:341-747) --
    def _plan_process(self, num_samples: int):
        """Returns (startup: bool, frames) for one Process call."""
        # reported delay 0, +10 ms margin (echo_cancellation.c:616)
        self.ms_in_snd_card_buf = 10
        n_blocks_10ms = num_samples // (FRAME_LEN * self.rate_factor)

        if self.startup_phase:
            if self.check_buff_size:
                self.check_buf_size_ctr += 1
                if self.counter == 0:
                    self.first_val = self.ms_in_snd_card_buf
                    self.sum = 0
                if abs(self.first_val - self.ms_in_snd_card_buf) < \
                        max(0.2 * self.ms_in_snd_card_buf, SAMP_MS_NB):
                    self.sum += self.ms_in_snd_card_buf
                    self.counter += 1
                else:
                    self.counter = 0
                if self.counter * n_blocks_10ms >= 6:
                    self.buf_size_start = min(
                        _idiv(3 * self.sum * self.rate_factor * 8,
                              4 * self.counter * PART_LEN),
                        MAX_BUF_SIZE_START)
                    self.check_buff_size = False
                if self.check_buf_size_ctr * n_blocks_10ms > 50:
                    self.buf_size_start = min(
                        _idiv(self.ms_in_snd_card_buf *
                              self.rate_factor * 3, 40),
                        MAX_BUF_SIZE_START)
                    self.check_buff_size = False
            if not self.check_buff_size:
                overhead = _idiv(self.system_delay, PART_LEN) - \
                    self.buf_size_start
                if overhead == 0:
                    self.startup_phase = 0
                elif overhead > 0:
                    self._move_far_read_ptr(overhead)
                    self.startup_phase = 0
            return True, ()

        self._est_buf_delay_normal()
        return False, self._plan_process_frames(num_samples)

    def _est_buf_delay_normal(self):
        n_samp_snd_card = self.ms_in_snd_card_buf * SAMP_MS_NB * \
            self.rate_factor
        current_delay = n_samp_snd_card - self.system_delay
        current_delay += FRAME_LEN * self.rate_factor
        if current_delay < PART_LEN:
            current_delay += self._move_far_read_ptr(1) * PART_LEN
        if self.filt_delay < 0:
            self.filt_delay = 0
        self.filt_delay = max(
            0, _c_short(0.8 * self.filt_delay + 0.2 * current_delay))
        delay_difference = self.filt_delay - self.known_delay
        if delay_difference > 224:
            if self.last_delay_diff < 96:
                self.time_for_delay_change = 0
            else:
                self.time_for_delay_change += 1
        elif delay_difference < 96 and self.known_delay > 0:
            if self.last_delay_diff > 224:
                self.time_for_delay_change = 0
            else:
                self.time_for_delay_change += 1
        else:
            self.time_for_delay_change = 0
        self.last_delay_diff = delay_difference
        if self.time_for_delay_change > 25:
            self.known_delay = max(int(self.filt_delay) - 160, 0)

    # -- WebRtcAec_ProcessFrames (aec_core.c:1719-1850) --
    def _plan_process_frames(self, num_samples: int) -> Tuple[FrameOp, ...]:
        frames = []
        for _ in range(num_samples // FRAME_LEN):
            near_write, wrote = self.near_fr.write(FRAME_LEN)
            assert wrote == FRAME_LEN

            if self.system_delay < FRAME_LEN:
                self._move_far_read_ptr(-(self.mult + 1))

            # 2a) compensate for system delay changes: the core's knownDelay
            # vs the wrapper's knownDelay passed into ProcessFrames
            move_elements = _idiv(self.core_known_delay - self.known_delay
                                  - 32, PART_LEN)
            moved = self.far_buf.move_read(move_elements)
            self.core_known_delay -= moved * PART_LEN

            blocks = []
            while self.near_fr.available_read() >= PART_LEN:
                blocks.append(self._plan_block())

            self.system_delay -= FRAME_LEN

            out_elements = self.out_fr.available_read()
            if out_elements < FRAME_LEN:
                self.out_fr.move_read(out_elements - FRAME_LEN)
            out_read, got = self.out_fr.read(FRAME_LEN)
            assert got == FRAME_LEN
            frames.append(FrameOp(near_write, tuple(blocks), out_read))
        return tuple(frames)

    def _plan_block(self) -> BlockOp:
        far_slot, got = self.far_buf.read(1)
        assert got == 1
        near_start, got = self.near_fr.read(PART_LEN)
        assert got == PART_LEN

        rand, self.seed = _rand_u_array(self.seed, PART_LEN)
        noise_gate_open = self.noise_est_ctr > 50
        noise_sel_init = self.noise_est_ctr < 500 * self.mult
        if noise_sel_init:
            self.noise_est_ctr += 1
        self.delay_est_ctr += 1
        if self.delay_est_ctr == 10 * self.mult:
            self.delay_est_ctr = 0
        update_delay_idx = self.delay_est_ctr == 0

        self.xf_pos = (self.xf_pos - 1) % NUM_PARTITIONS

        out_start, wrote = self.out_fr.write(PART_LEN)
        assert wrote == PART_LEN
        return BlockOp(far_slot, near_start, out_start, self.xf_pos,
                       int(noise_sel_init), int(noise_gate_open),
                       int(update_delay_idx),
                       np.asarray(rand, np.int32))

    # -- one daemon package: aec_process2 subpackage loop (webrtc.c) --
    def plan_pkg(self) -> PkgPlan:
        freq = self.samp_freq
        interval = 20 if freq <= 8000 else 10
        sub_frames = freq // 1000 * interval
        frame_num = freq // 1000 * 20
        return self.plan_subs(sub_frames, frame_num // sub_frames)

    def plan_subs(self, sub_frames: int, n_subs: int) -> PkgPlan:
        """`n_subs` BufferFarend + Process calls of `sub_frames` samples:
        `plan_pkg` is the 20 ms package of the record chain; the daemon's
        single-stream wrapper plans its own package length this way."""
        subs = []
        for _ in range(n_subs):
            pre_write, extractions = self._plan_buffer_farend(sub_frames)
            startup, frames = self._plan_process(sub_frames)
            subs.append(SubPlan(pre_write, extractions, startup, frames))
        return PkgPlan(tuple(subs))
