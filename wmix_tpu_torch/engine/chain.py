"""Batched record-path chain: NS -> AEC -> AGC -> VAD -> shm outputs.

Port of `wmix_tpu/engine/chain.py`: the daemon's per-package record
heartbeat (`wmix_shmem_write_circle`, src/wmix.c:528-872) over B stream
slots,

  mic package --NS--> --AEC(far = play delayed ~400 ms)--> --AGC-->
  --VAD (progressive mute)--> origin package  +  1x8000 zoomed package

The AEC far end comes from the playPkgBuff FIFO quirk (src/wmix.c:487-526
and the call order at :1461-1466): `playPkgBuff_add` runs before the
record chain each tick, and `playPkgBuff_get(400)` with the 22-slot FIFO
returns the package from 21 ticks ago, except every 22nd tick, when it
returns the package added this tick.  The FIFO is a [B, 22, pkg] device
ring written in place; the slot index is host-mirrored.

PyTorch runs eagerly, so `run_chunk` is a loop over its K packages: the
host plans each package; until the plan is steady the AEC runs in the
exact ring layout (`aec_step`); at the first steady package its state
converts once to the kernel layout, and from then on every package is one
`aec_package.package_step` (the CUDA kernel on a GPU, its plain version on
the CPU).  The kernel serves what the reference's package kernel serves:
steady 16 kHz plans of 20 ms packages in fast mode, mono or stereo (the
AEC sees the left channel).  At 8 kHz and in exact mode the AEC stays in
the ring layout.

Geometries, as the reference's: 8, 16 or 32 kHz (the AEC only up to
16 kHz), one or two interleaved channels, `interval_ms` packages and an
`aec_interval_ms` echo-path delay.  The planner plans 20 ms of AEC per
tick whatever `interval_ms` is, so a chain of another package length runs
with the AEC off only (the reference takes it with the AEC on and returns
packages of twice the length; the port raises).  The
arithmetic mode (`floatops`) is read when the chain is built and kept on
it.

The integer backends: `ns_backend="nsx"` runs the fixed-point noise
suppressor (`dsp/nsx.py`) in place of the float one, and
`aec_backend="aecm"` the mobile echo canceller (`engine/aecm_step.py`) in
place of the float AEC, int16-valued int32 in and out, in the ring layout
of its own planner; the AGC and VAD are fixed-point already, so a chain
with both integer backends is integer end to end and its result does not
depend on the arithmetic mode.

`ShardedRecordChain` splits one batch into `RecordChain` shards by slot
range, each on a device of its own or all on one; the shards take turns
on the host (`utils/turns.py`), so that no shard's device read holds up
the others' work.

`WMIX_TRACE_STEPS=1` when the chain is built gives it a `StepTimer`
(`step_timer`) that times every `run_chunk` against its K packages of
audio; on the card the step ends with a synchronize, so that it times the
work and not its launches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp import agc as agc_mod
from wmix_tpu_torch.dsp import ns as ns_mod
from wmix_tpu_torch.dsp import nsx as nsx_mod
from wmix_tpu_torch.dsp import vad as vad_mod
from wmix_tpu_torch.dsp.aec import AecDev
from wmix_tpu_torch.dsp.floatops import fast_mode
from wmix_tpu_torch.engine import aec_package, aec_step, aecm_step
from wmix_tpu_torch.engine.aec_plan import AecPlanner
from wmix_tpu_torch.ops import stepper
from wmix_tpu_torch.utils import trace
from wmix_tpu_torch.utils.turns import take_turns

F32 = torch.float32
I32 = torch.int32

AEC_INTERVALMS = 400      # platform/alsa/plat.h:19; FIFO of 400/20+2 = 22


class ChainState(NamedTuple):
    ns: object                # NsState, or NsxState with ns_backend="nsx"
    aec: object               # AecEngState, or PackageAecState once steady;
                              # AecmEngState with aec_backend="aecm"
    agc: agc_mod.AgcState
    vad: vad_mod.VadState
    play_fifo: torch.Tensor   # [B, 22, pkg_len * chn] f32 (int16-valued)


class RecordChain:
    """B concurrent streams of the daemon record chain.

    The parameters are the reference's, in its order.  Enable flags mirror
    wmix->webrtcEnable[]; the AGC gain mirrors wmix->volumeAgc (default 5,
    src/wmix.c:1596); `aec_interval_ms` is the platform's echo-path delay
    (alsa 400 ms).  `device` defaults to the card (None means "cuda");
    without a CUDA device that raises, and the CPU is used only when asked
    for."""

    def __init__(self, batch: int, freq: int, interval_ms: int = 20,
                 ns_enable: bool = True, aec_enable: bool = True,
                 agc_enable: bool = True, vad_enable: bool = True,
                 agc_gain_db: int = 5,
                 part_cap: int = aec_step.DEFAULT_PART_CAP,
                 aec_backend: str = "aec", chn: int = 1,
                 ns_backend: str = "ns",
                 aec_interval_ms: int = AEC_INTERVALMS, device=None):
        # the daemon's module rate guards (src/wmix.c:615-699): AEC only
        # to 16 kHz; NS/AGC/VAD to 32 kHz
        if freq > 16000:
            aec_enable = False
        if freq % 8000 or not 0 < freq <= 32000:
            raise ValueError("freq must be 8000, 16000, 24000 or 32000")
        if chn not in (1, 2):
            raise ValueError("chn must be 1 or 2")
        if aec_backend not in ("aec", "aecm") or \
                ns_backend not in ("ns", "nsx"):
            raise ValueError("aec_backend is 'aec' or 'aecm', ns_backend "
                             "'ns' or 'nsx'")
        if aec_enable and interval_ms != 20:
            # the planner plans 20 ms of AEC per tick; the reference takes
            # such a chain and returns packages of the wrong length
            raise ValueError("the AEC needs 20 ms packages: pass "
                             "aec_enable=False with another interval_ms")
        self.device = resolve_device(device)
        self.fast = fast_mode()       # the mode, kept for the chain's life
        self.batch = batch
        self.freq = freq
        self.chn = chn
        self.interval_ms = interval_ms
        # frames per package; an interleaved package is pkg_len * chn long
        self.pkg_len = freq // 1000 * interval_ms
        self.flags = (ns_enable, aec_enable, agc_enable, vad_enable)
        self.agc_gain_db = agc_gain_db
        self.part_cap = part_cap
        self.aec_backend = aec_backend if aec_enable else "aec"
        self.ns_backend = ns_backend if ns_enable else "ns"
        self.aec_interval_ms = aec_interval_ms
        self.fifo_pkgs = aec_interval_ms // interval_ms + 2
        if not aec_enable:
            self.planner = None
        elif self.aec_backend == "aecm":
            self.planner = aecm_step.AecmPlanner(freq)
        else:
            self.planner = AecPlanner(freq)
        self.sub_len = freq // 1000 * (20 if freq <= 8000 else 10)
        self.play_count = 0   # _playPkgBuff_count mirror
        self.tick = 0
        self.state = self._init_state(batch)
        # AEC output samples that were NaN or inf before the int16 cast
        # (which maps NaN to 0, as the reference's cast does); a device
        # count, read only by whoever wants it
        self.aec_nonfinite = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        self.step_timer = trace.StepTimer() if trace.steps_enabled() \
            else None
        # zoom to the 1x8000 shared-memory ring: a fixed gather per package
        # (wmix.c:846-848).  For chn=2 it takes the LEFT channel
        # (wmix_pcm_zoom mode 0x21, src/wmix.c:205-212): frame index ->
        # interleaved offset.  8 kHz mono needs none.
        if freq != 8000 or chn != 1:
            self.zoom_idx = torch.as_tensor(
                stepper.zoom_src_index(freq, 8000, self.pkg_len) * chn,
                device=self.device)
        else:
            self.zoom_idx = None

    @property
    def n8k(self) -> int:
        """Samples of the 1x8000 output package."""
        if self.zoom_idx is None:
            return self.pkg_len
        return int(self.zoom_idx.shape[0])

    def _init_state(self, batch: int) -> ChainState:
        dev = self.device
        ns_init = nsx_mod.init_state if self.ns_backend == "nsx" else \
            ns_mod.init_state
        return ChainState(
            ns=ns_init(batch, self.freq, dev),
            aec=(aecm_step.init_eng_state(batch, self.freq, dev)
                 if self.aec_backend == "aecm" else
                 aec_step.init_eng_state(batch, self.part_cap, dev)),
            agc=agc_mod.init_state(batch, dev),
            vad=vad_mod.init_state(batch, dev),
            play_fifo=torch.zeros(
                (batch, self.fifo_pkgs, self.pkg_len * self.chn),
                dtype=F32, device=dev))

    def reset_slots(self, slots) -> None:
        """Reinitialize the DSP state of the given stream slots (stream
        admission/reaping).  The host planner phase is batch-shared, so a
        reset slot joins at the current cursor phase with fresh adaptive
        state."""
        idx = torch.as_tensor(np.atleast_1d(np.asarray(slots, np.int64)),
                              device=self.device)
        fresh = self._init_state(len(idx))
        if isinstance(self.state.aec, aec_package.PackageAecState):
            fresh = fresh._replace(aec=aec_package.init_chain_aec(
                len(idx), self.part_cap, self.device))

        def put(cur, new):
            cur[idx] = new      # in place, slot rows only
        _tree_zip(put, self.state, fresh)

    def _ensure_aec_layout(self, want_kernel: bool, dyn) -> None:
        aec = self.state.aec
        if want_kernel and isinstance(aec, aec_step.AecEngState):
            self.state = self.state._replace(
                aec=aec_package.convert_chain_aec(aec, dyn))
        elif not want_kernel and \
                isinstance(aec, aec_package.PackageAecState):
            raise RuntimeError(
                "kernel-layout AEC state cannot serve a non-steady plan; "
                "16 kHz plans stay steady after startup so this indicates "
                "planner state corruption (or a kernel-layout snapshot "
                "restored into an exact-mode chain)")

    def _plan_tick(self):
        """Host bookkeeping for one tick: FIFO slots + AEC plan."""
        n = self.fifo_pkgs
        add_slot = self.play_count
        self.play_count = (self.play_count + 1) % n
        c = self.play_count
        g = c - self.aec_interval_ms // self.interval_ms
        g = min(max(g, 0), n)
        g = c - g
        if g >= n:
            g -= n
        elif g < 0:
            g += n
        if self.planner is None:
            sig, dyn = (), {}
        elif self.aec_backend == "aecm":
            plan = self.planner.plan_pkg()
            sig = plan.signature()
            dyn = aecm_step.pack_dyn(plan)
        else:
            plan = self.planner.plan_pkg()
            sig = plan.signature()
            dyn = aec_step.pack_dyn(plan, self.part_cap)
        self.tick += 1
        return add_slot, g, sig, dyn

    def _on_device(self, x) -> torch.Tensor:
        """`x` as a tensor on the chain's device.  A tensor already there
        is taken as it is (no copy); a pinned host tensor is sent without
        blocking the host, so the caller must leave it alone until the
        copy has run (an event recorded after the call says when); numpy
        and pageable host tensors take a blocking copy."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return torch.as_tensor(x, device=self.device)

    def step(self, mic_pkg, play_pkg):
        """One tick.  mic_pkg / play_pkg: [B, pkg_len * chn] int16,
        interleaved (mic capture and the mixed output package written to
        the speaker this tick), as numpy arrays or tensors (see
        `_on_device`).  Returns (origin int16 [B, pkg_len * chn], pkg_8k
        int16 [B, n8k], vad_flags int32 [B]) as tensors on the chain's
        device."""
        mic = self._on_device(mic_pkg)
        play = self._on_device(play_pkg)
        add_slot, get_slot, sig, dyn = self._plan_tick()
        steady = self._prepare_aec(sig, dyn)
        self.state, origin, pkg8k, vflags = self._package(
            self.state, mic, play, add_slot, get_slot, sig, dyn, steady)
        return origin, pkg8k, vflags

    def _prepare_aec(self, sig, dyn) -> bool:
        """Whether the package of plan (sig, dyn) runs the kernel, with the
        AEC state put in the layout that package needs."""
        if not (self.flags[1] and self.aec_backend == "aec"):
            return False
        # the package kernel serves steady 16 kHz fast-mode plans, as the
        # reference's does
        steady = self.fast and self.freq == 16000 and \
            aec_package.is_steady_16k(sig) and aec_package.is_steady_dyn(dyn)
        self._ensure_aec_layout(steady, dyn)
        return steady

    def run_chunk(self, mic_chunk, play_chunk):
        """K packages: mic_chunk / play_chunk [K, B, pkg_len * chn] int16.
        Returns (origin [K, B, pkg_len * chn] int16, pkg8k [K, B, n8k]
        int16, vad_flags [K, B] int32)."""
        if self.step_timer is None:
            return self._run_chunk(mic_chunk, play_chunk)
        self.step_timer.budget_ms = mic_chunk.shape[0] * self.interval_ms
        with self.step_timer.step():
            outs = self._run_chunk(mic_chunk, play_chunk)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return outs

    def _run_chunk(self, mic_chunk, play_chunk):
        mic_chunk = self._on_device(mic_chunk)
        play_chunk = self._on_device(play_chunk)
        outs = [self.step(mic_chunk[k], play_chunk[k])
                for k in range(mic_chunk.shape[0])]
        return tuple(torch.stack([o[j] for o in outs]) for j in range(3))

    def _package(self, st: ChainState, mic, play, add_slot: int,
                 get_slot: int, sig, dyn, steady: bool):
        """The chain body for one package (wmix_tpu chain.py:524-573)."""
        ns_on, aec_on, agc_on, vad_on = self.flags
        chn, exact = self.chn, not self.fast
        x = mic.to(I32)
        ns_st, aec_st, agc_st, vad_st = st.ns, st.aec, st.agc, st.vad
        if ns_on and self.ns_backend == "nsx":
            ns_st, x = nsx_mod.process_pkg(ns_st, x, chn, self.freq)
        elif ns_on:
            ns_st, x = ns_mod.process_pkg(ns_st, x, chn, self.freq, exact)

        # in place: this tick's FIFO slot
        st.play_fifo[:, add_slot] = play.to(F32)
        if aec_on and self.aec_backend == "aecm":
            # the AECM path is integer end to end: int16-valued int32 in
            # and out (the wrapper's AECM branch has no float stage); the
            # stereo quirk as below
            body = aecm_step.build_pkg_body(sig, self.sub_len,
                                            self.planner.mult)
            far = st.play_fifo[:, get_slot, ::chn].to(I32)
            aec_st, x = body(aec_st, far, x[:, ::chn], dyn)
            if chn > 1:
                x = x.repeat_interleave(chn, dim=1)
        elif aec_on:
            # aec_process2 stereo quirk: the LEFT channel only goes in
            # and the output is duplicated to every channel
            # (src/webrtc.c:410-483)
            far = st.play_fifo[:, get_slot, ::chn]
            near = x[:, ::chn]
            mult, nlp_mode = self.planner.mult, self.planner.nlp_mode
            if steady:
                body = aec_package.build_chain_aec_body(
                    sig, self.sub_len, mult, nlp_mode)
            else:
                body = aec_step.build_pkg_body(sig, self.sub_len, mult,
                                               nlp_mode, exact)
            aec_st, out_f = body(aec_st, far, near.to(F32), dyn)
            self.aec_nonfinite += (~torch.isfinite(out_f)).sum()
            x = aec_step.cast_out_int16(out_f)
            if chn > 1:
                x = x.repeat_interleave(chn, dim=1)

        if agc_on:
            agc_st, x = agc_mod.process_pkg(agc_st, x, chn, self.freq,
                                            self.agc_gain_db)
        vflags = torch.zeros((x.shape[0],), dtype=I32, device=x.device)
        if vad_on:
            # without interval_ms, as the reference calls it: the wrapper's
            # subpackage is 20 ms up to 16 kHz, so a shorter package passes
            # through with the flags unchanged
            vad_st, x = vad_mod.process(vad_st, x, chn, self.freq)
            vflags = vad_st.reduce

        origin = x.to(torch.int16)
        pkg8k = origin if self.zoom_idx is None else \
            origin[:, self.zoom_idx]
        return (ChainState(ns_st, aec_st, agc_st, vad_st, st.play_fifo),
                origin, pkg8k, vflags)


class ShardedRecordChain:
    """N `RecordChain` shards serving one [B] stream batch, shard i over
    the slots [i * B / N, (i + 1) * B / N) on `devices[i]` (wmix_tpu
    chain.py:405-466, where it keeps each program under the TPU compile
    helper's size; here it is how one batch spans several devices).  Each
    shard has its own planner, and they advance in lockstep: every call
    ticks all of them, so every shard runs the same plan signature.
    `devices=None` puts every shard on the default device (the card).
    `**kw` are `RecordChain`'s keywords, so every backend, geometry and
    mode it takes is taken.

    Inputs are sliced by slot range and moved to each shard's device as
    `RecordChain` takes them (numpy arrays, pinned host tensors, tensors
    on the shard's device; a tensor on another device is copied), in the
    caller's thread and on its current streams.  The shards then run on
    the caller's current stream of their devices, taking turns on the host
    (`utils.turns.take_turns`): a chain reads its device in the middle of
    a package (the AGC limiter's loop condition, exact NS's window
    countdown), and a shard hands the turn on before each such read, so
    every shard's work up to its next read is issued before any shard
    waits on its device.  The outputs come back concatenated on
    `devices[0]`."""

    def __init__(self, batch: int, freq: int, shards: int = 2,
                 devices=None, **kw):
        if shards < 1 or batch % shards:
            raise ValueError(f"batch {batch} does not split into {shards} "
                             "equal shards")
        if devices is None:
            devices = [None] * shards
        if len(devices) != shards:
            raise ValueError(f"{len(devices)} devices for {shards} shards")
        self.batch = batch
        self.freq = freq
        self.shard_b = batch // shards
        self.chains = [RecordChain(self.shard_b, freq, **kw, device=d)
                       for d in devices]
        self.device = self.chains[0].device
        self.planner = self.chains[0].planner

    @property
    def state(self) -> list:
        """The shards' `ChainState`s, in slot order."""
        return [ch.state for ch in self.chains]

    def shard_ranges(self):
        """(chain, lo, hi) of every shard: its slots are [lo, hi)."""
        for i, ch in enumerate(self.chains):
            yield ch, i * self.shard_b, (i + 1) * self.shard_b

    def _plan_tick(self):
        out = None
        for ch in self.chains:
            out = ch._plan_tick()
        return out

    def reset_slots(self, slots) -> None:
        """`RecordChain.reset_slots` of the batch's slots, each passed to
        its shard."""
        s = np.atleast_1d(np.asarray(slots, np.int64))
        for ch, lo, hi in self.shard_ranges():
            mine = s[(s >= lo) & (s < hi)] - lo
            if mine.size:
                ch.reset_slots(mine)

    def _run(self, method: str, mic, play, dim: int):
        """`method` of every shard on its slot range of `mic` and `play`
        (sliced along `dim`), as the class docstring says; the outputs
        concatenated along `dim` on `devices[0]`."""
        def call(fn, m, p, stream):
            if stream is None:
                return lambda: fn(m, p)

            def on_stream():
                with torch.cuda.stream(stream):
                    return fn(m, p)
            return on_stream
        calls = []
        for ch, lo, hi in self.shard_ranges():
            sl = (slice(None),) * dim + (slice(lo, hi),)
            stream = torch.cuda.current_stream(ch.device) \
                if ch.device.type == "cuda" else None
            calls.append(call(getattr(ch, method), ch._on_device(mic[sl]),
                              ch._on_device(play[sl]), stream))
        outs = take_turns(calls)
        return tuple(torch.cat([o[j].to(self.device) for o in outs], dim)
                     for j in range(3))

    def run_chunk(self, mic_chunk, play_chunk):
        """K packages over the whole batch: [K, B, pkg_len * chn] in, the
        outputs of `RecordChain.run_chunk` over B out."""
        return self._run("run_chunk", mic_chunk, play_chunk, 1)

    def step(self, mic_pkg, play_pkg):
        """One tick over the whole batch ([B, pkg_len * chn] in), as
        `RecordChain.step`."""
        return self._run("step", mic_pkg, play_pkg, 0)


# ------------------------------------------------- state carried across

def _tree_zip(fn, a, b) -> None:
    """Apply fn(leaf_a, leaf_b) over two states of the same structure."""
    if isinstance(a, torch.Tensor):
        fn(a, b)
    elif isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        for x, y in zip(a, b):
            _tree_zip(fn, x, y)


def _leaf(x, device) -> torch.Tensor:
    """float -> float32, uint32 -> int64 (the port's uint32 carrier), other
    integers -> int32."""
    arr = np.array(x)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.astype(np.int64)).to(device)
    t = torch.from_numpy(arr)
    t = t.to(F32) if t.is_floating_point() else t.to(I32)
    return t.to(device)


def _tuple_from(cls, tree, device):
    return cls(**{f: _leaf(getattr(tree, f), device) for f in cls._fields})


def state_from_numpy(tree, device=None) -> ChainState:
    """A `wmix_tpu` ChainState, given as a tree of numpy arrays (its
    NamedTuples with numpy leaves), as the port's state on `device`.
    Fields match by name, so every geometry and both arithmetic modes are
    taken (the leaves' shapes carry the geometry; the mode changes no
    leaf); so are both AEC layouts (the exact-layout AecEngState and the
    kernel layout with its state dict), the AECM state and the NSX state
    (whose uint32 leaves become the port's int64)."""
    device = resolve_device(device)
    aec = tree.aec
    if hasattr(aec, "core"):
        port_aec = aecm_step.AecmEngState(
            core={k: _leaf(v, device) for k, v in aec.core.items()},
            **{f: _leaf(getattr(aec, f), device)
               for f in aecm_step.AecmEngState._fields if f != "core"})
    elif hasattr(aec, "dev"):
        port_aec = aec_step.AecEngState(
            dev=_tuple_from(AecDev, aec.dev, device),
            **{f: _leaf(getattr(aec, f), device)
               for f in aec_step.AecEngState._fields if f != "dev"})
    else:
        port_aec = aec_package.PackageAecState(
            far_pre=_leaf(aec.far_pre, device),
            far_parts=_leaf(aec.far_parts, device),
            farw_parts=_leaf(aec.farw_parts, device),
            p={k: _leaf(aec.p[k], device)
               for k in aec_package.STATE_FIELDS})
    return ChainState(
        ns=_tuple_from(nsx_mod.NsxState if hasattr(tree.ns, "min_norm")
                       else ns_mod.NsState, tree.ns, device),
        aec=port_aec,
        agc=_tuple_from(agc_mod.AgcState, tree.agc, device),
        vad=_tuple_from(vad_mod.VadState, tree.vad, device),
        play_fifo=_leaf(tree.play_fifo, device))


def state_to_numpy(state):
    """The port's state as the same structure with numpy leaves."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    return type(state)(*(state_to_numpy(v) for v in state))
