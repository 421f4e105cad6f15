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
the CPU).

Geometry: 16 kHz mono, 20 ms packages, fast mode.  Other geometries and exact
mode raise; the AECM/NSX backends are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from wmix_tpu_torch.device import resolve_device
from wmix_tpu_torch.dsp import agc as agc_mod
from wmix_tpu_torch.dsp import ns as ns_mod
from wmix_tpu_torch.dsp import vad as vad_mod
from wmix_tpu_torch.dsp.aec import AecDev
from wmix_tpu_torch.dsp.floatops import check_fast_mode
from wmix_tpu_torch.engine import aec_package, aec_step
from wmix_tpu_torch.engine.aec_plan import AecPlanner
from wmix_tpu_torch.ops import stepper

F32 = torch.float32
I32 = torch.int32

INTERVAL_MS = 20          # package length
AEC_INTERVALMS = 400      # platform/alsa/plat.h:19; FIFO of 400/20+2 = 22


class ChainState(NamedTuple):
    ns: ns_mod.NsState
    aec: object               # AecEngState, or PackageAecState once steady
    agc: agc_mod.AgcState
    vad: vad_mod.VadState
    play_fifo: torch.Tensor   # [B, 22, pkg_len] f32 (int16-valued)


class RecordChain:
    """B concurrent streams of the daemon record chain (16 kHz mono).

    Enable flags mirror wmix->webrtcEnable[]; the AGC gain mirrors
    wmix->volumeAgc (default 5, src/wmix.c:1596).  `device` defaults to
    the card (None means "cuda"); without a CUDA device that raises, and
    the CPU is used only when asked for."""

    def __init__(self, batch: int, freq: int, ns_enable: bool = True,
                 aec_enable: bool = True, agc_enable: bool = True,
                 vad_enable: bool = True, agc_gain_db: int = 5, chn: int = 1,
                 device=None):
        check_fast_mode()
        if freq != 16000 or chn != 1:
            raise NotImplementedError(
                "wmix_tpu_torch RecordChain: 16 kHz mono only")
        self.device = resolve_device(device)
        self.batch = batch
        self.freq = freq
        self.chn = chn
        self.pkg_len = freq // 1000 * INTERVAL_MS
        self.flags = (ns_enable, aec_enable, agc_enable, vad_enable)
        self.agc_gain_db = agc_gain_db
        self.part_cap = aec_step.DEFAULT_PART_CAP
        self.fifo_pkgs = AEC_INTERVALMS // INTERVAL_MS + 2
        self.planner = AecPlanner(freq) if aec_enable else None
        self.sub_len = freq // 1000 * 10
        self.play_count = 0   # _playPkgBuff_count mirror
        self.tick = 0
        self.state = self._init_state(batch)
        # AEC output samples that were NaN or inf before the int16 cast
        # (which maps NaN to 0, as the reference's cast does); a device
        # count, read only by whoever wants it
        self.aec_nonfinite = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        # zoom to the 1x8000 shared-memory ring: a fixed gather per package
        # (wmix.c:846-848)
        self.zoom_idx = torch.as_tensor(
            stepper.zoom_src_index(freq, 8000, self.pkg_len),
            device=self.device)

    def _init_state(self, batch: int) -> ChainState:
        dev = self.device
        return ChainState(
            ns=ns_mod.init_state(batch, self.freq, dev),
            aec=aec_step.init_eng_state(batch, self.part_cap, dev),
            agc=agc_mod.init_state(batch, dev),
            vad=vad_mod.init_state(batch, dev),
            play_fifo=torch.zeros((batch, self.fifo_pkgs, self.pkg_len),
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
                "planner state corruption")

    def _plan_tick(self):
        """Host bookkeeping for one tick: FIFO slots + AEC plan."""
        n = self.fifo_pkgs
        add_slot = self.play_count
        self.play_count = (self.play_count + 1) % n
        c = self.play_count
        g = c - AEC_INTERVALMS // INTERVAL_MS
        g = min(max(g, 0), n)
        g = c - g
        if g >= n:
            g -= n
        elif g < 0:
            g += n
        if self.planner is None:
            sig, dyn = (), {}
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
        """One 20 ms tick.  mic_pkg / play_pkg: [B, pkg_len] int16 (mic
        capture and the mixed output package written to the speaker this
        tick), as numpy arrays or tensors (see `_on_device`).  Returns
        (origin int16 [B, pkg_len], pkg_8k int16 [B, n8k], vad_flags int32
        [B]) as tensors on the chain's device."""
        mic = self._on_device(mic_pkg)
        play = self._on_device(play_pkg)
        add_slot, get_slot, sig, dyn = self._plan_tick()
        steady = False
        if self.flags[1]:
            steady = aec_package.is_steady_16k(sig) and \
                aec_package.is_steady_dyn(dyn)
            self._ensure_aec_layout(steady, dyn)
        self.state, origin, pkg8k, vflags = self._package(
            self.state, mic, play, add_slot, get_slot, sig, dyn, steady)
        return origin, pkg8k, vflags

    def run_chunk(self, mic_chunk, play_chunk):
        """K packages: mic_chunk / play_chunk [K, B, pkg_len] int16.
        Returns (origin [K, B, pkg_len] int16, pkg8k [K, B, n8k] int16,
        vad_flags [K, B] int32)."""
        mic_chunk = self._on_device(mic_chunk)
        play_chunk = self._on_device(play_chunk)
        outs = [self.step(mic_chunk[k], play_chunk[k])
                for k in range(mic_chunk.shape[0])]
        return tuple(torch.stack([o[j] for o in outs]) for j in range(3))

    def _package(self, st: ChainState, mic, play, add_slot: int,
                 get_slot: int, sig, dyn, steady: bool):
        """The chain body for one package (wmix_tpu chain.py:524-573)."""
        ns_on, aec_on, agc_on, vad_on = self.flags
        x = mic.to(I32)
        ns_st, aec_st, agc_st, vad_st = st.ns, st.aec, st.agc, st.vad
        if ns_on:
            ns_st, x = ns_mod.process_pkg(ns_st, x, self.chn, self.freq)

        # in place: this tick's FIFO slot
        st.play_fifo[:, add_slot] = play.to(F32)
        if aec_on:
            far = st.play_fifo[:, get_slot]
            mult, nlp_mode = self.planner.mult, self.planner.nlp_mode
            if steady:
                body = aec_package.build_chain_aec_body(
                    sig, self.sub_len, mult, nlp_mode)
            else:
                body = aec_step.build_pkg_body(sig, self.sub_len, mult,
                                               nlp_mode)
            aec_st, out_f = body(aec_st, far, x.to(F32), dyn)
            self.aec_nonfinite += (~torch.isfinite(out_f)).sum()
            x = aec_step.cast_out_int16(out_f)

        if agc_on:
            agc_st, x = agc_mod.process_pkg(agc_st, x, self.chn, self.freq,
                                            self.agc_gain_db)
        vflags = torch.zeros((x.shape[0],), dtype=I32, device=x.device)
        if vad_on:
            vad_st, x = vad_mod.process(vad_st, x, self.chn, self.freq)
            vflags = vad_st.reduce

        origin = x.to(torch.int16)
        pkg8k = origin[:, self.zoom_idx]
        return (ChainState(ns_st, aec_st, agc_st, vad_st, st.play_fifo),
                origin, pkg8k, vflags)


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
    arr = np.array(x)
    t = torch.from_numpy(arr)
    t = t.to(F32) if t.is_floating_point() else t.to(I32)
    return t.to(device)


def _tuple_from(cls, tree, device):
    return cls(**{f: _leaf(getattr(tree, f), device) for f in cls._fields})


def state_from_numpy(tree, device=None) -> ChainState:
    """A `wmix_tpu` ChainState, given as a tree of numpy arrays (its
    NamedTuples with numpy leaves), as the port's state on `device`.
    Fields match by name; both AEC layouts (the exact-layout AecEngState
    and the kernel layout with its state dict) are taken."""
    device = resolve_device(device)
    aec = tree.aec
    if hasattr(aec, "dev"):
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
        ns=_tuple_from(ns_mod.NsState, tree.ns, device),
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
