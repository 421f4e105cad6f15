"""Reference outputs of `wmix_tpu`'s daemon record path and its float
single-stream processors, for the port's daemon tests.

    python tools/gen_torch_daemon_ref.py

runs, on the CPU under x64 with WMIX_EXACT=1 (about three CPU-minutes):

* the record DSP processors of `wmix_tpu`'s daemon, one stream each, on
  packages made from a seed (`proc_inputs`) at 8 and 16 kHz, mono and
  stereo: `service.core._NsProc`, `_AgcProc` (gain 5) and `_VadProc`
  (`N_PROC` packages), and `dsp.aec.AecProcessor` (`N_AEC` packages, of
  which the first three pass through its start-up), and the AEC again
  with 10 ms packages at 8 and 16 kHz mono (`AEC10_CASES`);
* `wmix_tpu.service.core.WmixDaemon` at 8 and 16 kHz mono with all four
  modules on and a consumer holding the record path open, fed a seeded
  microphone through `LoopHal` (`record_packages`): every package its
  heartbeat hands to the fan-out;

and writes `tests/data/torch_daemon_ref.npz`.  The reference compiles one
XLA program per processor and geometry and runs the AEC a block at a time
(about a second a package), which is too dear for the default tests.

tests/test_torch_processors.py and tests/test_torch_daemon.py hold the
port bit-equal to the file in exact mode, and a test there marked `slow`
calls `reference_outputs` again and compares it with the file.
`record_packages` takes either package, so the tests drive the port's
daemon with the same function.
"""
from __future__ import annotations

import importlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(REPO, "tests", "data", "torch_daemon_ref.npz")

PROC_CASES = [(8000, 1), (8000, 2), (16000, 1), (16000, 2)]
AEC10_CASES = [(8000, 1), (16000, 1)]
N_PROC = 6
N_AEC = 9
AGC_GAIN = 5
DAEMON_FREQS = (8000, 16000)
DAEMON_PUMPS = 6            # four packages a pump once the path is open
WR_ALL = (0, 1, 2, 4)       # WR_VAD, WR_AEC, WR_NS, WR_AGC


def proc_inputs(freq: int, chn: int, interval_ms: int = 20):
    """(mic, far) int16 [N_AEC, interval_ms * chn] of a processor case: a
    far end of noise, and a microphone that hears it 37 samples late at
    half level beside its own noise; interleaved."""
    rng = np.random.RandomState(freq // 1000 * 10 + chn + interval_ms)
    n = freq // 1000 * interval_ms
    far = rng.randn(N_AEC, n * chn) * 5000
    near = 0.5 * np.roll(far, 37 * chn, axis=1) + \
        rng.randn(N_AEC, n * chn) * 2000
    cast = lambda x: np.clip(np.round(x), -32768, 32767).astype(np.int16)  # noqa: E731
    return cast(near), cast(far)


def daemon_mic(freq: int) -> bytes:
    """Two seconds of seeded microphone noise (sigma 3000), mono int16."""
    rng = np.random.RandomState(freq)
    return (rng.randn(freq * 2) * 3000).astype(np.int16).tobytes()


def record_packages(package: str, freq: int, **daemon_kw) -> np.ndarray:
    """`package`'s WmixDaemon (`wmix_tpu` or `wmix_tpu_torch`) at `freq`
    mono with NS, AEC, AGC and VAD on, no message queue and no shared
    memory, `DAEMON_PUMPS` pumps over `daemon_mic`: the packages its
    record heartbeat fanned out, int16 [n, 20 ms]."""
    core = importlib.import_module(f"{package}.service.core")
    hal_mod = importlib.import_module(f"{package}.service.hal")
    config = importlib.import_module(f"{package}.config")
    hal = hal_mod.LoopHal()
    hal.feed_mic(daemon_mic(freq))
    d = core.WmixDaemon(config.EngineConfig(chn=1, freq=freq), hal=hal,
                        msg_queue=False, shmem=False, **daemon_kw)
    for i in WR_ALL:
        d.webrtc_enable[i] = 1
    d.shmem_run = 1             # a consumer holds the record path open
    got = []
    out = d._record_out
    d._record_out = lambda buf: (got.append(np.array(buf, np.int16)),
                                 out(buf))
    for _ in range(DAEMON_PUMPS):
        d.pump(1)
    d.stop()
    return np.stack(got)


def _setup_reference() -> None:
    os.environ["WMIX_EXACT"] = "1"
    os.environ.pop("WMIX_FAST", None)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_allow_excess_precision=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from wmix_tpu.dsp import floatops
    assert not floatops.fast_mode()


def reference_outputs() -> dict:
    """Every stored array, from `wmix_tpu`."""
    _setup_reference()
    from wmix_tpu.dsp import aec
    from wmix_tpu.service import core
    out = {}
    for freq, chn in PROC_CASES:
        mic, far = proc_inputs(freq, chn)
        for name, p in (("ns", core._NsProc(chn, freq)),
                        ("agc", core._AgcProc(chn, freq, AGC_GAIN)),
                        ("vad", core._VadProc(chn, freq, 20))):
            out[f"{name}_{freq}_{chn}"] = np.stack(
                [p.process(m) for m in mic[:N_PROC]])
        p = aec.AecProcessor(chn, freq, 20)
        out[f"aec_{freq}_{chn}"] = np.stack(
            [p.process2(f, m, 0) for f, m in zip(far, mic)])
    for freq, chn in AEC10_CASES:
        mic, far = proc_inputs(freq, chn, 10)
        p = aec.AecProcessor(chn, freq, 10)
        out[f"aec10_{freq}_{chn}"] = np.stack(
            [p.process2(f, m, 0) for f, m in zip(far, mic)])
    for freq in DAEMON_FREQS:
        out[f"daemon_{freq}"] = record_packages("wmix_tpu", freq)
    return out


def main() -> None:
    import time
    t0 = time.perf_counter()
    sys.path.insert(0, REPO)
    out = reference_outputs()
    np.savez_compressed(PATH, **out)
    print(f"{PATH}: {len(out)} arrays, {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
