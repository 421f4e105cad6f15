"""Aten operations and bytes of one frame of the port's device codec
halves, on the CPU: what an eager frame costs the card's host in launches
and the card in memory traffic.

    python tools/count_codec_ops.py

prints one JSON line per case, counted by
`wmix_tpu_torch.utils.trace.OpCounter` over one frame after a warm one:
`ops` (all aten operations), `launching` (those that are not views, about
one kernel launch each on the card; the count does not depend on B), and
the bytes those operations read and write, counted at two small batches
and extended to the full width of `chip_smoke.py` phase 14 (the bytes are
affine in B): `eager_bytes_full`.  `state_bytes_full` is the least a frame
must move at that width: its inputs read, its state read and written, its
output written.  Cases: `BatchedSynth` stereo frames (ns = 36) and mono
frames at B = 4096; `BatchedFilterbank` at 8192 slots, each window
sequence (0 long, 1 start, 2 eight short, 3 stop) over every slot, and
the mixed tick of phase 14 (three groups).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wmix_tpu_torch.codecs.aac_batch import BatchedFilterbank  # noqa: E402
from wmix_tpu_torch.codecs.mp3_batch import BatchedSynth  # noqa: E402
from wmix_tpu_torch.utils.trace import OpCounter  # noqa: E402

SYNTH_B, FB_SLOTS = 4096, 8192
SMALL = (8, 16)


def _count(run) -> dict:
    run()
    with OpCounter() as c:
        run()
    return {"ops": c.ops, "launching": c.launching, "bytes": c.bytes}


def _extend(make, full: int) -> dict:
    """Counts at the two SMALL widths, the bytes extended to `full`."""
    a, b = (_count(make(n)) for n in SMALL)
    per = (b["bytes"] - a["bytes"]) / (SMALL[1] - SMALL[0])
    return {"ops": b["ops"], "launching": b["launching"],
            "eager_bytes_full": int(a["bytes"] + per * (full - SMALL[0]))}


def synth_case(nch: int) -> dict:
    ns = 36

    def make(B):
        rng = np.random.RandomState(0)
        synth = BatchedSynth(B, device="cpu")
        sb = rng.randint(-(1 << 28), 1 << 28,
                         size=(B, 2, ns, 32)).astype(np.int32)
        sbt = torch.from_numpy(sb)
        return lambda: synth.frame(sbt, nch, ns)

    out = _extend(make, SYNTH_B)
    # sbsample in, hist and phase read and written, int16 PCM out
    out["state_bytes_full"] = SYNTH_B * (nch * ns * 32 * 4 +
                                         2 * (2 * 2 * 16 * 16 * 4 + 4) +
                                         nch * ns * 32 * 2)
    return {"case": f"synth_nch{nch}", "batch": SYNTH_B, **out}


def fb_case(name: str, groups) -> dict:
    """`groups`: (window sequence, shape, share of the slots)."""
    def make(S):
        rng = np.random.RandomState(1)
        fb = BatchedFilterbank(S, device="cpu")
        specs = torch.from_numpy(
            (rng.randn(S, 1024) * 50).astype(np.float32))
        cuts = np.cumsum([0] + [int(S * share) for _, _, share in groups])
        cuts[-1] = S

        def run():
            for (seq, shape, _), lo, hi in zip(groups, cuts[:-1], cuts[1:]):
                fb.frame_stacked(np.arange(lo, hi), seq, shape,
                                 specs[lo:hi])
        return run

    out = _extend(make, FB_SLOTS)
    # spectra in, overlap read and written, time_out written (float32)
    out["state_bytes_full"] = FB_SLOTS * 1024 * 4 * 4
    return {"case": name, "slots": FB_SLOTS, **out}


def main() -> None:
    torch.set_num_threads(2)
    cases = [synth_case(2), synth_case(1)]
    for seq, label in enumerate(["long", "start", "short", "stop"]):
        cases.append(fb_case(f"fb_{label}", [(seq, 0, 1.0)]))
    cases.append(fb_case("fb_mixed_tick",
                         [(0, 0, 0.5), (2, 1, 0.25), (3, 0, 0.25)]))
    for c in cases:
        print(json.dumps(c))


if __name__ == "__main__":
    main()
