"""Aten operations of one steady package of the port's record chains, on
the CPU: the host's launch count that an eager package costs on the card.

    python tools/count_chain_ops.py

prints one JSON line per chain: the operations counted by
`wmix_tpu_torch.utils.trace.OpCounter` over one package after start-up,
all of them and those that are not views.  The float chain of
`chip_smoke.py` phase 3 runs the AEC package kernel on the card and its
plain PyTorch version (`package_body`) on the CPU, so for it the line also
gives the operations of one `package_body` call and the count the card
runs: the package's, less the plain version's, plus the one kernel launch.
The integer chains (AECM and NSX, phase 13) run no kernel.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wmix_tpu_torch.engine import aec_package  # noqa: E402
from wmix_tpu_torch.engine.chain import RecordChain  # noqa: E402
from wmix_tpu_torch.utils.trace import OpCounter  # noqa: E402

B = 4
CHAINS = {
    "float_16k_phase3": (16000, {}),
    "int_16k": (16000, dict(aec_backend="aecm", ns_backend="nsx")),
    "int_8k": (8000, dict(aec_backend="aecm", ns_backend="nsx")),
}


def count(freq: int, kw: dict, warm: int = 8) -> dict:
    n = freq // 1000 * 20
    rng = np.random.RandomState(0)
    mic = (rng.randn(warm + 1, B, n) * 3000).astype(np.int16)
    play = (rng.randn(warm + 1, B, n) * 5000).astype(np.int16)
    ch = RecordChain(B, freq, device="cpu", **kw)
    for k in range(warm):
        ch.step(mic[k], play[k])
    body = {"calls": 0, "ops": 0, "launching": 0}
    plain = aec_package.package_body

    def counted_body(*a, **k):
        with OpCounter() as c:
            out = plain(*a, **k)
        body["calls"] += 1
        body["ops"] += c.ops
        body["launching"] += c.launching
        return out

    aec_package.package_body = counted_body
    try:
        with OpCounter() as c:
            ch.step(mic[warm], play[warm])
    finally:
        aec_package.package_body = plain
    row = {"ops": c.ops, "launching": c.launching}
    if body["calls"]:
        row["package_body"] = {k: body[k] for k in ("ops", "launching")}
        row["launching_on_the_card"] = c.launching - body["launching"] + \
            body["calls"]
    return row


def main() -> None:
    torch.set_num_threads(1)
    for name, (freq, kw) in CHAINS.items():
        print(json.dumps({"chain": name, "batch": B, **count(freq, kw)}),
              flush=True)


if __name__ == "__main__":
    main()
