"""Does a torch.profiler session slow the host's launches after it ends?

    python tools/profiler_aftereffect.py      # on a machine with the card

`chip_smoke.py` profiles the codec path in phase 14 (`device_busy`), and
its later phases time launch-bound packages.  This times steady packages
of RecordChain(4096, 16000) on the card (ms per package, host clock
between synchronizes, 8 packages each) before a profiler session over one
package (CPU and CUDA activities, as `device_busy` takes it), right after
it, and after a second session, in one process, and prints one JSON line
with the card's name and power limit.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

B, WARM, TIMED = 4096, 6, 8


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_aftereffect: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from wmix_tpu_torch.engine.chain import RecordChain
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    n = WARM + 3 * TIMED + 2
    rng = np.random.RandomState(0)
    mic = torch.from_numpy((rng.randn(n, B, 320) * 3000).astype(
        np.int16)).cuda()
    play = torch.from_numpy((rng.randn(n, B, 320) * 5000).astype(
        np.int16)).cuda()
    chain = RecordChain(B, 16000)
    k = 0

    def steps(count):
        nonlocal k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(count):
            chain.step(mic[k], play[k])
            k += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / count

    def profiled():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            steps(1)
            torch.cuda.synchronize()

    steps(WARM)
    before = steps(TIMED)
    profiled()
    after_one = steps(TIMED)
    profiled()
    after_two = steps(TIMED)
    print(json.dumps({
        "card": card, "batch": B, "packages_each": TIMED,
        "pkg_ms_before": round(before, 3),
        "pkg_ms_after_one_session": round(after_one, 3),
        "pkg_ms_after_two_sessions": round(after_two, 3),
        "after_over_before": round(after_one / before, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
