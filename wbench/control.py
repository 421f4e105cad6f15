"""The check's control at a cell's own size: the reference computed below
the configuration's precision (`check.py`), put in the program's place
and compared with the reference as a run compares the program.

    python3 -m wbench.control --workload <cell> --seeds 1,2,3 [--pkgs N]

For each seed the traffic is made on the card as a run makes it, the
slots a run would compare are taken, and the reference and the control
replay them over N packages (a run's `max_pkgs` by default) on the CPU,
one process a seed.  One JSON line a seed: the check's numbers of the
control, and the configuration's limits.  The benchmark's own runs do
not run this; it is how the limits' upper readings were taken.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys

from wbench import check, harness


def _inputs(cfg, traffic, seed):
    import torch
    gen = harness.load_module("traffic", traffic["generator"])
    mic, play = gen.generate(cfg["batch"], traffic["audio_pkgs"],
                             cfg["freq"], seed, traffic["params"],
                             torch.device("cuda"))
    sample = check.sample_slots(cfg["batch"], cfg["check"]["streams"], seed)
    idx = torch.tensor(sample, device=mic.device)
    return tuple(x.index_select(1, idx).cpu().numpy() for x in (mic, play))


def _one(args):
    import torch
    torch.set_num_threads(1)
    cfg, mic, play, n = args
    ref = check.reference_outputs(cfg, mic, play, n)
    ctl = check.reference_outputs(cfg, mic, play, n,
                                  control=cfg["check"]["control"])
    return check.numbers(ctl, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m wbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--pkgs", type=int, default=None)
    args = p.parse_args(argv)
    wl = harness.find(harness.bench_spec(), "workloads", args.workload)
    cfg = harness.config(wl["config"])
    traffic = harness.traffic(wl["traffic"])
    n = args.pkgs or cfg["check"]["max_pkgs"]
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [(cfg, *_inputs(cfg, traffic, s), n) for s in seeds]
    with mp.get_context("spawn").Pool(len(jobs)) as pool:
        results = pool.map(_one, jobs)
    for seed, got in zip(seeds, results):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "pkgs": n, "control": cfg["check"]["control"],
                          "numbers": got, "limits": cfg["check"]["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
