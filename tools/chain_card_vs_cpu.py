"""Where the fast chain's card and CPU outputs part, stage by stage.

    python tools/chain_card_vs_cpu.py stages [--fixed-order-ns]  # the card
    python tools/chain_card_vs_cpu.py batch                      # the card
    python tools/chain_card_vs_cpu.py cost                       # the card
    python tools/chain_card_vs_cpu.py cpu-order                  # the CPU

`stages` runs RecordChain(256, 16000) in fast mode for 29 packages of
seeded audio (microphone sigma 3000; far end silent, then noise sigma
5000) on the card and on the CPU with the stages switched on in turn (NS;
NS + AEC; + AGC; all four; AEC alone; AEC + AGC + VAD) and, where the AEC
runs, once more with the kernel's plain body on the card, and prints per
case the largest difference in LSB, the samples and streams beyond 4 LSB,
the share of equal samples and the histogram of differences 0-5.
`--fixed-order-ns` runs the NS in a fast mode of fixed rounding order (its
FFT on the Ooura butterflies of exact mode, its sums a pairwise tree,
`tree_sum`), the same bits on every device, in place of its fast mode
(`torch.fft` and `torch.sum`, which round in each device's own order).
`batch` runs the same 256 streams (silent far end) on the card in a chain
of 4096 slots, the others silent, against a chain of 256 slots on the
card and on the CPU, all four stages and NS + AEC.  `cost` times a steady package of RecordChain(4096, 16000) with the NS's
fast mode and with the fixed-order one, alternated twice in one call
(median of 10 each).  `cpu-order` runs the NS alone on the CPU in fast
mode, then again with its FFT on the Ooura butterflies and again with its
sums in reverse order, and prints how far each moves the output: a
last-bit change anywhere in the NS grows into LSB.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wmix_tpu_torch.dsp import ns  # noqa: E402
from wmix_tpu_torch.engine import aec_package  # noqa: E402
from wmix_tpu_torch.engine.chain import RecordChain  # noqa: E402

B, N = 256, 29
_RDFT, _SUM, _MULTI = ns.rdft_traced, ns.seq_sum, ns.seq_sum_multi


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (padded with zeros
    to a power of two, halves added), one float32 rounding per add."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def ns_mode(mode: str = "fast") -> None:
    """The NS's fast mode as it is ("fast"), in fixed rounding order
    ("fixed_order": Ooura FFT, tree sums), with its FFT alone on the Ooura
    butterflies ("ooura_fft") or with its sums over reversed terms
    ("reversed_sums").  Exact mode is left as it is."""
    ns.rdft_traced, ns.seq_sum, ns.seq_sum_multi = _RDFT, _SUM, _MULTI
    if mode in ("fixed_order", "ooura_fft"):
        ns.rdft_traced = lambda a, inverse=False, exact=None: _RDFT(
            a, inverse=inverse, exact=True)
    if mode in ("fixed_order", "reversed_sums"):
        def fast_sum(x, axis=-1, exact=None):
            if exact:
                return _SUM(x, axis, exact)
            x = x.to(torch.float32)
            return tree_sum(x) if mode == "fixed_order" else \
                x.flip(-1).sum(dim=-1)
        ns.seq_sum = fast_sum
        ns.seq_sum_multi = lambda *t, exact=None: tuple(
            fast_sum(x, exact=exact) for x in t)


def audio(seed=0):
    rng = np.random.RandomState(seed)
    mic = (rng.randn(N, B, 320) * 3000).astype(np.int16)
    far = (rng.randn(N, B, 320) * 5000).astype(np.int16)
    return mic, far


def diff_row(a, b) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"max_lsb": int(d.max()), "n_gt4": int((d > 4).sum()),
            "streams_gt4": int((d > 4).any(axis=(0, 2)).sum()),
            "equal_share": round(float((d == 0).mean()), 4),
            "hist": [int((d == k).sum()) for k in range(6)]}


def chain_run(device, flags, mic, far, plain=False):
    ch = RecordChain(B, 16000, ns_enable=flags[0], aec_enable=flags[1],
                     agc_enable=flags[2], vad_enable=flags[3],
                     device=device)
    step = aec_package.package_step
    if plain:
        aec_package.package_step = aec_package.package_body
    try:
        return np.stack([ch.step(mic[k], far[k])[0].cpu().numpy()
                         for k in range(N)])
    finally:
        aec_package.package_step = step


def stages(fixed: bool) -> None:
    ns_mode("fixed_order" if fixed else "fast")
    mic, noise = audio()
    for far_name, far in (("silent", np.zeros_like(mic)), ("noise", noise)):
        for flags in ((1, 0, 0, 0), (1, 1, 0, 0), (1, 1, 1, 0),
                      (1, 1, 1, 1), (0, 1, 0, 0), (0, 1, 1, 1)):
            for plain in ((False, True) if flags[1] else (False,)):
                row = diff_row(chain_run("cuda", flags, mic, far, plain),
                               chain_run("cpu", flags, mic, far))
                print(json.dumps({"far": far_name, "flags": flags,
                                  "card_plain": plain,
                                  "fixed_order_ns": fixed, **row}),
                      flush=True)
    ns_mode()


def batch() -> None:
    mic, _ = audio()

    def run(device, slots, flags):
        ch = RecordChain(slots, 16000, ns_enable=flags[0],
                         aec_enable=flags[1], agc_enable=flags[2],
                         vad_enable=flags[3], device=device)
        x = np.zeros((slots, 320), np.int16)
        out = []
        for k in range(N):
            x[:B] = mic[k]
            out.append(ch.step(x, np.zeros_like(x))[0][:B].cpu().numpy())
        return np.stack(out)
    for flags in ((1, 1, 1, 1), (1, 1, 0, 0)):
        wide, card, cpu = (run("cuda", 4096, flags), run("cuda", B, flags),
                           run("cpu", B, flags))
        print(json.dumps({"flags": flags,
                          "card_4096_vs_card_256": diff_row(wide, card),
                          "card_256_vs_cpu_256": diff_row(card, cpu)}),
              flush=True)


def cost() -> None:
    rng = np.random.RandomState(1)
    bb = 4096
    mic = torch.from_numpy((rng.randn(bb, 320) * 3000).astype(
        np.int16)).cuda()
    far = torch.from_numpy((rng.randn(bb, 320) * 5000).astype(
        np.int16)).cuda()
    res = {}
    for _ in range(2):
        for name in ("fast", "fixed_order"):
            ns_mode(name)
            ch = RecordChain(bb, 16000)
            for _ in range(8):
                ch.step(mic, far)
            torch.cuda.synchronize()
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                ch.step(mic, far)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            res.setdefault(name, []).append(round(float(np.median(ts)), 3))
            ns_mode()
    print(json.dumps({"steady_pkg_ms_b4096_median_of_10": res}), flush=True)


def cpu_order() -> None:
    mic, _ = audio()

    def run():
        st = ns.init_state(B, 16000, "cpu")
        out = []
        for k in range(N):
            st, y = ns.process_pkg(st, torch.from_numpy(mic[k]).to(
                torch.int32), 1, 16000, False)
            out.append(y.numpy())
        return np.stack(out)
    out = {}
    for mode in ("fast", "ooura_fft", "reversed_sums"):
        ns_mode(mode)
        out[mode] = run()
    ns_mode()
    print(json.dumps({"ns_fft_ooura_vs_torch_fft": diff_row(
        out["ooura_fft"], out["fast"]), "ns_sums_reversed": diff_row(
        out["reversed_sums"], out["fast"])}))


def main(argv) -> None:
    if argv[:1] != ["cpu-order"]:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    if argv[:1] == ["stages"]:
        stages("--fixed-order-ns" in argv)
    elif argv[:1] == ["batch"]:
        batch()
    elif argv[:1] == ["cost"]:
        cost()
    elif argv[:1] == ["cpu-order"]:
        cpu_order()
    else:
        print(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
