"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernel from wmix_tpu_torch/csrc/, drives the record chain's main path at
its full size, checks the kernel against its plain PyTorch version and the
chain against itself on the CPU, and prints one JSON result line.

    python3 chip_smoke.py

Phases (each prints a line; any failed check raises, so the run exits
non-zero and prints no result):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device -> exit 1
  2. build the aec_package kernel (nvcc, sm_90a), with ptxas's report
  3. main path: RecordChain(4096, 16000) in its defaults (the card,
     NS+AEC+AGC+VAD, AGC 5 dB), 4 chunks of K=25 packages of seeded
     audio; the kernel's launch count over the run must equal the steady
     packages (96); outputs int16, AEC output finite; steady chunk time
     and streams = B * audio_s / wall
  4. kernel vs package_body at B=4096 from the adapted state: rel <= 1e-4
     on the output and every float state field, equality on every integer
     state field; CUDA-event times beside the least time the card could
     take for the same bytes and operations: kernel_ms with 20 launches
     queued behind one another (device time alone), kernel_call_ms and
     plain_ms one call at a time (median of 20, the host's share of a
     call included)
  5. the chain at B=4 on cuda (kernel) and on cpu (plain version), same
     input, 2 chunks x K=25: origin and 8 kHz package within 4 LSB
  6. echo check: AecBatchPackage at B=4096 on a delayed-echo scene,
     output energy below near energy over the last package
Then the kernel table as JSON and, last, {"ok": true, "device": {...}}.
"""
import copy
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

B_MAIN, K, CHUNKS = 4096, 25, 4
LSB = 4
REL = 1e-4


def phase(name, **kv):
    print(json.dumps({"phase": name, **kv}), flush=True)


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed: {res.stderr.strip()}"


def audio(k, b, seed):
    rng = np.random.RandomState(seed)
    mic = (rng.randn(k, b, 320) * 3000).astype(np.int16)
    play = (rng.randn(k, b, 320) * 5000).astype(np.int16)
    return mic, play


def rel(x, y) -> float:
    x, y = x.double(), y.double()
    return float((x - y).abs().max() / y.abs().max().clamp_min(1.0))


# Published peaks of the H100 SXM (NVIDIA's data sheet, 700 W): device
# memory and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def package_bound(tensors_in, tensors_inout, tensors_out, batch):
    """(bound_ms, bound_by, bytes, flop) of one AEC package launch: every
    input read once, the state read and written once, the output written
    once, against the operations of the FFT form: per block 30 real
    128-point transforms (a 64-point complex FFT, 6 stages x 32
    butterflies x 10, plus 65 split or merge bins x 14) and about 25 k of
    per-bin work (FilterFar, gradient, energies, smoothing, suppression),
    5 blocks per stream."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    moved = nbytes(tensors_in) + 2 * nbytes(tensors_inout) + \
        nbytes(tensors_out)
    flop = batch * 5 * (30 * (6 * 32 * 10 + 65 * 14) + 25_000)
    by_bytes = moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flop / PEAK_F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", moved, flop)


def cuda_median_ms(fn, n=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_queued_ms(fn, n=20, reps=5) -> float:
    """Device time of one call of `fn` when its launches queue up behind
    each other: a large matrix product keeps the card busy while the host
    enqueues n calls, so the host's time per call (argument checks, ctypes)
    is not in the reading, as it would be for a kernel shorter than its
    wrapper.  Median over `reps` of (elapsed over n calls) / n."""
    blocker = torch.empty((8192, 8192), device="cuda")
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        blocker @ blocker
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from wmix_tpu_torch import kernels
    from wmix_tpu_torch.engine import aec_package
    from wmix_tpu_torch.engine.aec_step import pack_dyn
    from wmix_tpu_torch.engine.chain import RecordChain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name_power = card()
    print(name_power, flush=True)
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build
    kernels.load("aec_package")
    log = kernels.build_log["aec_package"]
    ptxas = [ln.strip() for ln in log["log"].splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln]
    phase("build", source="wmix_tpu_torch/csrc/aec_package.cu",
          arch="sm_90a", built=log["built"],
          seconds=round(log["seconds"], 3), ptxas=ptxas)

    # 3. main path at full size
    mic, play = audio(K * CHUNKS, B_MAIN, seed=0)
    mic_d = torch.from_numpy(mic).to(dev)
    play_d = torch.from_numpy(play).to(dev)
    chain = RecordChain(B_MAIN, 16000)     # the default device: the card
    torch.cuda.synchronize()
    aec_package.package_step.launches = 0
    chunk_ms = []
    outs = []
    for c in range(CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = chain.run_chunk(mic_d[c * K:(c + 1) * K],
                            play_d[c * K:(c + 1) * K])
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(o)
    launches = aec_package.package_step.launches
    steady_pkgs = K * CHUNKS - 4
    if launches != steady_pkgs:
        raise AssertionError(f"kernel launches {launches} != steady "
                             f"packages {steady_pkgs}")
    for o, p8, vf in outs:
        if o.dtype != torch.int16 or p8.dtype != torch.int16:
            raise AssertionError("chain outputs are not int16")
        if tuple(o.shape) != (K, B_MAIN, 320) or \
                tuple(p8.shape) != (K, B_MAIN, 160) or \
                tuple(vf.shape) != (K, B_MAIN):
            raise AssertionError("chain output shapes")
    nonfinite = int(chain.aec_nonfinite)
    if nonfinite:
        raise AssertionError(f"{nonfinite} non-finite AEC output samples")
    if not isinstance(chain.state.aec, aec_package.PackageAecState):
        raise AssertionError("the chain never reached the kernel layout")
    steady_ms = chunk_ms[1:]
    audio_s = K * 0.02
    streams = [B_MAIN * audio_s / (ms / 1e3) for ms in steady_ms]
    phase("main_path", batch=B_MAIN, packages=K * CHUNKS,
          kernel_launches=launches, chunk_ms=[round(x, 3) for x in chunk_ms],
          steady_chunk_ms_median=round(float(np.median(steady_ms)), 3),
          streams_median=round(float(np.median(streams)), 1),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
          origin_rms=round(float(outs[-1][0].float().pow(2).mean().sqrt()),
                           2))

    # 4. kernel vs plain version, from the adapted state
    ast = chain.state.aec
    planner = copy.deepcopy(chain.planner)
    plan = planner.plan_pkg()
    dyn = pack_dyn(plan, chain.part_cap)
    far_pre, fp, fwp = (ast.far_pre.clone(), ast.far_parts.clone(),
                        ast.farw_parts.clone())
    far = torch.from_numpy(audio(1, B_MAIN, seed=7)[1][0]).to(dev).float()
    near = torch.from_numpy(audio(1, B_MAIN, seed=7)[0][0]).to(dev).float()
    aec_package.build_far_body(plan.signature(), chain.sub_len)(
        far_pre, fp, fwp, far, dyn)
    ins = (near.contiguous(), *aec_package._kernel_inputs(fp, fwp, dyn))
    st_k = {k: v.clone() for k, v in ast.p.items()}
    st_p = {k: v.clone() for k, v in ast.p.items()}
    st_k, out_k = aec_package.package_step(st_k, *ins)
    st_p, out_p = aec_package.package_body(st_p, *ins)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError("kernel output not finite")
    worst = {"out": rel(out_k, out_p)}
    worst.update({k: rel(st_k[k], st_p[k])
                  for k in aec_package.STATE_FIELDS
                  if k not in aec_package.SCALAR_I})
    bad = {k: v for k, v in worst.items() if not v <= REL}
    if bad:
        raise AssertionError(f"kernel vs package_body beyond rel {REL}: "
                             f"{bad}")
    unequal = {k: int((st_k[k] != st_p[k]).sum())
               for k in aec_package.SCALAR_I}
    if any(unequal.values()):
        raise AssertionError("kernel vs package_body: integer state fields "
                             f"differ on this many streams: {unequal}")
    max_abs = float((out_k - out_p).abs().max())
    scratch = {k: v.clone() for k, v in ast.p.items()}
    kernel_ms = cuda_queued_ms(
        lambda: aec_package.package_step(scratch, *ins))
    kernel_call_ms = cuda_median_ms(
        lambda: aec_package.package_step(scratch, *ins))
    plain_ms = cuda_median_ms(
        lambda: aec_package.package_body(scratch, *ins))
    bound_ms, bound_by, moved, flop = package_bound(
        ins + (aec_package._kernel_consts(str(near.device)),),
        tuple(st_k[k] for k in aec_package.STATE_FIELDS), (out_k,), B_MAIN)
    phase("kernel_vs_plain", batch=B_MAIN, max_rel=max(worst.values()),
          max_rel_at=max(worst, key=worst.get),
          int_fields_equal=sorted(unequal),
          max_abs_err_out=max_abs, kernel_ms=round(kernel_ms, 4),
          kernel_call_ms=round(kernel_call_ms, 4),
          plain_ms=round(plain_ms, 4), bound_ms=round(bound_ms, 4),
          bound_by=bound_by, bound_share=round(bound_ms / kernel_ms, 4),
          bytes_moved=moved, flop=flop)

    # 5. the chain on cuda (kernel) against the chain on cpu (plain)
    mic4, play4 = audio(2 * K, 4, seed=3)
    res = {}
    for d in ("cuda", "cpu"):
        ch = RecordChain(4, 16000, device=d)
        res[d] = [ch.run_chunk(mic4[c * K:(c + 1) * K],
                               play4[c * K:(c + 1) * K])
                  for c in range(2)]
    dmax = {}
    for j, nm in ((0, "origin"), (1, "pkg8k")):
        a = torch.cat([r[j].cpu() for r in res["cuda"]]).int()
        b = torch.cat([r[j] for r in res["cpu"]]).int()
        dmax[nm] = int((a - b).abs().max())
    vad_equal = all(bool(torch.equal(x[2].cpu(), y[2]))
                    for x, y in zip(res["cuda"], res["cpu"]))
    if max(dmax.values()) > LSB:
        raise AssertionError(f"cuda vs cpu chain beyond {LSB} LSB: {dmax}")
    phase("cuda_vs_cpu_chain", batch=4, packages=2 * K, max_lsb=dmax,
          vad_flags_equal=vad_equal)

    # 6. echo check on the card
    rng = np.random.RandomState(42)
    P = 10
    farx = (rng.randn(P, B_MAIN, 320) * 4000).astype(np.float32)
    nearx = (np.roll(farx, 2, axis=0) * 0.3 +
             rng.randn(P, B_MAIN, 320) * 800).astype(np.float32)
    eb = aec_package.AecBatchPackage(B_MAIN, 16000)
    for p in range(P):
        out = eb.step(torch.from_numpy(farx[p]).to(dev),
                      torch.from_numpy(nearx[p]).to(dev))
    near_e = float((nearx[P - 1].astype(np.float64) ** 2).mean())
    out_e = float(out.double().pow(2).mean())
    if not out_e < near_e:
        raise AssertionError(f"echo not cancelled: out {out_e} >= near "
                             f"{near_e}")
    phase("echo", batch=B_MAIN, near_energy=near_e, out_energy=out_e,
          erle_db=round(10 * np.log10(near_e / out_e), 3))

    print(json.dumps({"kernels": [{
        "name": "aec_package",
        "route": "cuda",
        "source": "wmix_tpu_torch/csrc/aec_package.cu",
        "replaces": "wmix_tpu/engine/aec_pallas.py:587",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes an AEC package
        "library_ms": None}]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
