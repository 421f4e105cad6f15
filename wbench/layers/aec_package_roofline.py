"""aec_package_roofline: the AEC package kernel's (`csrc/aec_package.cu`,
`aec_package_kernel`) share of its roofline, in %: the least time the
chip could take for one package of every slot, against the kernel's mean
device time in the profiled stretch.

The least time is the larger of the bytes at the peak memory rate and
the operations at the peak float32 rate (`wbench/peaks.py`).  Both are
counted from B and the AEC's algorithmic sizes, not from the tensors the
port happens to pass, so the share reads the same work whatever
implements the kernel (a copy of `chip_smoke.py`'s `package_bound`):

  bytes  every input read once (the near package, the far spectra of
         the five blocks, the per-package flags and random phases, the
         constant table), the state read and written once, the output
         written once, all 4-byte words
  FLOP   per block 30 real 128-point transforms (a 64-point complex FFT,
         6 stages x 32 butterflies x 10, plus 65 split or merge bins x
         14) and about 25 k of per-bin work (FilterFar, gradient,
         energies, smoothing, suppression); 5 blocks per stream

At B = 4096: 220.99 MB and 2.2508 GFLOP, 0.066 ms at 3.35 TB/s (bytes
bound it; the operations need 0.034 ms at 67 TFLOP/s).
"""
from wbench.peaks import H100_SXM

SOURCE = "device_trace"
SPANS = []
KERNEL = "aec_package_kernel"

# the AEC's sizes (dsp/aec.py, engine/aec_package.py)
PART_LEN = 64                 # samples of a block
PART_LEN1 = PART_LEN + 1      # spectral bins
PART_LEN2 = 2 * PART_LEN      # transform length
NUM_PARTITIONS = 12           # filter partitions
BLOCKS = 5                    # blocks of a 20 ms, 16 kHz package
PKG = BLOCKS * PART_LEN       # samples of a package
N_VECS = 11                   # per-bin state rows (powers, minima,
                              # smoothed spectra and cross-spectra)
OUT_DELAY = 48                # output carry
N_SCALARS = 11                # per-stream scalars (5 float, 6 int)
WORD = 4


def package_bytes(batch: int) -> int:
    per_stream_in = PKG + 4 * BLOCKS * PART_LEN1          # near, far spectra
    shared_in = BLOCKS * 3 + BLOCKS * PART_LEN1 + \
        2 * PART_LEN2 + 3 * PART_LEN1                     # flags, rand, consts
    state = N_VECS * PART_LEN1 + 6 * NUM_PARTITIONS * PART_LEN1 + \
        2 * PART_LEN2 + PART_LEN + OUT_DELAY + N_SCALARS
    out = PKG
    return WORD * (batch * (per_stream_in + 2 * state + out) + shared_in)


def package_flop(batch: int) -> int:
    transform = 6 * 32 * 10 + PART_LEN1 * 14
    return batch * BLOCKS * (30 * transform + 25_000)


def package_bound_s(batch: int, peaks=H100_SXM):
    """(seconds, "bytes" or "operations"): the least time of a package."""
    by_bytes = package_bytes(batch) / peaks["bytes_per_s"]
    by_ops = package_flop(batch) / peaks["f32_flop_per_s"]
    return max(by_bytes, by_ops), \
        "bytes" if by_bytes >= by_ops else "operations"


def read(ctx):
    prof = ctx.profile
    if not prof:
        return None
    hits = [v for k, v in prof["kernels"].items() if KERNEL in k]
    n = sum(c for c, _ in hits)
    if not n:
        return None
    mean_s = sum(s for _, s in hits) / n
    return 100.0 * package_bound_s(ctx.batch)[0] / mean_s
