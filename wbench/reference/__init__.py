"""The benchmark's plain reference: a frozen copy of the port's record chain
as it runs on the CPU, float (fast mode) and integer (NSX + AECM).

The benchmark decides `correct` by holding what the port's timed path
produced against this copy, run on the CPU from the same inputs.  It is a
copy, not an import, so that a later change to the program cannot move
the yardstick: the modules of `wmix_tpu_torch` that `engine/chain.py`
needs, copied file by file with `wmix_tpu_torch` replaced by
`wbench.reference` in their import statements, and these edits:

  * `engine/aec_package.py`: `package_step` is always `package_body`, the
    kernel's plain PyTorch version, and refuses a tensor off the CPU; the
    kernel's launch code (its argument checks, constant table, launch
    counters) is gone, and no CUDA library is loaded.
  * `ops/stepper.py`: the 8 kHz zoom pattern comes from the pure-Python
    float32 simulation, with no C build.
  * cut to what `RecordChain(..., device="cpu").step` and the tests
    reach: no sharded chain (`utils/turns.py` keeps only `read_bool`),
    no `run_chunk` or `reset_slots`, no state conversion to and from
    numpy, no step timer (`utils/trace.py`), no per-stream daemon
    processors, no batched AEC and AECM wrappers, no kernel transforms
    spelled out for tests, no `device.describe`.

Nothing here imports `wmix_tpu_torch`, `wmix_tpu` or jax.  The reference
builds its own plan and state from the inputs: `chain.RecordChain(B,
16000, device="cpu", **kw)`, one `step` a package.
`wbench/tests/test_wbench_reference.py` holds the copy to the port's CPU
chain, bit for bit, at the commit that froze it, and to `wmix_tpu`'s
stored outputs (tests/data/torch_parity_ref.json,
tests/data/torch_aec_only_plain_1s.npz): bit-equal where the chain is
exact or integer, within 1 LSB for the fast AEC.
"""
