"""The benchmark of `wmix_tpu_torch`, the port of the wmix record chain to
PyTorch and CUDA (see `wbench/README.md`).

    python3 -m wbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

It measures the port only.  Nothing it runs imports `jax` or `wmix_tpu`,
nor the port's own measuring modules (`wmix_tpu_torch.bench` and its
siblings); it drives the port's program entries (`StreamServer`,
`RecordChain.run_chunk`) and judges their outputs against the frozen
plain reference in `wbench/reference/`.
"""
