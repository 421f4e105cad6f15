"""aec.ms: host time of the float AEC's package body, the one that
`aec_package.build_chain_aec_body` returns (steady packages: the far-end
machinery and the CUDA package kernel) or `aec_step.build_pkg_body`
(start-up packages), mean per package over the window."""
SOURCE = "program_span"
SPANS = [("aec", "wmix_tpu_torch.engine.aec_package",
          "build_chain_aec_body", "returned"),
         ("aec", "wmix_tpu_torch.engine.aec_step", "build_pkg_body",
          "returned")]


def read(ctx):
    return ctx.span_ms_per_pkg("aec")
