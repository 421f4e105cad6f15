"""aecm.ms: host time of the AECM's package body, the one that
`aecm_step.build_pkg_body` returns, mean per package over the window."""
SOURCE = "program_span"
SPANS = [("aecm", "wmix_tpu_torch.engine.aecm_step", "build_pkg_body",
          "returned")]


def read(ctx):
    return ctx.span_ms_per_pkg("aecm")
