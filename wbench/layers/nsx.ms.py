"""nsx.ms: host time of the fixed-point NS (`dsp/nsx.py` `process_pkg`),
mean per package over the window."""
SOURCE = "program_span"
SPANS = [("nsx", "wmix_tpu_torch.dsp.nsx", "process_pkg", "call")]


def read(ctx):
    return ctx.span_ms_per_pkg("nsx")
