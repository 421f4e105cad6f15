"""ns.ms: host time of the float NS (`dsp/ns.py` `process_pkg`), mean per
package over the window."""
SOURCE = "program_span"
SPANS = [("ns", "wmix_tpu_torch.dsp.ns", "process_pkg", "call")]


def read(ctx):
    return ctx.span_ms_per_pkg("ns")
