"""agc.ms: host time of the AGC (`dsp/agc.py` `process_pkg`), mean per
package over the window.  The limiter reads a flag back from the device
once per subpackage, so the span also holds the device work queued
before that read."""
SOURCE = "program_span"
SPANS = [("agc", "wmix_tpu_torch.dsp.agc", "process_pkg", "call")]


def read(ctx):
    return ctx.span_ms_per_pkg("agc")
