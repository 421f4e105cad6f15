"""agc.limiter_passes: passes of the AGC's overload limiter
(`dsp/agc.py`, one `agc.limiter` span a pass: at least one a subpackage,
two subpackages a 20 ms package at 16 kHz), per package over the
window."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.spans_per_pkg(ctx, "agc.limiter")
