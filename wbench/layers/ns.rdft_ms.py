"""ns.rdft_ms: host time of the float NS's transforms, ms per package over
the window: the program's `ns.rdft` spans (`dsp/ns.py` `_fft` and
`_ifft`, one a transform, six a 16 kHz package): the Ooura butterflies
in exact mode, `torch.fft` in fast mode."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.ms_per_pkg(ctx, "ns.rdft")
