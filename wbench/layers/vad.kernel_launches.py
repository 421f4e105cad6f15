"""vad.kernel_launches: launches of the VAD kernel (`csrc/vad.cu`, one
`vad.kernel` span a launch in `dsp/vad.py` `process`: one a package on
the card), per package over the window.  A program without the kernel
has no such span, and this reads nothing."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.spans_per_pkg(ctx, "vad.kernel")
