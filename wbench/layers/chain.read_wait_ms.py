"""chain.read_wait_ms: the host's wait on the device inside the chain,
ms per package over the window: the program's `turns.read` spans
(`utils/turns.py` `read_bool`, the AGC limiter's one read a pass), which
open once a pass's work is queued and end when the device has run it."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.ms_per_pkg(ctx, "turns.read")
