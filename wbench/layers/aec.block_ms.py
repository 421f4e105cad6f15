"""aec.block_ms: host time of the exact-layout AEC's blocks, ms per
package over the window: the program's `aec.block` spans (`engine/
aec_step.py` `build_pkg_body`, one a block, from its math to the ring
write of its output).  Exact mode runs every package through them; the
fast chain only its start-up packages, before any window."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.ms_per_pkg(ctx, "aec.block")
