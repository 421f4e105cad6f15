"""aec.blocks_per_pkg: the exact-layout AEC's blocks per package over the
window, the count of the program's `aec.block` spans: 5.0 a steady 20 ms
package at 16 kHz (64-sample blocks)."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.spans_per_pkg(ctx, "aec.block")
