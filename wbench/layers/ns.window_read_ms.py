"""ns.window_read_ms: exact mode's check of the NS feature window's
countdown, ms per package over the window: the program's `ns.window_read`
spans (`dsp/ns.py` `_feature_update`, one a block, two a 16 kHz
package), which hold its host read of the device (`turns.read`), so
mostly the host's wait for the work queued before it."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.ms_per_pkg(ctx, "ns.window_read")
