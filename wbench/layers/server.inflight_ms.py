"""server.inflight_ms: the time a served tick's outputs are under way,
mean over the window's ticks: from the end of its `stream_server.pump`
span (the tick launched) to the end of its `stream_server.deliver` span
(its copies waited for and scattered, so it can be read)."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.mean_gap_ms(ctx, "stream_server.pump",
                                     "stream_server.deliver")
