"""server.unread_ms: the time a served tick's outputs wait to be read,
mean over the window's ticks: from the end of its
`stream_server.deliver` span to the end of the `stream_server.read` span
that pops it."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.mean_gap_ms(ctx, "stream_server.deliver",
                                     "stream_server.read")
