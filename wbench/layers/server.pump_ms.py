"""server.pump_ms: host time of one `StreamServer.tick_pipelined` call
(gather, launching the chain's package, starting the copies to the
host), mean per tick over the window."""
SOURCE = "program_span"
SPANS = [("pump", "wmix_tpu_torch.service.stream_server",
          "StreamServer.tick_pipelined", "call")]


def read(ctx):
    return ctx.span_ms_per_call("pump")
