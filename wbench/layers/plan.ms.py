"""plan.ms: host time of the planners' tick (`RecordChain._plan_tick`: the
far-end FIFO slots and the AEC or AECM plan), mean per package over the
window."""
SOURCE = "program_span"
SPANS = [("plan", "wmix_tpu_torch.engine.chain",
          "RecordChain._plan_tick", "call")]


def read(ctx):
    return ctx.span_ms_per_pkg("plan")
