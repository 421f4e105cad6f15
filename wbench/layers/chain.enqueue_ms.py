"""chain.enqueue_ms: host time of one `RecordChain.step` (one package of
every slot: planning and every stage's launches, and whatever device
reads inside make the host wait for), mean per package over the
window."""
SOURCE = "program_span"
SPANS = [("step", "wmix_tpu_torch.engine.chain", "RecordChain.step",
          "call")]


def read(ctx):
    return ctx.span_ms_per_pkg("step")
