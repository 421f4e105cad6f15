"""vad.ms: host time of the VAD (`dsp/vad.py` `process`), mean per
package over the window."""
SOURCE = "program_span"
SPANS = [("vad", "wmix_tpu_torch.dsp.vad", "process", "call")]


def read(ctx):
    return ctx.span_ms_per_pkg("vad")
