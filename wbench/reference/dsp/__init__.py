"""Per-stream DSP modules of the record chain, batched over a leading stream
axis (port of `wmix_tpu.dsp`)."""
