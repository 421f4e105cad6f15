"""Array ops of the record chain (port of `wmix_tpu.ops`)."""
