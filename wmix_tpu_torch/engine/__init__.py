"""The batched record chain and its AEC engine (port of `wmix_tpu.engine`)."""
