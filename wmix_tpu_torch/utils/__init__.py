"""Instrumentation of the port (port of `wmix_tpu.utils`)."""
