"""chain.self_ms: the chain's own host work, ms per package over the
window: the program's `chain.step` spans less the part of each that its
stage spans (`chain.plan`, `chain.ns`/`chain.nsx`, `chain.aec`/
`chain.aecm`, `chain.agc`, `chain.vad`) cover: the copies in, the FIFO
write, the casts and the 8 kHz zoom."""
from wbench import program_spans

SOURCE = "program_span"
SPANS = []
program_spans.switch_on()


def read(ctx):
    return program_spans.self_ms_per_pkg(ctx, "chain.step")
