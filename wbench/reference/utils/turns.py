"""`read_bool`: a chain's reads of its device, in one place.

A chain reads its device in the middle of a package (the AGC limiter's
loop condition, exact NS's window countdown).  The port passes such reads
through `read_bool` so that the shards of a sharded chain can take turns
at them; the reference runs one chain, and a read is `bool(t)`.
"""


def read_bool(t) -> bool:
    """`bool(t)` of a one-element tensor."""
    return bool(t)
