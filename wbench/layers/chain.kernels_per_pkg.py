"""chain.kernels_per_pkg: device kernels in the profiled stretch (the
profiler's kernel events, not copies or fills) per package."""
SOURCE = "device_trace"
SPANS = []


def read(ctx):
    prof = ctx.profile
    if not prof or not prof["kernels"] or not ctx.profile_pkgs:
        return None
    return sum(n for n, _ in prof["kernels"].values()) / ctx.profile_pkgs
