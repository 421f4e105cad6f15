"""device.idle: the share of the window in which no operation ran on the
device, in %: 100 x (1 - the device's busy time per package in the
profiled stretch / the window's wall time per package).

The busy time comes from the trace (the union of the device's event
intervals over the stretch's packages); the wall time from the window
itself, since the profiler slows the host (a served tick took about 3.5
times as long under it), and a stretch's own idle share would read that
slowdown as idle time."""
SOURCE = "device_trace"
SPANS = []


def read(ctx):
    prof = ctx.profile
    if not prof or prof["busy_s"] <= 0 or not ctx.profile_pkgs or \
            not ctx.window_pkgs:
        return None
    busy = prof["busy_s"] / ctx.profile_pkgs
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.window_pkgs))
