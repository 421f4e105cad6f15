"""The device's time in a profiled stretch, given an owner: each device
event goes to the innermost of the program's spans
(`wmix_tpu_torch/utils/trace.py`) open on the host thread that launched
it, when it was launched.

The profiler's CUDA activity records, beside the device's own events,
the runtime calls that launched them (`cudaLaunchKernel`,
`cudaMemsetAsync`, ...), each with the correlation id of the device
event it made, its host thread (the low 32 bits of the thread's
`threading.get_ident()`, as `device_resource_id`) and its time on the
clock the program's spans are stamped with (`time.time_ns`).
`profile_rows` reads both from a finished `torch.profiler.profile`, and
`device_by_span` joins them to the spans.  The harness does not call
this module yet: see PERF.md's open questions.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from wbench import profiling

OUTSIDE = profiling.OUTSIDE
UNLINKED = "no launch found"
THREAD_BITS = 0xFFFFFFFF        # of a thread's id that a launch carries


def profile_rows(prof):
    """(device events (name, start_ns, end_ns, correlation), launches
    (start_ns, end_ns, thread's low 32 bits, correlation)) of a finished
    profiler.  A launch is a CUDA API call (its name starts with "cu")
    whose correlation id some device event carries."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.name(), ev.start_ns(),
                               ev.start_ns() + ev.duration_ns(),
                               ev.correlation_id()))
        elif ev.name().startswith("cu"):
            host.append(ev)
    ids = {d[3] for d in device}
    # a call's thread may come as a signed or an unsigned 32-bit number
    # (both seen in one profile on the card): keep its low 32 bits
    launches = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                 ev.device_resource_id() & THREAD_BITS, ev.correlation_id())
                for ev in host if ev.correlation_id() in ids]
    return device, launches


def _segments(intervals) -> dict:
    """{thread: (segment starts, [(start, end, innermost span)])}, the
    segments of `profiling._labelled_segments` over each thread's spans."""
    by_thread = defaultdict(list)
    for iv in intervals:
        by_thread[iv.thread & THREAD_BITS].append(iv)
    out = {}
    for thread, ivs in by_thread.items():
        ivs.sort(key=lambda iv: (iv.start_ns, -iv.end_ns))   # outer first
        segs = profiling._labelled_segments(
            [(iv.name, iv.start_ns, iv.end_ns) for iv in ivs],
            ivs[0].start_ns, max(iv.end_ns for iv in ivs))
        out[thread] = ([s[0] for s in segs], segs)
    return out


def device_by_span(device_events, launches, intervals, lo=None, hi=None):
    """{span: [seconds, kernels]} by the innermost program span open at
    each device event's launch; OUTSIDE where none was open, UNLINKED
    where no launch carries the event's id.  The seconds add up to the
    device events' summed time and the kernels to the stretch's kernels.
    The device events are clipped to [lo, hi) as `reduce_events` clips
    them."""
    segments = _segments(intervals)
    launch = {corr: (s, thread) for s, _, thread, corr in launches}
    out = defaultdict(lambda: [0.0, 0])
    for name, s, e, corr in device_events:
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        owner = UNLINKED
        if corr in launch:
            t, thread = launch[corr]
            starts, segs = segments.get(thread & THREAD_BITS, ((), ()))
            i = bisect.bisect_right(starts, t) - 1
            owner = segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE
        out[owner][0] += (e - s) / 1e9
        out[owner][1] += 0 if name.startswith(profiling._NOT_KERNELS) else 1
    return {k: list(v) for k, v in out.items()}
