"""The device time of the operations that the host enqueued inside some of
the program's named ranges: each device operation is matched to its launch
by the profiler's correlation id, and counts where that launch lies within
a range of the given name.

A device operation (kernel, memcpy, memset) carries the correlation id of
the CUDA runtime or driver call that enqueued it (`cudaLaunchKernel`,
`cuLaunchKernel`, `cudaMemcpyAsync`, ...); that call is a host event of the
trace with the same id, stamped on the profiler's one clock as the ranges
are. Where no such call was traced, the operation's linked host operation
(the `aten::` op it ran under) stands in for it.
"""

from __future__ import annotations

import sys
from bisect import bisect_right
from typing import NamedTuple

from port_bench import devtrace

LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")


class Events(NamedTuple):
    device: list  # (correlation id, linked id, Op) of each device operation
    launches: dict  # correlation id -> start ns of the runtime or driver call
    host_ops: dict  # correlation id -> start ns of the host operation
    ranges: list  # Op of the named ranges


def _activity(ev):
    act = devtrace._flag(ev, "activity_type")
    return None if act is None else str(act)


def events(raw) -> Events:
    """The device operations, launch calls, host operations and named ranges
    of the profiler's events `raw` (`prof.profiler.kineto_results.events()`,
    or objects with the same methods)."""
    import torch

    device, launches, host_ops, ranges = [], {}, {}, []
    for ev in raw:
        op = devtrace.Op(ev.name(), devtrace._ns(ev, "start"), devtrace._ns(ev, "duration"))
        act = _activity(ev)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if act is None or act in devtrace.DEVICE_ACTIVITIES:
                device.append((ev.correlation_id(), ev.linked_correlation_id(), op))
        elif act in LAUNCH_ACTIVITIES:
            launches[ev.correlation_id()] = op.start_ns
        elif act == "user_annotation" or devtrace._flag(ev, "is_user_annotation"):
            ranges.append(op)
        else:
            host_ops[ev.correlation_id()] = op.start_ns
    names = {r.name for r in ranges}
    device = [d for d in device if d[2].name not in names]  # a range's mirror
    return Events(device, launches, host_ops, sorted(ranges, key=lambda o: o.start_ns))


def find(ctx) -> Events | None:
    """The window's events: those of the `torch.profiler.profile` that the
    harness's `run_cell` holds while it calls the readers; None where the
    run traced nothing."""
    import torch

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile) and value.profiler is not None:
                return events(value.profiler.kineto_results.events())
        frame = frame.f_back
    return None


def device_ns_within(ev: Events, name: str) -> tuple[int, int]:
    """(operations, their device ns) of the device operations whose launch
    lies within a named range `name`."""
    spans = sorted((r.start_ns, r.start_ns + r.dur_ns) for r in ev.ranges if r.name == name)
    starts = [a for a, _ in spans]
    count = total = 0
    for corr, linked, op in ev.device:
        t = ev.launches.get(corr, ev.host_ops.get(linked))
        i = bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            count += 1
            total += op.dur_ns
    return count, total
