"""The program's own named ranges in a traced window, against the host's
waits: a range's self time, the waits inside a range, and the innermost
range enclosing each wait. The ranges are the program's
`utils.profiling.annotate` ranges (`machine_step_k{k}`, `flash_score.
update`, `flash_score.launch`, `pipeline.*`) and the benchmark's
`port_bench.*` spans; all of them, the host operations and the device's
operations are stamped on the profiler's one clock, so no conversion
lies between them.

A wait is a synchronising CUDA runtime call among the host operations
(`WAITS`): the host stands still there until the card has drained what
was queued before it.
"""

from __future__ import annotations

import sys
from bisect import bisect_left, bisect_right

from port_bench import devtrace

WAITS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))
BENCH_PREFIX = "port_bench."
STEP_PREFIX = "machine_step_k"
UPDATE = "flash_score.update"
LAUNCH = "flash_score.launch"
WRITE = "pipeline.write"


def ranges_and_host(ctx):
    """(named ranges, host operations) of the traced window, each a list of
    `devtrace.Op` sorted by start; None where the run traced nothing.

    From `ctx.ranges` and `ctx.host_ops` where the harness passes them;
    else from the `devtrace.Trace` whose device operations are
    `ctx.device_ops`, which the harness's `run_cell` holds while it calls
    the readers."""
    ranges, host = getattr(ctx, "ranges", None), getattr(ctx, "host_ops", None)
    if ranges is not None and host is not None:
        return ranges, host
    device = getattr(ctx, "device_ops", None)
    frame = sys._getframe(1)
    while frame is not None and device is not None:
        for value in frame.f_locals.values():
            if isinstance(value, devtrace.Trace) and value.device is device:
                return value.annotations, value.host
        frame = frame.f_back
    return None


def waits(host: list) -> list:
    return [op for op in host if op.name in WAITS]


def named(ranges: list, name: str = "", prefix: str = "") -> list:
    """The ranges called `name`, or whose name starts with `prefix`."""
    return [r for r in ranges if (r.name == name if name else r.name.startswith(prefix))]


class Cover:
    """The union of some intervals, to measure how much of [a, b] it covers."""

    def __init__(self, ops: list):
        merged = []
        for op in sorted(ops, key=lambda o: o.start_ns):
            a, b = op.start_ns, op.start_ns + op.dur_ns
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.prefix = [0]
        for a, b in merged:
            self.prefix.append(self.prefix[-1] + b - a)

    def within(self, a: int, b: int) -> int:
        """ns of [a, b] the union covers."""
        i = bisect_right(self.ends, a)  # first interval that ends after a
        j = bisect_left(self.starts, b)  # intervals [i, j) start before b
        if i >= j:
            return 0
        total = self.prefix[j] - self.prefix[i]
        total -= max(0, a - self.starts[i])  # the parts outside [a, b]
        total -= max(0, self.ends[j - 1] - b)
        return total


def self_ns(outer: list, inner: list) -> list:
    """Each range of `outer`: its duration less the part of it that the
    union of `inner` covers, ns."""
    cover = Cover(inner)
    return [r.dur_ns - cover.within(r.start_ns, r.start_ns + r.dur_ns) for r in outer]


def innermost(ranges: list, ops: list) -> list:
    """For each op (sorted by start), the innermost range that encloses it
    (None where none does). Ranges of one thread nest, so it is the enclosing
    range that opened last."""
    order = sorted(ranges, key=lambda r: (r.start_ns, -r.dur_ns))
    out, stack, k = [], [], 0
    for op in ops:
        while k < len(order) and order[k].start_ns <= op.start_ns:
            stack.append(order[k])
            k += 1
        end = op.start_ns + op.dur_ns
        while stack and stack[-1].start_ns + stack[-1].dur_ns < op.start_ns:
            stack.pop()  # ended before this op and everything after it
        out.append(next((r for r in reversed(stack) if r.start_ns + r.dur_ns >= end), None))
    return out
