"""The measured window: a closed loop with one client. The next call starts
when the previous one has returned, and calls start while the window is
open; the last one may end past it. The rate is the work of every call over
the time from the window's start to the last call's end."""

from __future__ import annotations

import contextlib
import time
from typing import Callable


def closed_loop(call: Callable[[int], None], seconds: float,
                clock: Callable[[], float] = time.perf_counter):
    """Run call(0), call(1), ... while fewer than `seconds` have passed at
    the start of a call (at least one call). Returns (start, [end of each
    call]) on `clock`."""
    t0 = clock()
    ends = []
    while not ends or ends[-1] - t0 < seconds:
        call(len(ends))
        ends.append(clock())
    return t0, ends


def rate(per_call: int, t0: float, ends: list) -> float:
    """Items per second over the window: per_call x calls / (last end -
    start)."""
    return per_call * len(ends) / (ends[-1] - t0)


class Spans:
    """Host spans of the benchmark's own, by name: (start, end) on
    perf_counter, each also a record_function range `port_bench.<name>`
    in the profiler's trace."""

    def __init__(self):
        self.by_name: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        with torch.profiler.record_function(f"port_bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.by_name.setdefault(name, []).append((t0, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(b - a for a, b in self.by_name.get(name, ()))
