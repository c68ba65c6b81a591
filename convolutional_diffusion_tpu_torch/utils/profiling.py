"""Profiling and tracing utilities.

Counterpart of `convolutional_diffusion_tpu/utils/profiling.py`: named
ranges for the hot loops (`annotate`: each machine step as
`machine_step_k{k}`, each train step as `train_step`), a trace of any block
written as a Chrome trace (`trace`, `torch.profiler` with the CPU and, on a
card, the CUDA activities), and a timer fenced on the device (`Timer`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

__all__ = ["annotate", "trace", "Timer"]


def annotate(name: str):
    """A named range (`torch.profiler.record_function`): a span of that name
    in a `torch.profiler` trace, on the CPU and on the card alike. Costs
    next to nothing while no profiler runs."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the block with `torch.profiler` (CPU activities, and CUDA ones
    where a card is present) and write it to `log_dir` as a Chrome trace
    (`trace_<pid>_<ns>.json`); yields the profiler (its `key_averages()`,
    and `trace_path` once the block has ended). A no-op yielding None when
    log_dir is None or empty."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    with prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def _fence():
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer of device work: `warmup` calls, then `iters` timed
    calls between two device fences (`torch.cuda.synchronize`). Each
    `time` call appends its mean seconds per call to `laps`."""

    def __init__(self):
        self.laps = []

    def time(self, fn: Callable, *args, iters: int = 1, warmup: int = 1):
        """(mean seconds per call, the last call's output)."""
        for _ in range(warmup):
            fn(*args)
        _fence()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _fence()
        dt = (time.perf_counter() - t0) / iters
        self.laps.append(dt)
        return dt, out
