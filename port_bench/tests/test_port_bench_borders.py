"""CPU tests of the 64 x 64 bbELS cell's files and of the border regions'
readers (`border_roofline`, `border_host_ms_per_call`, `launch_ranges.py`)
on a synthetic trace with correlation ids."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import devtrace, launch_ranges, roofline, spec
from port_bench.work import sweeps_fn

ROOT = Path(__file__).resolve().parents[2]
CELL = "bbels-celeba64-high.uncond-b4"
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def test_the_cell_finds_every_file():
    cell = spec.load(CELL, ROOT)
    cfg = cell.config
    assert (cfg["module"], cfg["reference"], cfg["precision"]) == ("bbELS", "bbels", "high")
    assert (cfg["image_size"], cfg["channels"], cfg["num_images"]) == (64, 3, 1000)
    assert cfg["scales"] == [3] * 7 + [5] * 5 + [7] * 2 + [9] * 3 + [13, 19, 27]
    assert cell.traffic["batch"] == 4 and not cell.traffic["conditional"]
    assert {m["name"] for m in cell.per_layer} == {
        "k2_roofline", "border_roofline", "border_host_ms_per_call"}
    assert cell.limits["sample_gap"]["limit"] > 0


def test_every_step_has_its_border_sweep():
    cfg = spec.load(CELL, ROOT).config
    got = sweeps_fn("bbels")(cfg, lambda lab: np.ones(cfg["num_images"], bool), [None] * 4)
    border = [s for s in got if s.family == "border"]
    assert len(border) == len(cfg["scales"]) - 1 and all(s.seconds > 0 for s in border)
    assert {s.family for s in got} == {"split", "border"}
    # the last step, k = 3: 2 row and 2 column bands of 4 x 62 queries over
    # 1000 x 62 windows, 4 corners of 4 queries over 1000
    want = (4 * roofline.bound(4 * 62, 1000 * 62, 27, 3, "highest")
            + 4 * roofline.bound(4, 1000, 27, 3, "highest"))
    assert border[-1].seconds == pytest.approx(want)


class Event:
    """One event as `prof.profiler.kineto_results.events()` gives it."""

    def __init__(self, name, start, dur, device=CPU, act="cpu_op", corr=0, linked=0):
        self._v = (name, start, dur, device, act, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[4] == "user_annotation"


def _range(name, start, end):
    return Event(name, start, end - start, act="user_annotation")


def _kernel(name, start, dur, corr, linked=0, act="kernel"):
    return Event(name, start, dur, CUDA, act, corr, linked)


# two calls' worth of one step: two border ranges inside machine steps (ns)
EVENTS = [
    _range("machine_step_k3", 0, 10000),
    _range("bbels.borders", 1000, 3000),
    _range("bbels.borders", 6000, 7000),
    Event("cudaLaunchKernel", 500, 10, act="cuda_runtime", corr=1),  # before the range
    Event("cudaLaunchKernel", 1500, 10, act="cuda_runtime", corr=2),
    Event("cudaStreamSynchronize", 2000, 400, act="cuda_runtime", corr=6),
    Event("cuLaunchKernel", 2500, 10, act="cuda_driver", corr=3),  # cuBLAS's
    Event("cudaMemcpyAsync", 6500, 10, act="cuda_runtime", corr=4),
    Event("aten::index", 6200, 30, corr=42),
    Event("cudaLaunchKernel", 8000, 10, act="cuda_runtime", corr=5),  # after it
    _kernel("void cdt_split_rows::rows_kernel<3, 1, false>()", 600, 100, 1),
    _kernel("sgemm", 3100, 200, 2),  # runs after the range closed: its launch counts
    _kernel("elementwise", 3300, 300, 3),
    _kernel("Memcpy HtoD", 6600, 50, 4, act="gpu_memcpy"),
    _kernel("index_kernel", 6700, 70, 99, linked=42),  # no launch traced: its host op
    _kernel("bbels.borders", 1000, 2600, 0, act="gpu_user_annotation"),  # the mirror
    _kernel("reduce", 8100, 1000, 5),
]


def _ctx(**kw):
    base = dict(calls=2, sweeps=[roofline.Sweep("border", 310e-9), roofline.Sweep("split", 1.0)])
    return SimpleNamespace(**{**base, **kw})


def _roofline(ctx, events):
    """border_roofline's reading of a window that traced `events`, the
    profiler in its caller's frame, where `run_cell` holds it."""
    prof = torch.profiler.profile()
    prof.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))
    return spec.reader("border_roofline")(ctx)


def test_device_time_of_the_operations_launched_in_a_range():
    ev = launch_ranges.events(EVENTS)
    assert launch_ranges.device_ns_within(ev, "bbels.borders") == (4, 200 + 300 + 50 + 70)
    assert launch_ranges.device_ns_within(ev, "machine_step_k3") == (6, 1720)
    assert launch_ranges.device_ns_within(ev, "flash_score.update") == (0, 0)


def test_readers_arithmetic():
    assert _roofline(_ctx(), EVENTS) == pytest.approx(100 * 310 / 620)
    tr = devtrace.Trace([], [devtrace.Op("cudaStreamSynchronize", 2000, 400)],
                        [devtrace.Op(e.name(), e.start_ns(), e.duration_ns())
                         for e in EVENTS[:3]])
    ctx = _ctx(ranges=tr.annotations, host_ops=tr.host)
    # ranges 2000 and 1000 ns, less the 400 ns wait, over 2 calls
    assert spec.reader("border_host_ms_per_call")(ctx) == pytest.approx(2600 / 2 * 1e-6)


def test_readers_give_none_without_a_border_range():
    """The parent's trace: no `bbels.borders` range, and runs that traced
    nothing."""
    bare = [e for e in EVENTS if e.name() != "bbels.borders"]
    assert _roofline(_ctx(), bare) is None
    assert spec.reader("border_roofline")(_ctx()) is None
    assert _roofline(_ctx(sweeps=[]), EVENTS) is None
    steps = [devtrace.Op("machine_step_k3", 0, 10000)]
    assert spec.reader("border_host_ms_per_call")(_ctx(ranges=steps, host_ops=[])) is None
    assert spec.reader("border_host_ms_per_call")(_ctx()) is None
