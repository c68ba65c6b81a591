"""CPU tests of the readers of the program's own ranges
(`program_spans.py`, `sweep_host_us_per_launch`, `module_host_ms_per_call`,
`pipeline_write_ms_per_call`, `host_waits_per_call`) on a synthetic trace,
and one card test that the program's launch ranges and the flash-score
kernels stand on one clock."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from port_bench import devtrace, program_spans, spec

NEW = ("sweep_host_us_per_launch", "module_host_ms_per_call", "pipeline_write_ms_per_call",
       "host_waits_per_call")


def _op(name, start, end):
    return devtrace.Op(name, start, end - start)


# one call's ranges, nested as the program and the harness nest them (ns)
RANGES = [
    _op("port_bench.pipeline", 0, 10000),
    _op("pipeline.draw", 10, 20),
    _op("port_bench.machine", 100, 5000),
    _op("machine_step_k3", 100, 2100),
    _op("flash_score.update", 200, 700),
    _op("flash_score.launch", 600, 650),
    _op("flash_score.update", 800, 1300),
    _op("machine_step_k5", 2200, 4200),
    _op("flash_score.update", 2300, 3300),
    _op("pipeline.copy_back", 5100, 5300),
    _op("pipeline.write", 5400, 6400),
    _op("pipeline.write", 6500, 6900),
]
HOST = [
    _op("cudaStreamSynchronize", 300, 400),  # in a sweep: not the wrapper's own time
    _op("cudaLaunchKernel", 610, 620),
    _op("aten::mul", 1350, 1450),
    _op("cudaStreamSynchronize", 1500, 1600),  # in a step, outside the sweeps
    _op("cudaEventSynchronize", 2400, 2600),
    _op("cudaDeviceSynchronize", 4500, 4900),  # the harness's, after the machine
    _op("cudaMemcpy", 5150, 5250),  # the copy back's
    _op("cudaStreamSynchronize", 20000, 20100),  # under no range
]


def _ctx(**kw):
    return SimpleNamespace(**{"calls": 2, **kw})


def test_cover_counts_the_union_within_an_interval():
    cover = program_spans.Cover([_op("a", 0, 10), _op("b", 5, 20), _op("c", 30, 40),
                                 _op("d", 50, 60)])
    assert cover.within(0, 100) == 40
    assert cover.within(8, 35) == 17  # 8-20 and 30-35
    assert cover.within(20, 30) == 0 and cover.within(61, 70) == 0
    assert cover.within(32, 34) == 2


def test_innermost_is_the_enclosing_range_opened_last():
    waits = program_spans.waits(HOST)
    got = [r and r.name for r in program_spans.innermost(RANGES, waits)]
    assert got == ["flash_score.update", "machine_step_k3", "flash_score.update",
                   "port_bench.machine", "pipeline.copy_back", None]


def test_readers_arithmetic():
    ctx = _ctx(ranges=RANGES, host_ops=HOST)
    # sweeps 500 - 100, 500 and 1000 - 200 ns
    assert spec.reader("sweep_host_us_per_launch")(ctx) == pytest.approx(1700 / 3 * 1e-3)
    # steps 2000 - (500 + 500 + 100) and 2000 - 1000 ns, over 2 calls
    assert spec.reader("module_host_ms_per_call")(ctx) == pytest.approx(1900 / 2 * 1e-6)
    assert spec.reader("pipeline_write_ms_per_call")(ctx) == pytest.approx(1400 / 2 * 1e-6)
    # the harness's synchronise and the wait under no range are left out
    assert spec.reader("host_waits_per_call")(ctx) == 2.0


def test_readers_find_the_harness_trace_in_their_callers_frame():
    """Where the harness passes only the device operations, the readers take
    the ranges and host operations of the trace those came from."""
    trace = devtrace.Trace([_op("k", 0, 1)], HOST, RANGES)
    other = devtrace.Trace([_op("k", 0, 1)], [], [])  # noqa: F841 (not this window's)
    direct = _ctx(ranges=RANGES, host_ops=HOST)
    ctx = _ctx(device_ops=trace.device)
    for name in NEW:
        assert spec.reader(name)(ctx) == spec.reader(name)(direct)
    assert all(spec.reader(name)(_ctx(device_ops=[])) is None for name in NEW)


def test_readers_leave_out_a_trace_without_the_programs_ranges():
    """The parent's trace: machine steps and the harness's spans, no sweep or
    pipeline range, and no wait."""
    ctx = _ctx(ranges=[r for r in RANGES if not r.name.startswith(("flash_score", "pipeline"))],
               host_ops=[op for op in HOST if op.name not in program_spans.WAITS])
    assert spec.reader("sweep_host_us_per_launch")(ctx) is None
    assert spec.reader("pipeline_write_ms_per_call")(ctx) is None
    assert spec.reader("host_waits_per_call")(ctx) is None
    assert spec.reader("module_host_ms_per_call")(ctx) == pytest.approx(4000 / 2 * 1e-6)


@pytest.mark.cuda
def test_launch_ranges_and_kernels_share_the_clock():
    """One traced machine call on the card: as many `flash_score.launch`
    ranges as the launch counter's increase, one flash-score main loop each,
    and the n-th main loop starts no earlier than the n-th launch range."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from convolutional_diffusion_tpu_torch.ops import flash_score as fs
    from convolutional_diffusion_tpu_torch.scores import (LocalEquivScoreModule,
                                                          ScheduledScoreMachine)

    g = torch.Generator(device="cuda").manual_seed(2**31 + 7)
    images = torch.rand((256, 32, 32, 3), generator=g, device="cuda") * 2 - 1
    labels = torch.arange(256, device="cuda") % 10
    machine = ScheduledScoreMachine(
        LocalEquivScoreModule((images, labels), batch_size=64, device="cuda"),
        in_channels=3, imsize=32, scales=[3, 3, 5, 5, 7])
    x = torch.randn((2, 32, 32, 3), generator=g, device="cuda")
    machine(x)  # builds the kernels and the banks
    torch.cuda.synchronize()
    before = sum(fs.flash_score_update.launches.values())
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        machine(x)
        torch.cuda.synchronize()
    launched = sum(fs.flash_score_update.launches.values()) - before
    trace = devtrace.collect(prof)
    launches = [r for r in trace.annotations if r.name == program_spans.LAUNCH]
    updates = [r for r in trace.annotations if r.name == program_spans.UPDATE]
    kernels = [op for op in trace.device if devtrace.main_family(op.name) is not None]
    assert launched > 0 and len(launches) == len(updates) == len(kernels) == launched
    late = [(k.start_ns - r.start_ns) for k, r in zip(kernels, launches) if k.start_ns < r.start_ns]
    assert not late, f"{len(late)} kernels start before their launch range (ns: {late[:5]})"
