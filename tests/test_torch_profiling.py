"""The port's `utils/profiling.py` on the CPU: a `trace` of one small ELS
machine call and three train steps holds the named ranges the JAX package
puts in (`machine_step_k{k}` for each step's k, `train_step` once a step);
inside a step one `flash_score.update` range per sweep, and the pipeline's
`pipeline.*` ranges where its host work happens; outside a profiler
`annotate` enters no range at all; `trace(None)` is a no-op; `Timer` times
and keeps its laps."""

import json
from collections import Counter

import numpy as np
import torch

from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch import pipeline as tpipeline
from convolutional_diffusion_tpu_torch import training as ttraining
from convolutional_diffusion_tpu_torch.ops import flash_score as fs
from convolutional_diffusion_tpu_torch.scores import LocalEquivScoreModule, ScheduledScoreMachine
from convolutional_diffusion_tpu_torch.scores.bank import bank_geometry
from convolutional_diffusion_tpu_torch.utils import profiling

SCALES = [3, 3, 5, 5, 3]
BLOCK = 100  # bank rows a chunk: 8 chunks at k = 3 and 3 at k = 5 over 16 images of 8 x 8


def _ranges(trace_path):
    """The trace's named ranges as (name, start us, end us), by start."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"), key=lambda r: r[1])


def _machine(images, labels):
    return ScheduledScoreMachine(
        LocalEquivScoreModule((images, labels), kernel_size=3, batch_size=8,
                              target_block=BLOCK, device="cpu"),
        in_channels=1, imsize=8, scales=SCALES)


def test_trace_holds_the_machine_and_train_step_ranges(tiny_dataset, tmp_path):
    images, labels = tiny_dataset
    machine = ScheduledScoreMachine(
        LocalEquivScoreModule((images, labels), kernel_size=3, batch_size=8, device="cpu"),
        in_channels=1, imsize=8, scales=SCALES)
    net = tmodels.MinimalResNet(channels=1, emb_dim=8, num_layers=1, mode="zeros")
    model = tmodels.DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu")
    x = torch.randn((2, 8, 8, 1), generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path / "trace")) as prof:
        out = machine(x)
        ttraining.train_diffusion(model, (images[:12], labels[:12]),
                                  ttraining.TrainConfig(epochs=1, batch_size=4),
                                  log_fn=lambda s: None)
    assert torch.isfinite(out).all()
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    want = Counter(f"machine_step_k{SCALES[i]}" for i in range(len(SCALES) - 1, 0, -1))
    want["train_step"] = 3
    assert {name: spans[name] for name in want} == dict(want)


def test_annotate_outside_a_profiler_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.annotate("a_range"):
        pass
    g = torch.Generator().manual_seed(0)
    q, bank = torch.randn((4, 9), generator=g), torch.randn((6, 9), generator=g)
    state = (torch.full((4,), fs.NEG_INF), torch.zeros(4), torch.zeros((4, 1)))
    m, s1, s2 = fs.flash_score_update(q, (q * q).sum(1), bank, (bank * bank).sum(1),
                                      bank[:, 4:5].contiguous(), torch.ones(6), 0.9, 0.4,
                                      state)
    assert torch.isfinite(m).all() and (s1 > 0).all() and s2.shape == (4, 1)


def test_trace_has_one_update_range_per_sweep_inside_its_step(tiny_dataset, tmp_path):
    images, labels = tiny_dataset
    x = torch.randn((2, 8, 8, 1), generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path / "trace")) as prof:
        machine = _machine(images, labels)
        out = machine(x)
    assert torch.isfinite(out).all()
    ranges = _ranges(prof.trace_path)
    steps = [r for r in ranges if r[0].startswith("machine_step_k")]
    updates = [r for r in ranges if r[0] == "flash_score.update"]
    sweeps = sum(bank_geometry(16, 8, 8, 1, SCALES[i], BLOCK).nblk
                 for i in range(len(SCALES) - 1, 0, -1))
    assert len(steps) == len(SCALES) - 1 and len(updates) == sweeps == 22
    for _, a, b in updates:
        assert any(s0 <= a and b <= s1 for _, s0, s1 in steps)
    assert not any(r[0] == "flash_score.launch" for r in ranges)  # no kernel on the CPU


def test_trace_names_the_pipelines_host_work(tiny_dataset, tmp_path):
    images, labels = tiny_dataset
    machine = _machine(images, labels)
    out_dir = str(tmp_path / "samples")
    with profiling.trace(str(tmp_path / "trace")) as prof:
        for numiters in (2, 4):  # two calls of one batch each, the second resuming
            tpipeline.generate_els_samples(machine, out_dir, numiters=numiters, in_channels=1,
                                           image_size=8, batch=2, seed=3,
                                           log_fn=lambda s: None)
    ranges = _ranges(prof.trace_path)
    got = [r[0] for r in ranges if r[0].startswith("pipeline.")]
    call = ["pipeline.draw", "pipeline.copy_back", "pipeline.write"]
    assert got == call + ["pipeline.resume_scan"] + call
    steps = [r for r in ranges if r[0].startswith("machine_step_k")]
    draw = next(r for r in ranges if r[0] == "pipeline.draw")
    copy = next(r for r in ranges if r[0] == "pipeline.copy_back")
    between = [r for r in steps if draw[2] <= r[1] and r[2] <= copy[1]]
    assert len(between) == len(SCALES) - 1  # the first call's machine, between the two
    assert len(steps) == 2 * len(SCALES) - 2
    assert sum(1 for _ in (tmp_path / "samples" / "els_outputs").iterdir()) == 4


def test_trace_none_is_a_no_op():
    with profiling.trace(None) as prof:
        y = torch.ones(3) * 2
    assert prof is None and y.sum() == 6


def test_timer_times_and_keeps_laps():
    timer = profiling.Timer()
    calls = []

    def fn(a):
        calls.append(a)
        return a * 2

    dt, out = timer.time(fn, 3, iters=4, warmup=2)
    assert out == 6 and len(calls) == 6 and dt >= 0
    dt2, _ = timer.time(fn, 1)
    assert timer.laps == [dt, dt2] and np.isfinite(timer.laps).all()
    with profiling.annotate("a_range"):  # usable outside a trace
        pass
