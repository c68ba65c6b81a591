"""The port's `utils/profiling.py` on the CPU: a `trace` of one small ELS
machine call and three train steps holds the named ranges the JAX package
puts in (`machine_step_k{k}` for each step's k, `train_step` once a step);
`trace(None)` is a no-op; `Timer` times and keeps its laps."""

import json
from collections import Counter

import numpy as np
import torch

from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch import training as ttraining
from convolutional_diffusion_tpu_torch.scores import LocalEquivScoreModule, ScheduledScoreMachine
from convolutional_diffusion_tpu_torch.utils import profiling

SCALES = [3, 3, 5, 5, 3]


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
