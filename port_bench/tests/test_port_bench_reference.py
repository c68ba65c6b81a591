"""The plain reference against the port's plain path on the CPU, at a tiny
size: the ELS and bbELS scores at one step, and whole machines, with and
without labels."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import inputs
from port_bench.reference import machine as ref_machine

from convolutional_diffusion_tpu_torch.cli.common import build_score_module
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import ScheduledScoreMachine

N, SIZE, C = 80, 12, 3
SCALES = [3, 3, 5, 5, 7, 9]
# float32 machines against float64 sums: the readings at this size are
# ~1e-5 (ELS 'highest', bbELS 'high'); the TF32 products read ~1e-3
TOL = 1e-4

CASES = [("ELS", "els", "highest", "fp32"), ("bbELS", "bbels", "high", "bf16x3")]


def _config(ref):
    return dict(reference=ref, scales=SCALES, scorebatchsize=16, max_samples=100000,
                border_dots="fp32")


def _module(kind, prec, images, labels):
    return build_score_module(kind, (images, labels), batch_size=16, image_size=SIZE,
                              channels=C, schedule=cosine_noise_schedule,
                              max_samples=100000, precision=prec, target_block=2048,
                              device="cpu")


def _gap(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1.0))


@pytest.fixture(scope="module")
def bank():
    images, labels = inputs.synthetic_bank(7, N, SIZE, C, 10, "cpu")
    assert set(labels.tolist()) == set(range(10))  # every label a seed may draw
    return images, labels


@pytest.mark.parametrize("kind,ref,prec,mode", CASES)
@pytest.mark.parametrize("k,t", [(3, 0.05), (5, 0.5), (9, 0.95)])
def test_score_matches_port(bank, kind, ref, prec, mode, k, t):
    images, labels = bank
    mod = _module(kind, prec, images, labels)
    x, _ = inputs.draw(3, 0, SIZE, C, False, 10)
    tt = torch.tensor(t, dtype=torch.float32)
    for label in (None, int(labels[0])):
        got = mod(tt, torch.from_numpy(x), label=label, k=k).numpy()
        want = ref_machine.module(ref).score(tt, torch.from_numpy(x), k, images, labels,
                                             label, _config(ref), mode).numpy()
        assert _gap(got, want) < TOL, (label, _gap(got, want))


@pytest.mark.parametrize("kind,ref,prec,mode", CASES)
@pytest.mark.parametrize("conditional", [False, True])
def test_machine_matches_port(bank, kind, ref, prec, mode, conditional):
    images, labels = bank
    machine = ScheduledScoreMachine(_module(kind, prec, images, labels), in_channels=C,
                                    imsize=SIZE, noise_schedule=cosine_noise_schedule,
                                    scales=SCALES)
    for j in range(2):
        x, lab = inputs.draw(11, j, SIZE, C, conditional, 10)
        got = machine(x, label=lab).numpy()
        want = ref_machine.sample(x, lab, images, labels, _config(ref), mode).numpy()
        assert _gap(got, want) < TOL


def test_tf32_control_is_far(bank):
    """The control's products move a machine by far more than TOL."""
    images, labels = bank
    x, _ = inputs.draw(5, 0, SIZE, C, False, 10)
    cfg = _config("els")
    fp32 = ref_machine.sample(x, None, images, labels, cfg, "fp32").numpy()
    tf32 = ref_machine.sample(x, None, images, labels, cfg, "tf32").numpy()
    assert _gap(tf32, fp32) > 10 * TOL


def test_weights_follow_the_streaming_rules():
    from port_bench.reference.common import image_weights

    labels = torch.tensor([0, 1, 1, 2, 1, 0, 1])
    w = image_weights(labels, 1, batch_size=3, max_samples=6, cutoff="unfiltered",
                      weighting="mean", per_image=2)
    assert w.tolist() == [0, 1 / 4, 1 / 4, 0, 1 / 2, 0, 0]
    w = image_weights(labels, None, batch_size=3, max_samples=3, cutoff="batch_quota",
                      weighting="sum")
    assert w.tolist() == [1, 1, 1, 1, 1, 1, 0]
