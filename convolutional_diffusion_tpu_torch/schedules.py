"""Noise schedules: t -> beta(t), in float32.

Counterpart of `convolutional_diffusion_tpu/schedules.py`. The convention is

    x_t = sqrt(1 - beta(t)) * x_0 + sqrt(beta(t)) * eps,   eps ~ N(0, I)

Each schedule takes a Python number or a tensor and returns a float32
tensor; the score machine evaluates them at t <= 0 too (its last step asks
for beta(t - 1/nsteps) = beta(0)).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = [
    "exponential_schedule",
    "linear_noise_schedule",
    "cosine_noise_schedule",
    "get_schedule",
    "Schedule",
]

Schedule = Callable[..., torch.Tensor]


def _as_f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


def exponential_schedule(t):
    """beta(t) = 1 - exp(-2 t)."""
    t = _as_f32(t)
    return 1.0 - torch.exp(-2.0 * t)


def linear_noise_schedule(t):
    """beta(t) = 0.01 + 0.97 t."""
    t = _as_f32(t)
    return 0.01 + 0.97 * t


def cosine_noise_schedule(t, mode: str = "legacy"):
    """Cosine schedule. ``legacy`` (the default, used by every trained model
    and score machine): beta(t) = 1 - cos(t / 1.008 * pi/2)^2, so beta(0) = 0
    exactly. Any other mode adds the usual 0.008 offset."""
    t = _as_f32(t)
    if mode == "legacy":
        return 1.0 - torch.cos(t / 1.008 * math.pi / 2.0) ** 2
    return 1.0 - torch.cos((t + 0.008) / 1.008 * math.pi / 2.0) ** 2


_REGISTRY = {
    "exponential": exponential_schedule,
    "linear": linear_noise_schedule,
    "cosine": cosine_noise_schedule,
}


def get_schedule(name: str) -> Schedule:
    """Look up a schedule by name ('exponential' | 'linear' | 'cosine')."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
