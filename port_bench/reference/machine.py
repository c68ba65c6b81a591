"""Plain PyTorch reference of the scheduled score machine: the reverse
diffusion of one sample with a kernel size per step and the deterministic
DDIM update, driven by a reference score (`els.score`, `bbels.score`)."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .common import schedule


def module(name: str):
    """Reference score module `name` (`els`, `bbels`): its `score` and
    `weights`."""
    return importlib.import_module(f"{__package__}.{name}")


@torch.no_grad()
def sample(x0: np.ndarray, label, images: torch.Tensor, labels: torch.Tensor,
           config: dict, mode: str) -> torch.Tensor:
    """The machine's output for seed x0 [1, h, w, c]: steps i = n-1 .. 1 of
    n = len(scales), t = i / n, k = scales[i]; eps = -sqrt(beta(t)) score;
    x <- sqrt(alpha' / alpha) x + (sqrt(beta') - sqrt(alpha' / alpha)
    sqrt(beta)) eps, alpha = 1 - beta, primes at t - 1 / n."""
    score = module(config["reference"]).score
    scales = config["scales"]
    nsteps = len(scales)
    x = torch.as_tensor(x0, dtype=torch.float32).to(images.device)
    for i in range(nsteps - 1, 0, -1):
        t = torch.tensor(i, dtype=torch.float32) / nsteps
        beta_t, beta_prev = schedule(t), schedule(t - 1.0 / nsteps)
        eps = score(t, x, scales[i], images, labels, label, config, mode) * (
            -torch.sqrt(beta_t)).item()
        ratio = torch.sqrt((1.0 - beta_prev) / (1.0 - beta_t))
        coef = torch.sqrt(beta_prev) - ratio * torch.sqrt(beta_t)
        x = ratio.item() * x + coef.item() * eps
    return x
