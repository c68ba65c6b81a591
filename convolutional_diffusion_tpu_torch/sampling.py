"""Reverse-diffusion update rules.

Counterpart of `convolutional_diffusion_tpu/sampling.py`; this slice ports
the deterministic DDIM step that the score machine uses:

    x <- sqrt(alpha_prev / alpha_t) x
         + (sqrt(beta_prev) - sqrt(alpha_prev / alpha_t) sqrt(beta_t)) eps
"""

from __future__ import annotations

import torch


def ddim_step(x, eps, beta_t, beta_prev):
    """Deterministic DDIM update; beta_t and beta_prev are [b] tensors."""
    alpha_t = 1.0 - beta_t
    alpha_prev = 1.0 - beta_prev
    ratio = torch.sqrt(alpha_prev / alpha_t)
    coef = torch.sqrt(beta_prev) - ratio * torch.sqrt(beta_t)
    ratio = ratio.to(x.device)[:, None, None, None]
    coef = coef.to(x.device)[:, None, None, None]
    return ratio * x + coef * eps
