"""DiffusionModel: a backbone with its noise schedule and shape metadata.

Counterpart of `convolutional_diffusion_tpu/models/ddim.py` (the reference's
`DDIM` wrapper). Here the module holds its weights, so the JAX package's
`params` argument goes away: `model(t, x, label)` is the epsilon prediction.
Sampling lives in `sampling.py`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..schedules import Schedule, cosine_noise_schedule
from ..scores.base import resolve_device
from .layers import seeded_init


class DiffusionModel(nn.Module):
    def __init__(self, backbone: nn.Module, noise_schedule: Schedule = cosine_noise_schedule,
                 in_channels: int = 3, default_imsize: int = 32, *, seed: int = 0,
                 device=None):
        """Draws the backbone's weights from `seed` (`seeded_init`: PyTorch's
        default rules; the global generator is left as it was),
        moves it to `device` (default cuda; without a card that is an error)
        and puts it in eval() mode: BatchNorm serves with its running
        statistics. Loading a state_dict afterwards replaces the drawn
        weights."""
        super().__init__()
        dev = resolve_device(device)
        self.backbone = seeded_init(backbone, seed)
        self.noise_schedule = noise_schedule
        self.in_channels = in_channels
        self.default_imsize = default_imsize
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def conditional(self) -> bool:
        return bool(getattr(self.backbone, "conditional", False))

    def forward(self, t, x: torch.Tensor, label=None) -> torch.Tensor:
        """Epsilon prediction backbone(t, x, label), NHWC in and out. t is a
        number or a [b] tensor; label a [b] int tensor (conditional
        backbones) or None."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        if label is not None:
            label = torch.as_tensor(label, device=x.device)
        return self.backbone(t, x, label)
