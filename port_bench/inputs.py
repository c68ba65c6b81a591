"""The benchmark's inputs, made from `--seed`: the bank images and the seeds
and labels of each sample.

The bank follows the rule of the port's `data.synthetic_dataset` (labels
uniform over the classes, a sine grating per image whose frequencies the
label picks, a random phase, Gaussian noise of sigma 0.3 per channel,
clipped to [-1, 1]), drawn on the device by one `torch.Generator` in a few
large calls instead of a host loop of numpy draws per image. The program
and the reference are handed the same tensors, or regenerate them from the
same seed on the same device.

Sample j's seed and label follow the rule of the port's
`pipeline.generate_els_samples`: its own generator
`numpy.random.default_rng([seed, j])`, a standard normal image first, then
the label from [0, nlabels). The reference draws them again by this copy and
holds the pipeline's saved seeds and labels to it bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def synthetic_bank(seed: int, n: int, size: int, channels: int, classes: int,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """(images [n, size, size, channels] float32 in [-1, 1], labels [n]
    int64) on `device`, a function of `seed` and the device type alone."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    phase = torch.rand((n, 1, 1), generator=g, device=device) * (2 * math.pi)
    grid = torch.arange(size, dtype=torch.float32, device=device) / size
    yy, xx = grid[:, None], grid[None, :]
    fx = (1 + labels % 4).float()[:, None, None]
    fy = (1 + (labels // 4) % 4).float()[:, None, None]
    base = torch.sin(2 * math.pi * (fx * xx + fy * yy) + phase)
    noise = torch.randn((n, size, size, channels), generator=g, device=device) * 0.3
    return torch.clamp(0.7 * base[..., None] + noise, -1.0, 1.0), labels


def draw(seed: int, j: int, size: int, channels: int, conditional: bool,
         nlabels: int) -> tuple[np.ndarray, int | None]:
    """Sample j's seed image [1, size, size, channels] float32 and its label
    (None when unconditional), as the pipeline draws them."""
    rng = np.random.default_rng([seed, j])
    x = rng.standard_normal((1, size, size, channels)).astype(np.float32)
    return x, (int(rng.integers(0, nlabels)) if conditional else None)
