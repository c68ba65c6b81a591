"""Plain PyTorch reference of the ELS score (locality and translation
equivariance, circular boundaries).

Every pixel of x looks at its k x k window, circularly padded; every valid
k x k patch of every bank image is a candidate; the candidate's weight is
its image's (the 'unfiltered' cutoff and 'mean' weighting of the
reference's DataLoader streaming), times exp of
-|window - a patch|^2 / (2 beta); the posterior mean of the candidates'
center pixels gives the score -(x - a mean) / beta. Images of weight 0 are
left out, which changes nothing.
"""

from __future__ import annotations

import torch

from .common import (
    CHUNK_ROWS,
    Posterior,
    center,
    circular_pad,
    coefficients,
    image_weights,
    logits,
    windows,
)


def weights(labels: torch.Tensor, label, config: dict, per_image: int = 1) -> torch.Tensor:
    """float64 weight [n] of each bank image for a seed of `label`."""
    return image_weights(labels, label, batch_size=config["scorebatchsize"],
                         max_samples=config["max_samples"], cutoff="unfiltered",
                         weighting="mean", per_image=per_image)


def score(t, x: torch.Tensor, k: int, images: torch.Tensor, labels: torch.Tensor,
          label, config: dict, mode: str) -> torch.Tensor:
    """The ELS score at time t of one sample x [1, h, w, c] (float32, on the
    bank's device) with kernel size k over the bank (images [n, h, w, c],
    labels [n]); label None or an int."""
    a, beta = coefficients(t)
    n, h, w, c = images.shape
    per_img = (h - k + 1) * (w - k + 1)
    q = windows(circular_pad(x, k // 2), k).reshape(h * w, -1)
    wimg = weights(labels, label, config, per_img)
    used = torch.nonzero(wimg > 0).flatten()
    post = Posterior((h * w,), c, x.device)
    step = max(1, CHUNK_ROWS // per_img)
    for i0 in range(0, used.numel(), step):
        idx = used[i0:i0 + step]
        keys = windows(images[idx], k).reshape(-1, q.shape[1])
        post.add(logits(q, keys, a, beta, mode), wimg[idx].repeat_interleave(per_img),
                 keys[:, center(k, c)], mode)
    mean = post.mean().reshape(1, h, w, c)
    return -(x - a * mean) / beta
