"""IdealScoreModule (IS): the exact score of the empirical distribution.

Counterpart of `convolutional_diffusion_tpu/scores/ideal.py`. The posterior
weight of training image n given x is softmax_n(-||x - a_t img_n||^2 /
(2 beta_t)); the score is -(x - a_t E[img | x]) / beta_t.

The distance expands to ||x||^2 - 2 a_t <x, img> + a_t^2 ||img||^2, so the
sweep is a [b, D] @ [D, cs] product per chunk of `chunk_size` images, in
true fp32 (`ops.fp32.fp32_einsum`, TF32 off, at every precision tier), streamed
through the shared online softmax (`common.update_state`) with the images
themselves as the values. No kernel: the JAX package leaves this product to
XLA, and the port to the matrix-product library. The reference's per-batch
mean and its FILTERED max_samples cutoff come from `image_weights`.
"""

from __future__ import annotations

import torch

from ..ops.fp32 import fp32_einsum
from .base import ScoreModuleBase
from .common import CutoffRule, Weighting, image_weights, init_state, update_state


class IdealScoreModule(ScoreModuleBase):
    def __init__(self, dataset, *, batch_size: int = 128, **kw):
        super().__init__(dataset, batch_size=batch_size, **kw)

    def _check_k(self, k):
        """Whole-image module: any k is accepted and ignored, as the
        reference's forward swallows it."""
        return None

    @torch.no_grad()
    def _score(self, k, x, label, at, bt, order):
        n = self.images.shape[0]
        b = x.shape[0]
        w = image_weights(
            self.labels, label,
            batch_size=self.batch_size, max_samples=self.max_samples,
            cutoff=CutoffRule.FILTERED, weighting=Weighting.MEAN, order=order,
        )
        w = self._local_weights(w)
        imgs = self.images.reshape(n, -1)
        xf = x.reshape(b, -1)
        xn = (xf * xf).sum(dim=-1)
        beta2 = 2.0 * bt**2
        state = init_state((b,), imgs.shape[1], device=self.device)
        for i0 in range(0, n, self.chunk_size):
            imgs_c = imgs[i0 : i0 + self.chunk_size]
            dots = fp32_einsum("bd,pd->bp", xf, imgs_c)
            logits = -(
                xn[:, None] - 2.0 * at * dots + at**2 * (imgs_c * imgs_c).sum(-1)
            ) / beta2
            state = update_state(state, logits, w[None, i0 : i0 + self.chunk_size],
                                 imgs_c)
        ((_, s1, s2),) = self._merge([state])
        mean = s2 / s1[:, None]
        return (-(xf - at * mean) / (bt**2)).reshape(x.shape)
