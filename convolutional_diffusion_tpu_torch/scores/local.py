"""LocalScoreModule (LS): locality without translation equivariance.

Counterpart of `convolutional_diffusion_tpu/scores/local.py`. Each pixel
(i, j) of x attends over the N training images; the logit for image n is the
sum of per-pixel squared distances over the zero-padded k x k window around
(i, j), and the value is the pixelwise difference (x - a_t img_n)(i, j).

The per-pixel distance field D[b, n] = sum_c (x - a_t img_n)^2 is summed
over a zero-padded k x k box (`box_sum`) and streamed through the shared
online softmax (`common.update_state`) with per-pixel values, `chunk_size`
images (at most 64) at a time. No kernel: plain tensor code.

As in the JAX package, LS shuffles by default (the reference's DataLoader
hard-codes shuffle=True for this module) and uses the exponential schedule.
Order changes results only through batch composition: pass shuffle=False or
an explicit `order` for reproducible runs. The per-call permutation comes
from the module's torch generator, so it is not the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..schedules import exponential_schedule
from .base import ScoreModuleBase
from .common import CutoffRule, Weighting, image_weights, init_state, update_state

MAX_CHUNK = 64  # images per compute chunk at most (the JAX module's cap)


def box_sum(a: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of `a` [..., h, w] over the k x k window centred at each pixel,
    zero-padded at the borders, as separable sums of shifted slices in fp32
    (not a conv2d with a ones kernel: cuDNN runs float32 convolutions in
    TF32 by default)."""
    h, w = a.shape[-2:]
    p = k // 2
    a = F.pad(a, (p, p, p, p))
    rows = a[..., 0:h, :]
    for i in range(1, k):
        rows = rows + a[..., i : i + h, :]
    out = rows[..., 0:w]
    for j in range(1, k):
        out = out + rows[..., j : j + w]
    return out


class LocalScoreModule(ScoreModuleBase):
    def __init__(
        self,
        dataset,
        *,
        batch_size: int = 256,
        schedule=exponential_schedule,
        shuffle: bool = True,
        **kw,
    ):
        super().__init__(
            dataset, batch_size=batch_size, schedule=schedule, shuffle=shuffle,
            **kw,
        )

    def _score(self, k, x, label, at, bt, order):
        n, h, w, c = self.images.shape
        b = x.shape[0]
        cs = min(self.chunk_size, MAX_CHUNK)
        w_img = image_weights(
            self.labels, label,
            batch_size=self.batch_size, max_samples=self.max_samples,
            cutoff=CutoffRule.FILTERED, weighting=Weighting.MEAN, order=order,
        )
        w_img = self._local_weights(w_img)
        beta2 = 2.0 * bt**2
        state = init_state((b, h, w), c, device=self.device)
        for i0 in range(0, n, cs):
            imgs = self.images[i0 : i0 + cs]
            diffs = x[:, None] - at * imgs[None]  # [b, cs, h, w, c]
            boxed = box_sum((diffs * diffs).sum(dim=-1), k)  # [b, cs, h, w]
            # the softmax axis is the image axis: [b, h, w, cs]
            logits = (-boxed / beta2).permute(0, 2, 3, 1)
            state = update_state(
                state, logits, w_img[i0 : i0 + cs],
                diffs.permute(0, 2, 3, 1, 4),  # [b, h, w, cs, c]
            )
        ((_, s1, s2),) = self._merge([state])
        # the values are the differences, so s2/s1 is the mean difference
        return -(s2 / s1[..., None]) / (bt**2)
