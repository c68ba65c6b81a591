"""Sinusoidal time embedding with an optional additive class embedding.

Counterpart of `convolutional_diffusion_tpu/models/embedding.py`; its
attribute names are the reference's (`embedding.class_embeddings`), so a
reference state_dict loads as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class TimeClassEmbedding(nn.Module):
    """emb(t) = concat(sin(t/f), cos(t/f)) [+ Embedding(label)].

    Keeps the reference's frequency quirk: the denominator's exponent is
    ``arange(d) / (d - 1)``, so the highest frequency index reaches 10000
    exactly, unlike the usual ``/ d``.
    """

    def __init__(self, fdim: int, conditional: bool = False,
                 num_classes: Optional[int] = None):
        super().__init__()
        self.fdim = fdim
        self.conditional = conditional
        self.num_classes = num_classes
        if conditional:
            if num_classes is None:
                raise ValueError("num_classes must be set when conditional=True")
            self.class_embeddings = nn.Embedding(num_classes, fdim)

    def forward(self, t: torch.Tensor, label: Optional[torch.Tensor] = None):
        d = self.fdim // 2
        # (d - 1) denominator quirk kept for parity
        denom = 10000.0 ** (torch.arange(d, dtype=torch.float32, device=t.device) / (d - 1))
        targ = t[:, None].to(torch.float32) / denom[None, :]
        emb = torch.cat([torch.sin(targ), torch.cos(targ)], dim=1)
        if self.conditional:
            if label is None:
                raise ValueError("label required for a conditional embedding")
            emb = emb + self.class_embeddings(label.to(torch.long))
        return emb
