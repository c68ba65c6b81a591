"""MinimalResNet, the paper's residual convnet epsilon-predictor.

Counterpart of `convolutional_diffusion_tpu/models/resnet.py`, with the same
semantics and the reference's module layout (`embedding.class_embeddings`,
`up_projection`, `embs.{i}.{0,1}`, `convs.{i}.{0,1}`,
`down_projection[.{0,1}]`), so a reference state_dict loads with
`load_state_dict(strict=True)`:

 - an up-projection conv, channels -> emb_dim;
 - num_layers residual blocks: state += ReLU([GroupNorm(8)](Conv(state +
   emb_i(e)))), emb_i = Linear -> GroupNorm(8) -> ReLU;
 - `add_one=True` adds one more embedding MLP's output to the final state;
   with add_one=False the final state is doubled;
 - a down-projection conv with `lastksize`, preceded by GroupNorm(8) when
   normalization is set (`conv_norm_i` and `down_norm` exist only then).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .embedding import TimeClassEmbedding
from .layers import (
    DEFAULT_PRECISION,
    GROUPNORM_EPS,
    DenseNormAct,
    PaddedConv,
    check_precision,
    nchw,
    nhwc,
    precision_scope,
)


class MinimalResNet(nn.Module):
    def __init__(self, channels: int = 3, emb_dim: int = 128, mode: str = "circular",
                 normalization: Optional[str] = None, conditional: bool = False,
                 num_classes: Optional[int] = None, kernel_size: int = 3,
                 num_layers: int = 6, lastksize: int = 1, add_one: bool = True,
                 precision=DEFAULT_PRECISION):
        """normalization: None or any name (the reference treats every
        truthy value as GroupNorm(8); there is no BatchNorm ResNet)."""
        super().__init__()
        check_precision(precision)
        self.channels = channels
        self.emb_dim = emb_dim
        self.mode = mode
        self.normalization = normalization
        self.conditional = conditional
        self.num_classes = num_classes
        self.kernel_size = kernel_size
        self.num_layers = num_layers
        self.lastksize = lastksize
        self.add_one = add_one
        self.precision = precision

        self.embedding = TimeClassEmbedding(emb_dim, conditional, num_classes)
        self.up_projection = PaddedConv(channels, emb_dim, kernel_size, mode)
        self.embs = nn.ModuleList(
            DenseNormAct(emb_dim, emb_dim) for _ in range(num_layers + int(add_one))
        )

        def block():
            layers = [PaddedConv(emb_dim, emb_dim, kernel_size, mode)]
            if normalization is not None:
                layers.append(nn.GroupNorm(8, emb_dim, eps=GROUPNORM_EPS))
            return nn.Sequential(*layers, nn.ReLU())

        self.convs = nn.ModuleList(block() for _ in range(num_layers))
        down = PaddedConv(emb_dim, channels, lastksize, mode)
        self.down_projection = down if normalization is None else nn.Sequential(
            nn.GroupNorm(8, emb_dim, eps=GROUPNORM_EPS), down)

    def forward(self, t: torch.Tensor, x: torch.Tensor, label=None) -> torch.Tensor:
        """t: [b] in [0, 1]; x: [b, h, w, c] NHWC; label: [b] int or None.
        Returns epsilon, NHWC."""
        with precision_scope(self.precision):
            e = self.embedding(t, label)
            state = self.up_projection(nchw(x))
            for i in range(self.num_layers):
                h = state + self.embs[i](e)[:, :, None, None]
                state = state + self.convs[i](h)
            if self.add_one:
                delta = self.embs[self.num_layers](e)[:, :, None, None]
            else:
                delta = state
            return nhwc(self.down_projection(state + delta))
