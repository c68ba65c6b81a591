"""MinimalUNet and UBlock, the paper's U-Net epsilon-predictor.

Counterpart of `convolutional_diffusion_tpu/models/unet.py`, with the same
semantics and the reference's module layout (`feature_blocks.{i}`,
`bottleneck`, `output_blocks.{j}`, each `{emb.1, model.N}`; `upsamples.{j}`,
`last_emb.1`, `output_conv`, `last_normalizer`), so a reference state_dict
loads with `load_state_dict(strict=True)`:

 - encoder: a UBlock then a 2x2 max-pool per feature size but the last;
 - a bottleneck UBlock;
 - decoder: ConvTranspose2d(k=2, s=2) upsampling, the skip concatenated
   BEFORE the up-conv's output, then a UBlock that always uses k = 3
   (a reference quirk: the decoder blocks do not receive kernel_size);
 - x + last_emb(e) (ReLU -> Linear), last_normalizer only when last_norm
   and a normalization are both set, then the output conv with `lastksize`;
 - UBlock: x + emb(e) once at its input (ReLU -> Linear), then depth x
   [Conv('same', mode) -> optional Group/BatchNorm -> ReLU]. BatchNorm uses
   its running statistics in `eval()`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .embedding import TimeClassEmbedding
from .layers import (
    DEFAULT_PRECISION,
    PaddedConv,
    check_precision,
    make_norm,
    nchw,
    nhwc,
    precision_scope,
)


class UBlock(nn.Module):
    """Conditioned double-conv block, NCHW: `emb` = [ReLU, Linear(emb_dim,
    infeatures)], `model` = depth x [Conv, (Norm), ReLU]."""

    def __init__(self, infeatures: int, outfeatures: int, emb_dim: int, depth: int = 2,
                 kernel_size: int = 3, normalization: Optional[str] = None,
                 mode: str = "circular"):
        super().__init__()
        self.emb = nn.Sequential(nn.ReLU(), nn.Linear(emb_dim, infeatures))
        layers = []
        for i in range(depth):
            layers.append(PaddedConv(infeatures if i == 0 else outfeatures,
                                     outfeatures, kernel_size, mode))
            norm = make_norm(normalization, outfeatures)
            if norm is not None:
                layers.append(norm)
            layers.append(nn.ReLU())
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        return self.model(x + self.emb(embedding)[:, :, None, None])


class MinimalUNet(nn.Module):
    def __init__(self, channels: int = 3, fsizes: Optional[Sequence[int]] = None,
                 mode: str = "circular", conditional: bool = False,
                 num_classes: Optional[int] = None, emb_dim: int = 256,
                 normalization: Optional[str] = None, last_norm: bool = False,
                 kernel_size: int = 3, lastksize: int = 1,
                 precision=DEFAULT_PRECISION):
        """x's height and width must divide by 2^(len(fsizes) - 1)."""
        super().__init__()
        check_precision(precision)
        fsizes = tuple(int(f) for f in fsizes) if fsizes is not None else (32, 64, 128, 256)
        self.channels = channels
        self.fsizes = fsizes
        self.mode = mode
        self.conditional = conditional
        self.num_classes = num_classes
        self.emb_dim = emb_dim
        self.normalization = normalization
        self.last_norm = last_norm
        self.kernel_size = kernel_size
        self.lastksize = lastksize
        self.precision = precision

        blk = dict(emb_dim=emb_dim, normalization=normalization, mode=mode)
        self.embedding = TimeClassEmbedding(emb_dim, conditional, num_classes)
        ins = (channels, *fsizes[:-1])
        self.feature_blocks = nn.ModuleList(
            UBlock(ins[i], f, kernel_size=kernel_size, **blk)
            for i, f in enumerate(fsizes[:-1])
        )
        self.bottleneck = UBlock(ins[-1], fsizes[-1], kernel_size=kernel_size, **blk)
        levels = range(len(fsizes) - 1, 0, -1)
        self.upsamples = nn.ModuleList(
            nn.ConvTranspose2d(fsizes[i], fsizes[i - 1], 2, stride=2) for i in levels
        )
        # decoder blocks: the skip and the up-conv concatenated; always k = 3
        self.output_blocks = nn.ModuleList(
            UBlock(2 * fsizes[i - 1], fsizes[i - 1], kernel_size=3, **blk) for i in levels
        )
        self.last_emb = nn.Sequential(nn.ReLU(), nn.Linear(emb_dim, fsizes[0]))
        self.output_conv = PaddedConv(fsizes[0], channels, lastksize, mode)
        self.pool = nn.MaxPool2d(2)
        if last_norm and normalization is not None:
            self.last_normalizer = make_norm(normalization, fsizes[0])
        else:
            self.last_normalizer = None

    def forward(self, t: torch.Tensor, x: torch.Tensor, label=None) -> torch.Tensor:
        """t: [b]; x: [b, h, w, c] NHWC; label: [b] int or None. Returns
        epsilon, NHWC."""
        with precision_scope(self.precision):
            e = self.embedding(t, label)
            x = nchw(x)
            skips = []
            for block in self.feature_blocks:
                x = block(x, e)
                skips.append(x)
                x = self.pool(x)
            x = self.bottleneck(x, e)
            for up, block, skip in zip(self.upsamples, self.output_blocks, reversed(skips)):
                x = block(torch.cat([skip, up(x)], dim=1), e)
            x = x + self.last_emb(e)[:, :, None, None]
            if self.last_normalizer is not None:
                x = self.last_normalizer(x)
            return nhwc(self.output_conv(x))
