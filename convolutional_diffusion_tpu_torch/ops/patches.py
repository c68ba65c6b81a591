"""Patch extraction and padding primitives (NHWC).

Counterpart of `convolutional_diffusion_tpu/ops/patches.py`. Patches are
built from k^2 shifted slices concatenated on the channel axis, so the
flattened feature order is (ki, kj, c): offset (di, dj) channel ci lives at
index (di * k + dj) * c + ci — not `F.unfold`'s (c, ki, kj).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "extract_patches",
    "pad_image",
    "center_index",
    "patch_centers",
]


def extract_patches(x: torch.Tensor, k: int) -> torch.Tensor:
    """All valid k x k patches of NHWC `x` -> [n, h-k+1, w-k+1, k*k*c]."""
    n, h, w, c = x.shape
    hp, wp = h - k + 1, w - k + 1
    slices = [
        x[:, di : di + hp, dj : dj + wp, :] for di in range(k) for dj in range(k)
    ]
    return torch.cat(slices, dim=-1)


def pad_image(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Spatially pad NHWC x by `pad` on all sides ('circular' or 'zeros')."""
    if mode not in ("circular", "zeros"):
        raise ValueError(f"mode must be 'circular' or 'zeros', got {mode!r}")
    if pad == 0:
        return x
    if mode == "zeros":
        return F.pad(x, (0, 0, pad, pad, pad, pad))
    # index-based wrap: also right when pad exceeds the image size
    _, h, w, _ = x.shape
    rows = torch.arange(-pad, h + pad, device=x.device) % h
    cols = torch.arange(-pad, w + pad, device=x.device) % w
    return x[:, rows][:, :, cols]


def center_index(k: int, c: int) -> slice:
    """Channel slice of the patch-center pixel under (ki, kj, c) ordering."""
    p = k // 2
    start = (p * k + p) * c
    return slice(start, start + c)


def patch_centers(patches: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """[..., k*k*c] patches -> [..., c] center-pixel values."""
    return patches[..., center_index(k, c)]
