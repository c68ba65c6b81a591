"""Patch extraction and padding primitives (NHWC).

Counterpart of `convolutional_diffusion_tpu/ops/patches.py`. The flattened
patch feature order is the JAX package's (ki, kj, c): offset (di, dj)
channel ci lives at index (di * k + dj) * c + ci — not `F.unfold`'s
(c, ki, kj). Patches are one strided copy of a window view (`window_view`),
not k^2 slices and a concatenation: at k = 17 that is one kernel instead of
289 slices per call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "window_view",
    "extract_patches",
    "pad_image",
    "center_index",
    "patch_centers",
]


def window_view(x: torch.Tensor, k: int) -> torch.Tensor:
    """All valid k x k windows of NHWC `x` as a strided view (no copy):
    [n, h-k+1, w-k+1, k, k, c]. Where autograd is to differentiate it (x
    requires grad, as under `torch.func.jacrev`), the same values as an
    index gather instead: `unfold`'s backward has no vmap batching rule, so
    under jacrev it would run once per cotangent lane."""
    if torch.is_grad_enabled() and x.requires_grad:
        _, h, w, _ = x.shape
        offsets = torch.arange(k, device=x.device)
        rows = torch.arange(h - k + 1, device=x.device)[:, None] + offsets
        cols = torch.arange(w - k + 1, device=x.device)[:, None] + offsets
        return x[:, rows][:, :, :, cols].permute(0, 1, 3, 2, 4, 5)
    return x.unfold(1, k, 1).unfold(2, k, 1).permute(0, 1, 2, 4, 5, 3)


def extract_patches(x: torch.Tensor, k: int) -> torch.Tensor:
    """All valid k x k patches of NHWC `x` -> [n, h-k+1, w-k+1, k*k*c]."""
    v = window_view(x, k)
    return v.reshape(*v.shape[:3], -1)


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
