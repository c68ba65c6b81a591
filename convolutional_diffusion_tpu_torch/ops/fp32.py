"""True fp32 products on the card.

PyTorch may run fp32 products through TF32 on the tensor cores: matrix
products under `torch.backends.cuda.matmul.allow_tf32`, and cuDNN
convolutions under `torch.backends.cudnn.allow_tf32`, which defaults to on.
The score logits are scaled by 1/(2 beta^2), which turns a TF32 rounding
(2^-11 relative) of a dot product into a large posterior error, and the
prune bounds by tens of log2 units; the backbones at 'highest' are held to
true fp32 like the JAX models. So every product outside the flash-score
kernels goes through `true_fp32`. This module is the port's one switch of
both flags, and of cuDNN itself where its fp32 kernels lose precision
(`without_cudnn`).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_products(allow: bool):
    """Within `with`, fp32 matrix products and cuDNN convolutions may run in
    TF32 (`allow=True`) or stay fp32 (`allow=False`); the previous settings
    are restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def true_fp32():
    """Within `with`, fp32 matrix products and convolutions stay fp32: TF32
    off for both, the previous settings restored after."""
    return tf32_products(False)


@contextlib.contextmanager
def without_cudnn():
    """Within `with`, PyTorch's own CUDA kernels run in place of cuDNN's;
    the previous setting is restored after. An op's backward is the one of
    the kernel its forward ran, so this need not cover the backward."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def fp32_einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` in true fp32 (`true_fp32`). The region dot products
    and value sums that the score modules compute outside the flash-score
    kernels go through here at every precision tier, as the JAX package's
    do on the CPU."""
    with true_fp32():
        return torch.einsum(spec, *operands)
