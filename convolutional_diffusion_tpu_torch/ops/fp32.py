"""True fp32 products on the card.

PyTorch may run fp32 matrix products through TF32 on the tensor cores
(`torch.backends.cuda.matmul.allow_tf32`). The score logits are scaled by
1/(2 beta^2), which turns a TF32 rounding (2^-11 relative) of a dot product
into a large posterior error, and the prune bounds by tens of log2 units.
So every product outside the flash-score kernels goes through `true_fp32`.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def true_fp32():
    """Within `with`, fp32 matrix products stay fp32: TF32 off, the previous
    setting restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def fp32_einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` in true fp32 (`true_fp32`). The region dot products
    and value sums that the score modules compute outside the flash-score
    kernels go through here at every precision tier, as the JAX package's
    do on the CPU."""
    with true_fp32():
        return torch.einsum(spec, *operands)
