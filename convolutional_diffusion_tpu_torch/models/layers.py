"""Shared building blocks of the convolutional diffusion backbones.

Counterpart of `convolutional_diffusion_tpu/models/layers.py`. The backbones
take and return NHWC tensors, as the JAX package's do; inside, a tensor
runs as `x.permute(0, 3, 1, 2)`, an NCHW view in channels-last memory that
cuDNN takes without a copy, and is permuted back on the way out.

Parity notes:
 - ``nn.Conv2d(padding='same', padding_mode=mode)`` pads k - 1 in all,
   floor on the left and ceil on the right (asymmetric for even k), in
   'circular' and 'zeros' alike: the JAX package's `pad_same`.
 - GroupNorm's eps is torch's default, 1e-5 (the JAX layers set it).
 - BatchNorm is `nn.BatchNorm2d`, whose running statistics (updated with
   the unbiased batch variance at momentum 0.1, used in `eval()`) are what
   the JAX package's `TorchBatchNorm` reproduces; it runs PyTorch's own
   CUDA kernel, not cuDNN's (`BatchNorm`).

precision: the backbones take it and run their whole forward in its scope
(`precision_scope`). 'highest' (the default) runs convolutions and dense
layers in true fp32 (`ops.fp32.true_fp32`, TF32 off for cuBLAS and cuDNN), the JAX
models' parity setting. None, the JAX package's single-pass setting, lets
them run in TF32 on the card (2^-11 relative per product).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..ops.fp32 import tf32_products, without_cudnn

DEFAULT_PRECISION = "highest"
PRECISIONS = ("highest", None)
GROUPNORM_EPS = 1e-5  # torch nn.GroupNorm default


def check_precision(precision) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'highest' or None, got {precision!r}")


def precision_scope(precision):
    """The context a layer's products run in: true fp32 at 'highest', TF32
    allowed at None."""
    return tf32_products(precision is None)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> an NCHW view (channels-last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> an NHWC view."""
    return x.permute(0, 2, 3, 1)


class PaddedConv(nn.Conv2d):
    """Conv2d with 'same' output size under 'circular' or 'zeros' padding,
    for every k: the reference's ``nn.Conv2d(..., padding='same',
    padding_mode=mode)``. NCHW; the backbones permute around it."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 mode: str = "circular"):
        if mode not in ("circular", "zeros"):
            raise ValueError(f"mode must be 'circular' or 'zeros', got {mode!r}")
        super().__init__(in_features, features, kernel_size, padding="same",
                         padding_mode=mode)


class DenseNormAct(nn.Sequential):
    """Linear -> GroupNorm(8) -> ReLU on a [batch, features] vector: the
    per-layer embedding MLP of MinimalResNet (reference layout: `0` the
    Linear, `1` the GroupNorm)."""

    def __init__(self, in_features: int, features: int):
        super().__init__(
            nn.Linear(in_features, features),
            nn.GroupNorm(8, features, eps=GROUPNORM_EPS),
            nn.ReLU(),
        )


class BatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (the same state_dict) through PyTorch's own CUDA
    kernel. With cuDNN's, which PyTorch takes in training for channels-last
    input, the gradients of the convs before it lie further from a float64
    step than fp32 rounding explains, past what 'highest' promises
    (`tests/test_torch_cuda.py::test_train_step_on_the_card_matches_cpu`
    fails with it on an H100; `chip_smoke.py` gate (d) prints both).

    Under data-parallel training (`batch_statistics_over`) the batch
    statistics in training are those of the GLOBAL batch, as under the JAX
    trainer's jit: count, sum and sum of squares all-reduced over the group
    (differentiably, so the backward crosses ranks too) in float64, where
    the variance E[x^2] - mean^2 does not cancel away, the running mean and
    unbiased running variance updated from the global count. In a group of
    one it is the one-process layer."""

    process_group = None  # set by batch_statistics_over

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.process_group
        if self.training and group is not None and dist.get_world_size(group) > 1:
            return self._global_forward(x, group)
        with without_cudnn():
            return super().forward(x)

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        from torch.distributed.nn.functional import all_reduce

        from ..parallel.mesh import count_collective

        dims = (0, 2, 3)
        xd = x.double()
        count = torch.full((1,), x.numel() // x.shape[1], dtype=xd.dtype, device=x.device)
        stats = torch.cat([xd.sum(dim=dims), (xd * xd).sum(dim=dims), count])
        count_collective("all_reduce", stats)
        stats = all_reduce(stats, group=group)
        c = x.shape[1]
        n = stats[-1]
        mean = stats[:c] / n
        var = stats[c:2 * c] / n - mean * mean
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        scale = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = scale * self.weight
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            self.running_mean.mul_(1 - f).add_(f * mean.detach())
            self.running_var.mul_(1 - f).add_(f * var.detach() * (n / (n - 1)).to(x.dtype))
        # centred before scaling, as PyTorch's kernel: x * scale - mean * scale
        # would lose eps32 * |mean| / std of a channel in the forward and in
        # the weight's gradient
        y = (x - mean[None, :, None, None]) * scale[None, :, None, None]
        return y + self.bias[None, :, None, None] if self.affine else y


@contextlib.contextmanager
def batch_statistics_over(module: nn.Module, group):
    """Within the context every `BatchNorm` of `module` takes its training
    statistics over the process group `group` (None: each process its own)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.process_group = group
    try:
        yield
    finally:
        for m in norms:
            m.process_group = None


def make_norm(normalization: Optional[str], features: int) -> Optional[nn.Module]:
    """GroupNorm(min(32, f)), BatchNorm, or None (no normalization)."""
    if normalization == "GroupNorm":
        return nn.GroupNorm(min(32, features), features, eps=GROUPNORM_EPS)
    if normalization == "BatchNorm":
        return BatchNorm(features)
    if normalization is None:
        return None
    raise ValueError(f"unknown normalization {normalization!r}")


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int) -> nn.Module:
    """Redraw every parameter of `module` by each submodule's own
    `reset_parameters` (PyTorch's default rules) from a generator seeded
    with `seed`, forked from the global one: the weights depend on the seed
    alone, and the global generator's state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
    return module
