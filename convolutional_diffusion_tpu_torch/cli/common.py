"""Shared CLI helpers. Counterpart of `convolutional_diffusion_tpu/cli/common.py`:
the score-module factory, backbone construction from the training flags and
model loading from reference `.pt` pickles. Checkpoint names, config
metadata and the torch state_dict export come with the training slice."""

from __future__ import annotations

import os
from typing import Optional


def build_backbone_from_flags(metadata, *, resnet: bool, mode: str, mult: int,
                              layers: int, conditional: bool, nonorm: bool,
                              precision="highest"):
    """The reference training script's construction: a ResNet of emb_dim
    128 * mult and lastksize 3, or a UNet of fsizes [mult * 32 * 2^i for i
    in range(layers)] and lastksize 3; GroupNorm unless nonorm."""
    from ..models import MinimalResNet, MinimalUNet

    normal = None if nonorm else "GroupNorm"
    common = dict(channels=metadata["num_channels"], mode=mode, conditional=conditional,
                  num_classes=metadata["num_classes"], normalization=normal,
                  lastksize=3, precision=precision)
    if resnet:
        return MinimalResNet(emb_dim=128 * mult, kernel_size=3, num_layers=layers, **common)
    return MinimalUNet(fsizes=tuple(mult * 32 * (2**i) for i in range(layers)), **common)


def load_model(path: str, device=None):
    """A trained `models.DiffusionModel` on `device` (default cuda; without
    a card that is an error) from a reference `.pt` whole pickle. The JAX
    package's Orbax checkpoint directories are not read: the port's own
    checkpoint format comes with the training slice (ROADMAP item 4)."""
    from ..convert import diffusion_model_from_torch_pickle
    from ..scores.base import resolve_device

    dev = resolve_device(device)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a checkpoint directory (the JAX package's Orbax format); "
            "the port reads reference .pt pickles, and its own checkpoints come "
            "with the training slice (ROADMAP item 4)"
        )
    if not path.endswith(".pt"):
        raise ValueError(f"{path}: expected a reference .pt whole pickle")
    return diffusion_model_from_torch_pickle(path, device=dev)


def build_score_module(kind: str, dataset_tuple, *, batch_size: int,
                       image_size: int, channels: int, schedule,
                       max_samples: Optional[int] = None, kernel_size: int = 3,
                       precision: str = "highest", shuffle: bool = False,
                       bank_ledger=None, target_block: Optional[int] = None,
                       device=None):
    """Score-module factory matching the reference els_script (and its
    calibration script): kind 'ELS', 'bbELS', 'LS' or 'IS'. `shuffle`
    reaches only the ELS module, as the reference passes --shuffle to it
    alone (LS always shuffles, bbELS and IS do not); max_samples reaches
    only ELS and bbELS, and LS and IS run with batch_size = len(dataset),
    as there. `image_size` and `channels` (the JAX factory's arguments)
    are not needed: the modules read both from the images. `device`
    defaults to cuda. The JAX factory's `mesh` (dataset-sharded modules) is
    not ported yet (ROADMAP item 7)."""
    from ..scores import (
        IdealScoreModule,
        LocalEquivBordersScoreModule,
        LocalEquivScoreModule,
        LocalScoreModule,
    )

    del image_size, channels
    n = len(dataset_tuple[0])
    blk = {} if target_block is None else {"target_block": target_block}
    common = dict(schedule=schedule, precision=precision, device=device)
    if kind == "ELS":
        return LocalEquivScoreModule(
            dataset_tuple, kernel_size=kernel_size, batch_size=batch_size,
            max_samples=max_samples, shuffle=shuffle, bank_ledger=bank_ledger,
            **blk, **common,
        )
    if kind == "bbELS":
        return LocalEquivBordersScoreModule(
            dataset_tuple, kernel_size=kernel_size, batch_size=batch_size,
            max_samples=max_samples, bank_ledger=bank_ledger, **blk, **common,
        )
    # max_samples below n would FILTER-exclude the single batch of LS/IS
    # (all-zero weights, NaN scores), so the reference never passes it
    if kind == "LS":
        return LocalScoreModule(
            dataset_tuple, kernel_size=kernel_size, batch_size=n, **common,
        )
    if kind == "IS":
        return IdealScoreModule(dataset_tuple, batch_size=n, **common)
    raise ValueError(f"Unknown scoremoduletype: {kind}")
