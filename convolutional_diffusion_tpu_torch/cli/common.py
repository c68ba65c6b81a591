"""Shared CLI helpers. Counterpart of `convolutional_diffusion_tpu/cli/common.py`;
ported so far: the score-module factory."""

from __future__ import annotations

from typing import Optional


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
    not ported yet (ROADMAP item 14)."""
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
