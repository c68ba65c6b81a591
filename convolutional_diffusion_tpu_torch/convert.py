"""Carrying state across from the JAX package.

Counterpart of `convolutional_diffusion_tpu/convert.py` (and of the scales
loader in its `cli/els.py`). Ported so far: the cached patch banks (plain
and clustered) and the calibrated scales files (`.json`, `.npy`, `.pt`); model pickles come with
the models slice. Everything crosses as numpy arrays.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import torch

from .ops.prune import BankBlockStats
from .scores.bank import Bank, BankGeometry, ClusteredBank
from .scores.base import resolve_device


def bank_from_jax_numpy(bank, centers, pn, geometry: BankGeometry, device=None) -> Bank:
    """The JAX package's compact cached bank (`build_bank` output as numpy:
    bank [nblk, B*d], centers [nblk, B*c], pn [nblk, B]) -> this package's
    Bank ([nblk, B, d], [nblk, B, c], [nblk, B]) on `device` (default cuda)."""
    dev = resolve_device(device)
    g = geometry
    bank = np.asarray(bank, np.float32)
    centers = np.asarray(centers, np.float32)
    pn = np.asarray(pn, np.float32)
    if bank.shape != (g.nblk, g.block * g.d) or pn.shape != (g.nblk, g.block):
        raise ValueError(
            f"bank {bank.shape} / pn {pn.shape} do not match geometry {g}"
        )
    c = centers.shape[1] // g.block
    if centers.shape != (g.nblk, g.block * c):
        raise ValueError(f"centers {centers.shape} do not match geometry {g}")
    return Bank(
        torch.from_numpy(bank.reshape(g.nblk, g.block, g.d)).to(dev),
        torch.from_numpy(centers.reshape(g.nblk, g.block, c)).to(dev),
        torch.from_numpy(pn).to(dev),
    )


def clustered_bank_from_jax_numpy(bank, centers, pn, img_idx, centroids, radii,
                                  valid, geometry: BankGeometry,
                                  device=None) -> ClusteredBank:
    """The JAX package's `ClusteredBank` as numpy (bank [nblk, B*d], centers
    [nblk, B*c], pn and img_idx [nblk, B], and its stats flattened over
    (chunk, block): centroids [J, d], radii [J], valid [J]) -> this
    package's ClusteredBank on `device` (default cuda): the same rows in the
    same order, whatever k-means did with ties."""
    g = geometry
    plain = bank_from_jax_numpy(bank, centers, pn, g, device=device)
    dev = plain.bank.device
    img_idx = np.asarray(img_idx, np.int32)
    centroids = np.asarray(centroids, np.float32)
    J = centroids.shape[0]
    if img_idx.shape != (g.nblk, g.block) or centroids.shape != (J, g.d) \
            or np.shape(radii) != (J,) or np.shape(valid) != (J,):
        raise ValueError(
            f"img_idx {img_idx.shape} / stats {centroids.shape} do not match "
            f"geometry {g}"
        )
    stats = BankBlockStats(
        torch.from_numpy(centroids).to(dev),
        torch.from_numpy(np.asarray(radii, np.float32)).to(dev),
        torch.from_numpy(np.asarray(valid, bool)).to(dev),
    )
    return ClusteredBank(*plain, torch.from_numpy(img_idx).to(dev), stats)


def load_pt(path: str):
    """A `torch.save`'d object, on the CPU: read with `weights_only=True`,
    and with a full unpickle only where that refuses the file."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_scales(path: str) -> list:
    """Per-step kernel sizes from a `.json` list, a `.npy` array, or a
    `.pt` file (the reference's `scales_*.pt`: a `torch.save`'d list of
    ints or a tensor, read by `load_pt`)."""
    if path.endswith(".json"):
        with open(path) as f:
            return [int(s) for s in json.load(f)]
    if path.endswith(".npy"):
        return [int(s) for s in np.load(path)]
    scales = load_pt(path)
    if isinstance(scales, torch.Tensor):
        scales = scales.reshape(-1).tolist()
    return [int(s.item() if hasattr(s, "item") else s) for s in scales]
