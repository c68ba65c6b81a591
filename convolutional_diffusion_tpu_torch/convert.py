"""Carrying state across from the JAX package.

Counterpart of `convolutional_diffusion_tpu/convert.py` (and of the scales
loader in its `cli/els.py`). Ported so far: the cached patch banks and the
calibrated scales files (`.json`, `.npy`, `.pt`); model pickles come with
the models slice. Everything crosses as numpy arrays.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import torch

from .scores.bank import Bank, BankGeometry
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
