"""Chunked patch-bank storage for the banked ELS path.

Counterpart of `convolutional_diffusion_tpu/scores/bank.py`. A bank holds
every valid k x k patch of every training image, in chunks of `cs` images:

    bank    [nblk, B, d]   (B = cs * patches-per-image, d = k*k*c)
    centers [nblk, B, c]
    pn      [nblk, B]      (squared patch norms)

Rows are ordered image-major then patch position. Images are zero-padded up
to a whole chunk; the padding images get zero weight, so the chunk geometry
(`bank_geometry`, identical to the JAX package's) decides which padding rows
exist and how per-image weights repeat. The JAX package stores the chunks
flat ([nblk, B*d]) to dodge TPU tile padding; on the GPU [nblk, B, d] costs
its payload and `convert.bank_from_jax_numpy` reshapes one into the other.
Banks stay fp32: bf16 storage would round patches at 2^-9, which the
1/(2 beta^2) logit scale amplifies to ~19% posterior error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.patches import extract_patches, patch_centers


class BankLedger:
    """Shared device-memory budget for cached banks ACROSS score modules:
    first come, first served, in bytes. Pass one ledger to several modules so
    their cached banks are capped together."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.used = 0

    def try_reserve(self, nbytes: int) -> bool:
        if self.used + nbytes > self.budget:
            return False
        self.used += nbytes
        return True

    def release(self, nbytes: int) -> None:
        """Roll back a reservation whose build failed."""
        self.used = max(0, self.used - nbytes)


class BankGeometry(NamedTuple):
    per_img: int  # valid k x k positions per image
    cs: int  # images per chunk
    nblk: int  # number of chunks (images padded up to nblk * cs)
    block: int  # patches per chunk = cs * per_img
    d: int  # patch feature dim = k*k*c


def bank_geometry(n: int, h: int, w: int, c: int, k: int, target_block: int) -> BankGeometry:
    per_img = (h - k + 1) * (w - k + 1)
    # clamp the chunk to the dataset: a target_block larger than the whole
    # bank would otherwise zero-pad the single chunk up to the block size
    cs = max(1, min(target_block // max(per_img, 1), n))
    nblk = -(-n // cs)
    return BankGeometry(per_img, cs, nblk, cs * per_img, k * k * c)


def bank_nbytes(n: int, h: int, w: int, c: int, k: int, target_block: int) -> int:
    """Device bytes of a cached fp32 bank (patches, centers and norms)."""
    g = bank_geometry(n, h, w, c, k, target_block)
    return g.nblk * g.block * (g.d + c + 1) * 4


class Bank(NamedTuple):
    bank: torch.Tensor  # [nblk, B, d]
    centers: torch.Tensor  # [nblk, B, c]
    pn: torch.Tensor  # [nblk, B]


def chunk_patches(images: torch.Tensor, k: int):
    """[cs, h, w, c] images -> (patches [B, d], centers [B, c], pn [B]),
    each contiguous: what one sweep step reads."""
    c = images.shape[-1]
    p = extract_patches(images, k)
    p = p.reshape(-1, p.shape[-1])
    return p, patch_centers(p, k, c).contiguous(), (p * p).sum(dim=-1)


@torch.no_grad()
def build_bank(images: torch.Tensor, k: int, target_block: int) -> Bank:
    """images [n, h, w, c] -> Bank on the images' device, one chunk at a time
    (the only transient is one chunk's patches)."""
    n, h, w, c = images.shape
    g = bank_geometry(n, h, w, c, k, target_block)
    dev = images.device
    out = Bank(
        torch.zeros((g.nblk, g.block, g.d), dtype=torch.float32, device=dev),
        torch.zeros((g.nblk, g.block, c), dtype=torch.float32, device=dev),
        torch.zeros((g.nblk, g.block), dtype=torch.float32, device=dev),
    )
    for i in range(g.nblk):
        imgs = images[i * g.cs : (i + 1) * g.cs]
        rows = imgs.shape[0] * g.per_img  # the last chunk may hold padding
        p, ctr, pn = chunk_patches(imgs, k)
        out.bank[i, :rows] = p
        out.centers[i, :rows] = ctr
        out.pn[i, :rows] = pn
    return out


class BankCacheMixin:
    """Ledger-backed bank cache. The host class calls `_init_bank_cache` in
    its __init__ and gains `_bank(k)`."""

    def _init_bank_cache(self, *, target_block, bank_budget_bytes, bank_ledger):
        self.target_block = target_block
        self.bank_ledger = (
            bank_ledger if bank_ledger is not None
            else BankLedger(bank_budget_bytes)
        )
        self._bank_cache = {}

    def _bank(self, k: int):
        """The cached Bank for kernel size k, or None if it does not fit the
        remaining ledger budget (the caller then streams; a miss is not
        cached, so a later call may find budget)."""
        if k in self._bank_cache:
            return self._bank_cache[k]
        n, h, w, c = self.images.shape
        nbytes = bank_nbytes(n, h, w, c, k, self.target_block)
        if not self.bank_ledger.try_reserve(nbytes):
            return None
        try:
            self._bank_cache[k] = build_bank(self.images, k, self.target_block)
        except BaseException:
            self.bank_ledger.release(nbytes)  # a failed build must not starve
            raise                             # retries or ledger siblings
        return self._bank_cache[k]
