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

A module built with `prune=True` caches a `ClusteredBank` instead: the same
rows sorted by k-means cluster, each with the index of its image, plus the
per-block statistics of exact block pruning (`ops.prune`, kernel variant
K6). `build_clustered_bank` never holds the unsorted bank: it assigns
clusters chunk by chunk from freshly extracted patches, sorts the ids, and
fills each clustered chunk by gathering every row's patch straight from the
images, so its peak is one bank plus the images and one chunk.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..ops.patches import extract_patches, patch_centers, window_view
from ..ops.prune import (
    BankBlockStats,
    assign_clusters,
    block_stats,
    kmeans_centers,
    strided_ids,
)


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


class ClusteredBank(NamedTuple):
    """A cached bank in cluster-sorted row order, with the pruning geometry
    (`ops.prune`). The order changes the softmax sums only by fp32
    summation order: each row's weight follows its image, `img_idx`."""

    bank: torch.Tensor  # [nblk, B, d] (cluster-sorted rows)
    centers: torch.Tensor  # [nblk, B, c]
    pn: torch.Tensor  # [nblk, B]
    img_idx: torch.Tensor  # [nblk, B] int32 image of each row (>= n: padding)
    stats: BankBlockStats  # per PRUNE_BLOCK rows of each chunk
    # seconds of each part of `build_clustered_bank` (k-means, assign, sort
    # and fill, stats), each ended by a device synchronisation; None for a
    # bank carried across (`convert.clustered_bank_from_jax_numpy`)
    build_seconds: dict | None = None


def gather_patches(images: torch.Tensor, img: torch.Tensor, pos: torch.Tensor,
                   k: int) -> torch.Tensor:
    """The k x k patches [N, d] of images [n, h, w, c] at image `img` [N]
    and valid position `pos` [N] (row-major over the (h-k+1) x (w-k+1)
    positions), in `extract_patches`' feature order; rows whose image is a
    padding one (img >= n) are zero patches."""
    n, h, w, c = images.shape
    wp = w - k + 1
    pad = img >= n
    v = window_view(images, k)  # [n, hp, wp, k, k, c]
    p = v[torch.where(pad, 0, img).long(), (pos // wp).long(), (pos % wp).long()]
    p = p.reshape(img.shape[0], k * k * c)
    return p.masked_fill_(pad[:, None], 0.0)


@torch.no_grad()
def build_clustered_bank(images: torch.Tensor, k: int, target_block: int, *,
                         n_centers: int = 4096, sample_size: int = 1 << 18,
                         kmeans_iters: int = 8) -> ClusteredBank:
    """The bank of `build_bank` in the JAX package's clustered order: k-means
    centers fitted on an evenly strided sample of the real rows (the JAX
    package's sample), every row assigned its nearest center, rows stably
    sorted by center, per-PRUNE_BLOCK statistics over the real rows. The
    rows and their order are JAX's `build_clustered_bank`'s (the same
    k-means up to fp32 summation order). Built without the unsorted bank:
    the ids come chunk by chunk from extracted patches, and each sorted
    chunk gathers its rows from the images by (image, position). The
    seconds of its parts come back in `build_seconds`."""
    n, h, w, c = images.shape
    g = bank_geometry(n, h, w, c, k, target_block)
    dev = images.device
    times, clock = {}, [time.perf_counter()]

    def tick(part):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        times[part] = now - clock[0]
        clock[0] = now

    # the JAX package's sample: strided ids over the real rows' prefix (a row
    # id is image * per_img + position until the padding images)
    n_real = n * g.per_img
    ids = strided_ids(n_real, min(sample_size, n_real), dev)
    centers = kmeans_centers(
        gather_patches(images, ids // g.per_img, ids % g.per_img, k),
        n_centers, iters=kmeans_iters)
    tick("kmeans")
    cid = torch.empty((g.nblk, g.block), dtype=torch.int32, device=dev)
    # padding images' rows are zero patches: their nearest center
    cid[-1] = assign_clusters(torch.zeros((1, g.d), device=dev), centers)
    for i in range(g.nblk):
        p, _, _ = chunk_patches(images[i * g.cs : (i + 1) * g.cs], k)
        cid[i, : p.shape[0]] = assign_clusters(p, centers)
    tick("assign")
    perm = torch.argsort(cid.reshape(-1), stable=True).view(g.nblk, g.block)
    del cid
    img_idx = ((perm // g.block) * g.cs + (perm % g.block) // g.per_img).int()
    pos = (perm % g.block) % g.per_img
    del perm
    out = ClusteredBank(
        torch.empty((g.nblk, g.block, g.d), dtype=torch.float32, device=dev),
        torch.empty((g.nblk, g.block, c), dtype=torch.float32, device=dev),
        torch.empty((g.nblk, g.block), dtype=torch.float32, device=dev),
        img_idx, None,
    )
    for i in range(g.nblk):
        p = gather_patches(images, img_idx[i], pos[i], k)
        out.bank[i] = p
        out.centers[i] = patch_centers(p, k, c)
        out.pn[i] = (p * p).sum(dim=-1)
    del pos
    tick("sort and fill")
    out = out._replace(stats=block_stats(out.bank, img_idx < n))
    tick("stats")
    return out._replace(build_seconds=times)


def bank_cache_nbytes(n: int, h: int, w: int, c: int, k: int, target_block: int,
                      prune: bool = False) -> int:
    """Ledger bytes of a cached bank: `bank_nbytes`, plus each row's int32
    image index for a clustered bank (the stats are a few MB)."""
    nbytes = bank_nbytes(n, h, w, c, k, target_block)
    if prune:
        g = bank_geometry(n, h, w, c, k, target_block)
        nbytes += g.nblk * g.block * 4
    return nbytes


class BankCacheMixin:
    """Ledger-backed bank cache. The host class calls `_init_bank_cache` in
    its __init__ and gains `_bank(k)`."""

    def _init_bank_cache(self, *, target_block, bank_budget_bytes, bank_ledger,
                         prune: bool = False):
        self.target_block = target_block
        # exact block pruning (ops.prune): clustered cached banks and skip
        # masks per call
        self.prune = prune
        self.bank_ledger = (
            bank_ledger if bank_ledger is not None
            else BankLedger(bank_budget_bytes)
        )
        self._bank_cache = {}

    @property
    def bank_budget_bytes(self) -> int:
        """The budget of the module's ledger (shared with every module of
        that ledger); setting it retunes the ledger."""
        return self.bank_ledger.budget

    @bank_budget_bytes.setter
    def bank_budget_bytes(self, v: int) -> None:
        self.bank_ledger.budget = v

    def _bank(self, k: int):
        """The cached Bank (a ClusteredBank with `prune`) for kernel size k,
        or None if it does not fit the remaining ledger budget (the caller
        then streams; a miss is not cached, so a later call may find
        budget)."""
        if k in self._bank_cache:
            return self._bank_cache[k]
        n, h, w, c = self.images.shape
        nbytes = bank_cache_nbytes(n, h, w, c, k, self.target_block, self.prune)
        if not self.bank_ledger.try_reserve(nbytes):
            return None
        build = build_clustered_bank if self.prune else build_bank
        try:
            self._bank_cache[k] = build(self.images, k, self.target_block)
        except BaseException:
            self.bank_ledger.release(nbytes)  # a failed build must not starve
            raise                             # retries or ledger siblings
        return self._bank_cache[k]
