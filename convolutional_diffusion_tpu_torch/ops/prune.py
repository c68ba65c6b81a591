"""Exact block pruning for the flash-score sweep (kernel variant K6).

Counterpart of `convolutional_diffusion_tpu/ops/prune.py`. At low noise the
ELS posterior is a near-argmax patch selector: every bank patch p with

    logit(q, p) - max_p' logit(q, p') < -THR      (log2 units)

carries a weight that is exactly 0 in fp32 (exp2(x) == 0 for x < -150), so a
whole (query block, bank block) cell of such pairs can be skipped without
changing the result. The logit is a scaled negative squared distance,

    logit(q, p) = -||q - a_t p||^2 / (2 beta_t^2) * log2(e) + log2 w_p,

so per-block (centroid, radius) statistics bound it by the triangle
inequality, per query row q and bank block b:

    upper(q, b) = -max(0, ||q - a_t c_b|| - a_t r_b)^2 * s + max log2 w over b
    lower(q)    = max_b -(||q - a_t c_b|| + a_t r_b)^2 * s + min log2 w over b

(`lower` is reached by some included patch of the best block, so the row's
true max is at least `lower`). A cell is skipped when every row's upper
bound is below every row's lower bound minus THR + BOUND_MARGIN.

The bounds only bite when bank blocks are spatially coherent, so a pruned
bank is stored in clustered order (`scores.bank.build_clustered_bank`):
k-means centers fitted on a strided sample of the patches, every patch
assigned to its nearest center, patches stably sorted by cluster id. Any
order of the bank gives the same softmax sums up to fp32 summation order,
because the weights follow each row's image index.

THR defaults to DEFAULT_THR = 152: every skipped pair's weight would be
exactly 0 in fp32 even against the row's final max, so pruning is exact up
to the rescale roundings (a skipped tile that would have raised the running
max early changes where the running sums are rescaled). A smaller `thr`
prunes more at a relative error of at most sum(w) * 2^-thr / s1.

Geometry: the mask's cell is PRUNE_ROWS query rows by PRUNE_BLOCK bank rows
(`ops._build`, which passes both to the kernels), so a mask is int32
[ceil(M / PRUNE_ROWS), ceil(P / PRUNE_BLOCK)] per bank chunk; the stats
blocks are the JAX package's PRUNE_BLOCK, each chunk padded to a whole
block. Every bound is computed in true fp32 (`fp32.true_fp32`): the
scale s reaches ~120 at low noise, where a TF32 rounding of q . c would move
a bound by tens of log2 units against a margin of 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import PRUNE_BLOCK, PRUNE_ROWS
from .fp32 import true_fp32

LOG2E = 1.4426950408889634
NEG_INF = -1e30
# default skip threshold (log2 units): exp2(-152) is exactly 0 in fp32
DEFAULT_THR = 152.0
# fp32 slack on the bound arithmetic (distances of order 30, squared and
# scaled by up to ~120: absolute error of order 1e-2; 1.0 is 100x that)
BOUND_MARGIN = 1.0
# rows per product of the k-means and assign steps: the transient is
# [CHUNK_ROWS, n_centers] fp32 (256 MiB at 4096 centers)
CHUNK_ROWS = 16384
# query rows per centroid-distance product of `prune_masks` (a multiple of
# PRUNE_ROWS): the transient is a few [MASK_ROWS, J] fp32 arrays
MASK_ROWS = 1024

__all__ = [
    "LOG2E", "DEFAULT_THR", "BOUND_MARGIN", "PRUNE_BLOCK", "PRUNE_ROWS",
    "BankBlockStats", "strided_ids", "kmeans_centers", "assign_clusters",
    "block_stats", "prune_masks", "logw_block_stats",
]


class BankBlockStats(NamedTuple):
    """Per stats block (PRUNE_BLOCK bank rows) geometry, flattened over
    (chunk, block of the chunk); rows of padding images are left out."""

    centroids: torch.Tensor  # [J, d] mean of the valid rows (0 if none)
    radii: torch.Tensor  # [J] max ||p - centroid|| over the valid rows
    valid: torch.Tensor  # [J] bool: the block has at least one valid row


def strided_ids(n: int, count: int, device=None) -> torch.Tensor:
    """`count` evenly strided ids in 0 .. n-1, as the JAX package takes them:
    jnp.linspace(0, n - 1, count).astype(int32), i.e. (n - 1) * (i / div)
    in float32, truncated, with the last id n - 1 exactly."""
    if count == 1:
        return torch.zeros(1, dtype=torch.long, device=device)
    div = count - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    stop = torch.tensor(float(n - 1), dtype=torch.float32, device=device)
    return torch.cat([stop * step, stop[None]]).long()


def _nearest(rows: torch.Tensor, centers: torch.Tensor, cn: torch.Tensor):
    """Index of each row's nearest center, by argmin |c|^2 - 2 <p, c> in
    fp32 (the first of equal minima, as jnp.argmin)."""
    with true_fp32():
        return torch.argmin(cn[None, :] - 2.0 * (rows @ centers.T), dim=1)


def kmeans_centers(sample: torch.Tensor, n_centers: int, *, iters: int = 8
                   ) -> torch.Tensor:
    """Lloyd's k-means on a patch sample [S, d] -> centers [n_centers, d].
    Initialised with evenly strided sample rows (the sample is image-major,
    so the strides land on distinct images); a cluster left empty keeps its
    center. The distances and the per-cluster sums go CHUNK_ROWS rows at a
    time. The sums are one-hot
    products in fp32, which sum in a fixed order on the card (an atomic
    index_add would not)."""
    S, d = sample.shape
    centers = sample[strided_ids(S, n_centers, sample.device)]
    for _ in range(iters):
        cn = (centers * centers).sum(dim=1)
        sums = torch.zeros_like(centers)
        cnts = torch.zeros(n_centers, dtype=torch.float32, device=sample.device)
        for i0 in range(0, S, CHUNK_ROWS):
            sc = sample[i0 : i0 + CHUNK_ROWS]
            onehot = torch.zeros((sc.shape[0], n_centers), dtype=torch.float32,
                                 device=sample.device)
            onehot.scatter_(1, _nearest(sc, centers, cn)[:, None], 1.0)
            with true_fp32():
                sums += onehot.T @ sc
            cnts += onehot.sum(dim=0)
        centers = torch.where(cnts[:, None] > 0,
                              sums / torch.clamp(cnts, min=1.0)[:, None], centers)
    return centers


def assign_clusters(rows: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center id of each row of `rows` [N, d] -> [N] int32,
    CHUNK_ROWS rows at a time."""
    cn = (centers * centers).sum(dim=1)
    ids = torch.empty(rows.shape[0], dtype=torch.int32, device=rows.device)
    for i0 in range(0, rows.shape[0], CHUNK_ROWS):
        ids[i0 : i0 + CHUNK_ROWS] = _nearest(rows[i0 : i0 + CHUNK_ROWS], centers, cn)
    return ids


def _blocks(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x with its axis `dim` (a chunk's B rows) zero-padded to a whole
    number of stats blocks and split into [ceil(B / PRUNE_BLOCK),
    PRUNE_BLOCK]."""
    dim %= x.ndim
    B = x.shape[dim]
    npb = -(-B // PRUNE_BLOCK)
    x = F.pad(x, [0, 0] * (x.ndim - 1 - dim) + [0, npb * PRUNE_BLOCK - B])
    return x.unflatten(dim, (npb, PRUNE_BLOCK))


@torch.no_grad()
def block_stats(bank: torch.Tensor, row_valid: torch.Tensor) -> BankBlockStats:
    """Per stats block (centroid, radius) over a bank [nblk, B, d] whose
    valid rows are `row_valid` [nblk, B] (False for padding images' rows).
    Each chunk is padded to a whole number of blocks, so block j of chunk i
    covers chunk rows j * PRUNE_BLOCK .. (j + 1) * PRUNE_BLOCK - 1. One
    chunk at a time."""
    nblk, B, d = bank.shape
    cents, rads, valids = [], [], []
    for i in range(nblk):
        p = _blocks(bank[i], 0)  # [npb, PRUNE_BLOCK, d]
        ok = _blocks(row_valid[i].float(), 0)  # [npb, PRUNE_BLOCK]
        cnt = ok.sum(dim=1)
        cent = (p * ok[:, :, None]).sum(dim=1) / torch.clamp(cnt, min=1.0)[:, None]
        dist2 = ((p - cent[:, None, :]) ** 2).sum(dim=2)
        rads.append(torch.sqrt((dist2 * ok).amax(dim=1)))
        cents.append(cent)
        valids.append(cnt > 0)
    return BankBlockStats(torch.cat(cents), torch.cat(rads), torch.cat(valids))


@torch.no_grad()
def logw_block_stats(w: torch.Tensor):
    """Per stats block (max log2 w, min log2 w over the included rows,
    whether any row is included) from per-row weights w [nblk, B]
    (included: w > 0); each [nblk * ceil(B / PRUNE_BLOCK)]."""
    wb = _blocks(w, 1)
    inc = wb > 0.0
    logw = torch.where(inc, torch.log2(torch.clamp(wb, min=1e-38)),
                       torch.full_like(wb, NEG_INF))
    lmax = logw.amax(dim=2).reshape(-1)
    lmin = torch.where(inc, logw, torch.full_like(wb, -NEG_INF)).amin(dim=2).reshape(-1)
    any_inc = inc.any(dim=2).reshape(-1)
    lmin = torch.where(any_inc, lmin, torch.full_like(lmin, NEG_INF))
    return lmax, lmin, any_inc


@torch.no_grad()
def prune_masks(
    q: torch.Tensor,  # [M, d] query windows
    qn: torch.Tensor,  # [M] ||q||^2
    at,  # scalar sqrt(1 - beta)
    bt,  # scalar sqrt(beta)
    stats: BankBlockStats,
    logw_max: torch.Tensor,  # [J] per-block max log2 w over included rows
    logw_min: torch.Tensor,  # [J] per-block min log2 w over included rows
    any_included: torch.Tensor,  # [J] bool
    *,
    thr: float | None = None,
) -> torch.Tensor:
    """int32 skip mask [M / PRUNE_ROWS, J]: 1 = every pair of the (query
    block, bank block) cell has a weight that is exactly 0 in fp32, 0 =
    compute. One [M, J] centroid-distance product in fp32, MASK_ROWS query
    rows at a time."""
    if thr is None:
        thr = DEFAULT_THR
    M, d = q.shape
    if M % PRUNE_ROWS:
        raise ValueError(f"M={M} not a multiple of PRUNE_ROWS={PRUNE_ROWS}")
    dev = q.device
    at = torch.as_tensor(at, dtype=torch.float32).to(dev)
    bt = torch.as_tensor(bt, dtype=torch.float32).to(dev)
    s = (1.0 / (2.0 * bt * bt)) * LOG2E
    atr = at * stats.radii  # [J]
    cn = (stats.centroids * stats.centroids).sum(dim=1)  # [J]
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    u_bias = torch.where(stats.valid, logw_max, neg_inf)
    l_ok = stats.valid & any_included
    l_bias = torch.where(l_ok, logw_min, neg_inf)
    out = torch.empty((M // PRUNE_ROWS, cn.shape[0]), dtype=torch.int32, device=dev)
    for r0 in range(0, M, MASK_ROWS):
        qb, qnb = q[r0 : r0 + MASK_ROWS], qn[r0 : r0 + MASK_ROWS]
        with true_fp32():
            qc = qb @ stats.centroids.T
        d2 = qnb[:, None] - 2.0 * at * qc + (at * at) * cn[None, :]
        dist = torch.sqrt(torch.clamp(d2, min=0.0))  # [rows, J] = ||q - at c||
        lo = torch.clamp(dist - atr[None, :], min=0.0)
        hi = dist + atr[None, :]
        upper = -(lo * lo) * s + u_bias[None, :]
        lower_row = torch.where(l_ok[None, :], -(hi * hi) * s + l_bias[None, :],
                                neg_inf).amax(dim=1)
        u_blk = upper.view(-1, PRUNE_ROWS, upper.shape[1]).amax(dim=1)  # [nq, J]
        l_blk = lower_row.view(-1, PRUNE_ROWS).amin(dim=1)  # [nq]
        out[r0 // PRUNE_ROWS : (r0 + qb.shape[0]) // PRUNE_ROWS] = (
            u_blk < (l_blk - thr - BOUND_MARGIN)[:, None]).int()
    return out
