"""Shared scaffolding for the analytic score machines.

Counterpart of `convolutional_diffusion_tpu/scores/common.py`:

1. `SoftmaxState` — a running online-softmax accumulator (max / weighted-sum
   / weighted-value-sum) with an associative `update_state` and
   `merge_states`; empty entries hold m = -inf.
2. `image_weights` — per-image contribution weights reproducing the
   reference's DataLoader streaming: per-batch `mean` accumulation (weight
   1/n_kept(batch)), label filtering and each module's own `max_samples`
   cutoff rule (`CutoffRule`).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from ..ops.fp32 import fp32_einsum

NEG_INF = float("-inf")


class SoftmaxState(NamedTuple):
    """Running state of a weighted online softmax over a streamed bank.

    Shapes: m, s1: [*S]; s2: [*S, dv]. The softmax-weighted mean of the
    streamed values is s2/s1 (the max m cancels)."""

    m: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor


def init_state(shape, dv: int, dtype=torch.float32, device=None) -> SoftmaxState:
    shape = tuple(shape)
    return SoftmaxState(
        m=torch.full(shape, NEG_INF, dtype=dtype, device=device),
        s1=torch.zeros(shape, dtype=dtype, device=device),
        s2=torch.zeros((*shape, dv), dtype=dtype, device=device),
    )


def _rescale(m_old, m_new):
    """exp(m_old - m_new), with empty (-inf) states mapping to 0."""
    return torch.where(
        torch.isneginf(m_old), torch.zeros_like(m_old), torch.exp(m_old - m_new)
    )


def update_state(
    state: SoftmaxState,
    logits: torch.Tensor,  # [*S, P]
    weights: torch.Tensor,  # broadcastable to [*S, P]; 0 disables an entry
    values: Optional[torch.Tensor] = None,  # [*L, P, dv]; L = leading dims of S
) -> SoftmaxState:
    """Fold one bank block into the running softmax.

    `values` may share any number of LEADING state dims: shape [*L, P, dv]
    where L is a (possibly empty) prefix of S — a bank shared by all queries
    ([P, dv]), per-row banks ([R, P, dv] for S=(R, b, q)), or fully
    per-query values ([*S, P, dv])."""
    weights = torch.broadcast_to(weights, logits.shape)
    keep = weights > 0
    masked = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    m_new = torch.maximum(state.m, masked.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    e = torch.where(
        keep, weights * torch.exp(logits - m_safe[..., None]),
        torch.zeros_like(logits),
    )
    scale = _rescale(state.m, m_safe)
    s1 = state.s1 * scale + e.sum(dim=-1)
    if values is None:
        s2 = state.s2
    else:
        shared = values.ndim - 2  # leading S dims shared with values
        letters = "".join(chr(ord("A") + i) for i in range(shared))
        spec = f"{letters}...p,{letters}pv->{letters}...v"
        s2 = state.s2 * scale[..., None] + fp32_einsum(spec, e, values)
    return SoftmaxState(m=m_new, s1=s1, s2=s2)


def merge_states(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Associative combine of two partial softmax states."""
    m = torch.maximum(a.m, b.m)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    sa = _rescale(a.m, m_safe)
    sb = _rescale(b.m, m_safe)
    return SoftmaxState(
        m=m,
        s1=a.s1 * sa + b.s1 * sb,
        s2=a.s2 * sa[..., None] + b.s2 * sb[..., None],
    )


class CutoffRule(enum.Enum):
    """Which cumulative count the reference compares against max_samples.
    A chunk (reference DataLoader batch) is PROCESSED iff the stated
    cumulative count is <= max_samples.

    - FILTERED: cumulative label-filtered count including this batch
      (IdealScoreModule, LocalScoreModule).
    - UNFILTERED: cumulative raw batch sizes including this batch, counted
      BEFORE label filtering (LocalEquivScoreModule).
    - BATCH_QUOTA: batch i is processed iff i * batch_size <= max_samples
      (LocalEquivBordersScoreModule).
    """

    FILTERED = "filtered"
    UNFILTERED = "unfiltered"
    BATCH_QUOTA = "batch_quota"


class Weighting(enum.Enum):
    MEAN = "mean"  # torch.mean over the bank dim per batch (IS/LS/ELS)
    SUM = "sum"  # torch.sum (bbELS)


def image_weights(
    labels: torch.Tensor,  # [N] int
    label,  # scalar int or None
    *,
    batch_size: int,
    max_samples: Optional[int],
    cutoff: CutoffRule,
    weighting: Weighting,
    per_image_bank: int = 1,  # bank entries contributed per image
    order: Optional[torch.Tensor] = None,  # [N] stream order (DataLoader shuffle)
) -> torch.Tensor:
    """Per-image float32 weights [N] replicating reference DataLoader
    streaming, in CANONICAL image indexing whatever `order` is: images are
    consumed in chunks of `batch_size` in `order` (default: as stored); the
    weight of image i is include(i) / bank_size(batch of i) for MEAN, or
    include(i) for SUM, where bank_size counts label-kept entries in the
    image's batch times `per_image_bank`."""
    n = labels.shape[0]
    dev = labels.device
    if order is not None:
        order = torch.as_tensor(order, dtype=torch.long, device=dev)
        w_stream = image_weights(
            labels[order], label,
            batch_size=batch_size, max_samples=max_samples, cutoff=cutoff,
            weighting=weighting, per_image_bank=per_image_bank,
        )
        out = torch.zeros((n,), dtype=w_stream.dtype, device=dev)
        out[order] = w_stream
        return out
    batch_id = torch.arange(n, device=dev) // batch_size
    n_batches = -(-n // batch_size)

    if label is None:
        kept_f = torch.ones((n,), dtype=torch.float32, device=dev)
    else:
        kept_f = (labels == int(label)).to(torch.float32)
    batch_sizes = torch.bincount(batch_id, minlength=n_batches).to(torch.float32)
    batch_kept = torch.zeros((n_batches,), dtype=torch.float32, device=dev)
    batch_kept.index_add_(0, batch_id, kept_f)

    if max_samples is None:
        included = torch.ones((n_batches,), dtype=torch.bool, device=dev)
    elif cutoff == CutoffRule.FILTERED:
        included = torch.cumsum(batch_kept, 0) <= max_samples
    elif cutoff == CutoffRule.UNFILTERED:
        included = torch.cumsum(batch_sizes, 0) <= max_samples
    elif cutoff == CutoffRule.BATCH_QUOTA:
        included = torch.arange(n_batches, device=dev) * batch_size <= max_samples
    else:  # pragma: no cover
        raise ValueError(cutoff)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if weighting == Weighting.MEAN:
        denom = torch.clamp(batch_kept * per_image_bank, min=1.0)
        w_batch = torch.where(included, 1.0 / denom, zero)
    else:
        w_batch = torch.where(included, torch.ones_like(zero), zero)
    return kept_f * w_batch[batch_id]
