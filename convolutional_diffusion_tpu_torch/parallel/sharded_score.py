"""Dataset-sharded analytic score machines over a mesh.

Counterpart of `convolutional_diffusion_tpu/parallel/sharded_score.py`.
Each rank holds only its contiguous shard of the training set on its device
(the point of sharding is memory: a rank's bank cache and streams cover its
shard) and sweeps it through the online softmax with the same code as one
device: `els.patch_sweep` (the flash-score kernels on the card), the bbELS
border streams, the IS and LS sweeps. Image weights are computed GLOBALLY,
from the full label vector and the call's order (the same generator on every
rank), then sliced to the shard. After the local sweep the partial states
merge once per call with

    m_g  = max_r m,   s1_g = sum_r s1 e^{m - m_g},   s2_g = sum_r s2 e^{m - m_g}

(`merge_collective`: one all-reduce MAX and one SUM over the mesh axis for
all of a call's states), `scores.common.merge_states` as collectives. So a
sharded score equals the one-device score to fp rounding, and bit for bit in
a world of one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..scores.bbels import LocalEquivBordersScoreModule
from ..scores.common import SoftmaxState
from ..scores.els import LocalEquivScoreModule
from ..scores.ideal import IdealScoreModule
from ..scores.local import MAX_CHUNK, LocalScoreModule
from .mesh import Mesh, all_reduce

__all__ = [
    "Shard",
    "ShardedIdealScoreModule",
    "ShardedLocalEquivBordersScoreModule",
    "ShardedLocalEquivScoreModule",
    "ShardedLocalScoreModule",
    "merge_collective",
    "merge_states_collective",
    "shard_dataset",
    "shard_span",
]


def merge_states_collective(states, group=None) -> list:
    """Merge every rank's partial (m, s1, s2) states, -inf convention, with
    one all-reduce MAX of all the m's and one SUM of all the rescaled s1's
    and s2's. An entry that is empty (-inf) on a rank adds nothing there
    and produces no NaN (JAX's handling, `sharded_score.py:33-40`); empty
    on every rank it stays (-inf, 0, 0), as one device leaves it. Returns
    the merged states as `SoftmaxState`s."""
    ms = [st[0] for st in states]
    m_loc = torch.cat([m.reshape(-1) for m in ms])
    m_g = all_reduce(m_loc.clone(), "max", group)
    m_safe = torch.where(torch.isneginf(m_g), torch.zeros_like(m_g), m_g)
    scale = torch.where(torch.isneginf(m_loc), torch.zeros_like(m_loc),
                        torch.exp(m_loc - m_safe))
    parts, off = [], 0
    for m, s1, s2 in states:
        sc = scale[off:off + m.numel()].view(m.shape)
        off += m.numel()
        parts += [(s1 * sc).reshape(-1), (s2 * sc[..., None]).reshape(-1)]
    flat = all_reduce(torch.cat(parts), "sum", group)
    out, off, moff = [], 0, 0
    for m, s1, s2 in states:
        n1, n2 = s1.numel(), s2.numel()
        out.append(SoftmaxState(m_g[moff:moff + m.numel()].view(m.shape),
                                flat[off:off + n1].view(s1.shape),
                                flat[off + n1:off + n1 + n2].view(s2.shape)))
        moff += m.numel()
        off += n1 + n2
    return out


def merge_collective(m, s1, s2, group=None) -> SoftmaxState:
    """Cross-rank streaming-softmax merge of one state (the JAX package's
    `merge_collective(m, s1, s2, axis_name)`, over a process group)."""
    return merge_states_collective([(m, s1, s2)], group)[0]


class Shard(NamedTuple):
    """A rank's span of the image set: real images [lo, hi), held as `size`
    rows (the tail past hi - lo zero padding, weighted 0)."""

    lo: int
    hi: int
    size: int


def shard_span(n: int, mesh: Mesh, axis: str = "data", chunk: int = 1) -> Shard:
    """This rank's contiguous span of n images: n padded up to whole chunks
    on every rank (a multiple of n_ranks * chunk, as JAX pads to
    n_dev * cs), cut into equal spans."""
    ranks, r = mesh.axis_size(axis), mesh.axis_rank(axis)
    size = -(-n // (ranks * chunk)) * chunk
    lo = min(r * size, n)
    return Shard(lo, min(lo + size, n), size)


def _take(a, span: Shard, fill):
    """Rows [lo, hi) of `a` (numpy or tensor), padded with `fill` to
    span.size rows."""
    part = a[span.lo:span.hi]
    pad = span.size - part.shape[0]
    if not pad:
        return part
    if isinstance(part, torch.Tensor):
        return torch.cat([part, part.new_full((pad, *part.shape[1:]), fill)])
    return np.concatenate([part, np.full((pad, *part.shape[1:]), fill, part.dtype)])


def shard_dataset(images, labels, mesh: Mesh, axis: str = "data", chunk: int = 1):
    """This rank's shard of a dataset: its contiguous span of the images
    and labels (`shard_span`), padded to whole chunks with zero images and
    label -1 (which no label filter selects). numpy or tensors, as given."""
    span = shard_span(len(labels), mesh, axis, chunk)
    return _take(images, span, 0), _take(labels, span, -1)


class _Sharded:
    """The sharding of a score module: holds the rank's image shard and the
    full labels, slices the global weights to the shard and merges the
    partial states over the mesh axis."""

    def __init__(self, dataset, *, mesh: Mesh, axis: str = "data", shard: Shard = None,
                 **kw):
        """dataset: the full (images, labels) (each rank takes its span), or
        with `shard` the rank's images already cut to that span and the full
        labels. The device defaults to the mesh's."""
        self.mesh, self.axis = mesh, axis
        images, labels = dataset
        if shard is None:
            shard = shard_span(len(labels), mesh, axis, self._shard_chunk(kw))
            images = _take(images, shard, 0)
        self.shard = shard
        kw.setdefault("device", mesh.device)
        super().__init__((images, labels), **kw)

    @staticmethod
    def _shard_chunk(kw) -> int:
        return 1

    def _local_weights(self, w):
        lo, hi, size = self.shard
        return F.pad(w[..., lo:hi], (0, size - (hi - lo)))

    def _merge(self, states) -> list:
        return merge_states_collective(states, self.mesh.group(self.axis))


class ShardedLocalEquivScoreModule(_Sharded, LocalEquivScoreModule):
    """ELS with the training set sharded over a mesh axis: each rank sweeps
    its shard (its own bank cache and ledger, or streamed) with the ELS
    module's kernels and the states merge once per call. Semantics of
    LocalEquivScoreModule. Per-seed label vectors are the one-device bank
    mode's (one global weight vector per call here): the pipeline groups
    seeds by label."""

    supports_vector_label = False


class ShardedLocalEquivBordersScoreModule(_Sharded, LocalEquivBordersScoreModule):
    """bbELS with the training set sharded over a mesh axis: the center
    region and every border family (rows, columns, corners) merge across
    ranks in one pair of collectives. Semantics of
    LocalEquivBordersScoreModule; its LS fallback (k >= the image height)
    is sharded too."""

    def _make_local_fallback(self, **kw):
        return ShardedLocalScoreModule((self.images, self.labels), mesh=self.mesh,
                                       axis=self.axis, shard=self.shard, **kw)


class ShardedIdealScoreModule(_Sharded, IdealScoreModule):
    """IS with the training set sharded over a mesh axis: each rank sweeps
    its images, then the per-seed states merge. Semantics of
    IdealScoreModule (weights global, FILTERED cutoff)."""

    @staticmethod
    def _shard_chunk(kw) -> int:
        return kw.get("chunk_size") or kw.get("batch_size", 128)


class ShardedLocalScoreModule(_Sharded, LocalScoreModule):
    """LS with the training set sharded over a mesh axis: each rank
    box-filters and sweeps its images, then the per-pixel states merge.
    Semantics of LocalScoreModule, its shuffle=True default included: the
    permutation is drawn globally, from the same generator on every rank."""

    @staticmethod
    def _shard_chunk(kw) -> int:
        return min(kw.get("chunk_size") or kw.get("batch_size", 256), MAX_CHUNK)
