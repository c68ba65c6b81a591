"""LocalEquivBordersScoreModule (bbELS): ELS under zeros boundary conditions.

Counterpart of `convolutional_diffusion_tpu/scores/bbels.py`. With zeros
padding, translation equivariance is broken at the borders: a pixel whose
k x k window hangs off the image can only match training windows at the SAME
offset relative to the border. Zero-pad x and the training images by
p = k // 2 and take the k x k window at every pixel; classify each position
by (row class, col class), where a row within p of a border is its own class
and every other row is 'center'. A pixel of x attends exactly over training
windows whose position has the same class pair:

  - (center, center): all interior positions, which are the valid k x k
    patches of the images: the ELS bank. This region runs through the
    flash-score sweep (`els.patch_sweep`: the cached bank where the ledger
    holds it, else streamed chunk by chunk; on the card kernel K1 at
    'highest', K2 at 'high', K3/K4 at 'default', with the ELS module's
    value-strategy rule: 'inbank' at 'default' where d padded to 128 is
    at most 128, else 'auto', which takes the matrix value sums 'mxu'
    past 8 channels);
  - (border row r, center): the windows at row r, any interior column;
  - (center, border col): symmetric;
  - (border, border): the single window at that exact position of each
    training image.

The border regions stream the images in chunks of their own, sized so that
one chunk's windows and logits take at most `BORDER_CHUNK_BYTES`, in plain
tensor code: true fp32 dots (`ops.fp32.fp32_einsum`) and the online
softmax of `common.update_state`, at every tier, 'default' included: the
JAX package's border einsums never take a pure-bf16 dot
(`bbels.py:155-162`) and run in fp32 on the CPU, and its bf16 exp lives
only in the flash-score kernel. A chunk's border windows are one gather
at the border positions (`_border_positions`). The 2p border-row bands
are one batch, the 2p border-column bands another, the four corners one
batch of 4p^2 positions.
Each step's border regions lie inside one `bbels.borders` profiler range.

Parity notes, as in the JAX package: accumulation is SUM, the max_samples
cutoff is the batch quota (batch i runs iff i * batch_size <= max_samples),
x may hold several seeds, and for k >= the image height the module falls
back to a zeros-mode LocalScoreModule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fp32 import fp32_einsum
from ..ops.patches import center_index, extract_patches, pad_image, window_view
from ..utils.profiling import annotate
from .bank import BankCacheMixin, bank_geometry
from .base import ScoreModuleBase
from .common import (
    CutoffRule,
    SoftmaxState,
    Weighting,
    _rescale,
    image_weights,
    init_state,
    update_state,
)
from .els import DEFAULT_BANK_BUDGET, patch_sweep
from .local import LocalScoreModule


# Device memory that one chunk of the border regions' windows and logits
# may take: at 64 x 64, 4 seeds and 1000 images, a call of the 20-step
# CelebA schedule runs ~35 border chunks, 12 of them at k = 27. The
# chunk's peak lies above it: while one band batch runs, the squares that
# give its windows' norms take up to one more of its windows' size, and
# `update_state` holds about five of its logits' size at once (the logits,
# the masked logits, the weighted exponentials, zeros, e). So the peak
# nears twice this where the windows dominate (large k) and up to about
# five times it where the logits do (small k, many images or seeds).
BORDER_CHUNK_BYTES = 2 << 30


def _border_positions(h: int, w: int, p: int) -> tuple[list, list]:
    """(rows, cols) of the border positions, in the order the states keep
    them: the top then the bottom band over the interior columns (2p bands
    of w-2p), the left then the right band over the interior rows (2p bands
    of h-2p), then the corners (top-left, top-right, bottom-left,
    bottom-right, each p x p in row-major order)."""
    edge_r, edge_c = [*range(p), *range(h - p, h)], [*range(p), *range(w - p, w)]
    inner_r, inner_c = range(p, h - p), range(p, w - p)
    rows = [r for r in edge_r for _ in inner_c] + [r for _ in edge_c for r in inner_r]
    cols = [c for _ in edge_r for c in inner_c] + [c for c in edge_c for _ in inner_r]
    for rr in (edge_r[:p], edge_r[p:]):
        for cc in (edge_c[:p], edge_c[p:]):
            rows += [r for r in rr for _ in cc]
            cols += [c for _ in rr for c in cc]
    return rows, cols


def _border_chunk(n: int, h: int, w: int, c: int, k: int, b: int) -> int:
    """Images a border chunk: as many of the n as keep the chunk's windows
    and its logits for b seeds within `BORDER_CHUNK_BYTES`."""
    p = k // 2
    hc, wc = h - 2 * p, w - 2 * p
    windows = (2 * p * (wc + hc) + 4 * p * p) * k * k * c
    logits = b * (2 * p * (wc * wc + hc * hc) + 4 * p * p)
    return max(1, min(n, BORDER_CHUNK_BYTES // (4 * (windows + logits))))


def _windows_at(padded: torch.Tensor, k: int, rows: torch.Tensor, cols: torch.Tensor):
    """The k x k windows of zero-padded images [n, h+2p, w+2p, c] at the
    positions (rows, cols) [npos], as [npos, n, k*k*c]: one gather."""
    v = window_view(padded, k).permute(1, 2, 0, 3, 4, 5)
    return v[rows, cols].reshape(rows.shape[0], padded.shape[0], -1)


def _logits(q, qn, bank, pn, at, beta2, spec):
    """-(|q|^2 - 2 a <q, p> + a^2 |p|^2) / (2 beta^2) with fp32 dots,
    computed in place of the dots; qn and pn broadcast against them."""
    return fp32_einsum(spec, q, bank).mul_(2.0 * at).sub_(qn).sub_(at**2 * pn).div_(beta2)


def _fold(st: SoftmaxState, dim: int) -> SoftmaxState:
    """The states along `dim` merged into one (empty: m = -inf)."""
    m = st.m.amax(dim=dim, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    scale = _rescale(st.m, m_safe)
    return SoftmaxState(m.squeeze(dim), (st.s1 * scale).sum(dim),
                        (st.s2 * scale[..., None]).sum(dim))


class LocalEquivBordersScoreModule(BankCacheMixin, ScoreModuleBase):
    """bbELS score module. The center region's bank is cached per k on the
    module's device while the ledger budget lasts (as the ELS module's: the
    same bank) and streamed otherwise; the border regions always stream."""

    def __init__(
        self,
        dataset,
        *,
        batch_size: int = 64,
        target_block: int = 65536,
        bank_budget_bytes: int = DEFAULT_BANK_BUDGET,
        bank_ledger=None,
        **kw,
    ):
        super().__init__(dataset, batch_size=batch_size, **kw)
        # pruning is the ELS bank mode's only, as in the JAX package
        # (`bbels.py:74-77`): the center region sweeps a plain bank
        self._init_bank_cache(
            target_block=target_block, bank_budget_bytes=bank_budget_bytes,
            bank_ledger=bank_ledger, prune=False,
        )
        self._local_fallback_cache = None
        self._positions = {}  # k -> the border positions on the device

    @property
    def _local_fallback(self) -> LocalScoreModule:
        """k >= the image height falls back to a zeros-mode
        LocalScoreModule, as the reference does. Built at the first such k;
        it shares this module's image and label tensors and its
        generator."""
        if self._local_fallback_cache is None:
            self._local_fallback_cache = self._make_local_fallback(
                kernel_size=self.kernel_size,
                batch_size=self.batch_size,
                schedule=self.schedule,
                max_samples=self.max_samples,
                precision=self.precision,
                generator=self._generator,
                device=self.device,
            )
        return self._local_fallback_cache

    def _make_local_fallback(self, **kw) -> LocalScoreModule:
        return LocalScoreModule((self.images, self.labels), **kw)

    def __call__(self, t, x, label=None, k=None, order=None):
        k = self._check_k(k)
        if label is not None and np.ndim(label) >= 1:
            raise ValueError(
                "LocalEquivBordersScoreModule takes a scalar label per call; "
                "group seeds by label instead"
            )
        if k >= self.images.shape[1]:
            return self._local_fallback(t, x, label=label, k=k, order=order)
        return super().__call__(t, x, label=label, k=k, order=order)

    def _border_index(self, k: int):
        """(rows, cols), int64 [npos] on the module's device: the border
        positions of kernel size k (`_border_positions`), made once per k."""
        if k not in self._positions:
            _, h, w, _ = self.images.shape
            self._positions[k] = tuple(torch.tensor(i, device=self.device)
                                       for i in _border_positions(h, w, k // 2))
        return self._positions[k]

    def _border_states(self, x, k, w_img, at, bt):
        """The border regions' states (rows, columns, corners), the images
        streamed in border chunks (`_border_chunk`). A band batch keeps one
        state per key position of its bands and folds them at the end, so
        that a chunk's value sums run over its images, not over all its
        windows of a band: one fp32 dot over the 62000 windows of a chunk
        of 1000 images at k = 3 summed ~10x less exactly on the card."""
        n, h, w, c = self.images.shape
        b = x.shape[0]
        p = k // 2
        ctr = center_index(k, c)
        rows, cols = self._border_index(k)
        batches = [(0, w - 2 * p), (2 * p * (w - 2 * p), h - 2 * p)]  # (start, L)
        nband = 2 * p * (h + w - 4 * p)  # positions in the bands
        q = _windows_at(pad_image(x, p, "zeros"), k, rows, cols)  # [npos, b, d]
        qs = [q[s : s + 2 * p * L].view(2 * p, L, b, -1).transpose(1, 2).contiguous()
              for s, L in batches]  # [2p, b, L, d]: rows, then columns
        qn = [(t * t).sum(dim=-1)[:, None, :, :, None] for t in qs]
        states = [init_state((2 * p, L, b, L), c, device=self.device) for _, L in batches]
        qs.append(q[nband:])  # [4p^2, b, d]
        qn.append((q[nband:] * q[nband:]).sum(dim=-1)[..., None])
        states.append(init_state((4 * p * p, b), c, device=self.device))
        specs = ["rbqd,rlpd->rlbqp"] * len(batches) + ["rbd,rpd->rbp"]
        beta2 = 2.0 * bt**2
        cs = _border_chunk(n, h, w, c, k, b)
        for i0 in range(0, n, cs):
            keys = _windows_at(pad_image(self.images[i0 : i0 + cs], p, "zeros"),
                               k, rows, cols)  # [npos, cs, d]
            groups = [keys[s : s + 2 * p * L].view(2 * p, L, keys.shape[1], -1)
                      for s, L in batches]  # [2p, key positions, cs, d]
            groups.append(keys[nband:])  # [4p^2, cs, d]
            for j, kb in enumerate(groups):
                pn = (kb * kb).sum(dim=-1)
                pn = pn[:, :, None, None, :] if kb.ndim == 4 else pn[:, None, :]
                states[j] = update_state(
                    states[j], _logits(qs[j], qn[j], kb, pn, at, beta2, specs[j]),
                    w_img[i0 : i0 + cs], kb[..., ctr],
                )
        # rows and columns, each folded over its key positions
        return [_fold(states[0], 1), _fold(states[1], 1), states[2]]

    def _score(self, k, x, label, at, bt, order):
        n, h, w, c = self.images.shape
        b = x.shape[0]
        p = k // 2
        hc, wc = h - 2 * p, w - 2 * p
        g = bank_geometry(n, h, w, c, k, self.target_block)
        w_img = self._local_weights(image_weights(
            self.labels, label,
            batch_size=self.batch_size, max_samples=self.max_samples,
            cutoff=CutoffRule.BATCH_QUOTA, weighting=Weighting.SUM, order=order,
        ))

        # center: the ELS sweep over the valid patches
        qc = extract_patches(x, k).reshape(b * hc * wc, g.d)
        center = patch_sweep(self, k, qc, (qc * qc).sum(dim=-1), w_img, at, bt)
        borders = []
        if p:
            with annotate("bbels.borders"):
                borders = self._border_states(x, k, w_img, at, bt)
        (_, s1, s2), *borders = self._merge([center, *borders])
        mean = torch.empty_like(x)
        mean[:, p : h - p, p : w - p] = (s2 / s1[:, None]).reshape(b, hc, wc, c)
        if p == 0:
            return -(x - at * mean) / (bt**2)
        st_rows, st_cols, st_corners = borders

        def mean_of(st):
            return st.s2 / st.s1[..., None]

        m_rows = mean_of(st_rows).transpose(0, 1)  # [b, 2p, wc, c]
        mean[:, :p, p : w - p] = m_rows[:, :p]
        mean[:, h - p :, p : w - p] = m_rows[:, p:]
        m_cols = mean_of(st_cols).permute(1, 2, 0, 3)  # [b, hc, 2p, c]
        mean[:, p : h - p, :p] = m_cols[:, :, :p]
        mean[:, p : h - p, w - p :] = m_cols[:, :, p:]
        m_corners = mean_of(st_corners).transpose(0, 1)  # [b, 4p^2, c]
        m_corners = m_corners.reshape(b, 2, 2, p, p, c)
        for i, r in enumerate((slice(0, p), slice(h - p, h))):
            for j, c_ in enumerate((slice(0, p), slice(w - p, w))):
                mean[:, r, c_] = m_corners[:, i, j]
        return -(x - at * mean) / (bt**2)
