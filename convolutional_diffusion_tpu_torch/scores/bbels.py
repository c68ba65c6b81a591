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

The border regions stream the images chunk by chunk (the bank geometry's
chunk) in plain tensor code: true fp32 dots (`ops.fp32.fp32_einsum`) and the
online softmax of `common.update_state`, at every tier, 'default'
included: the JAX package's border einsums never take a pure-bf16 dot
(`bbels.py:155-162`) and run in fp32 on the CPU, and its bf16 exp lives
only in the flash-score kernel. The two border-row bands are one
batch of 2p row regions, the two border-column bands another, the four
corners one batch of 4p^2 positions.

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
from .bank import BankCacheMixin, bank_geometry
from .base import ScoreModuleBase
from .common import CutoffRule, Weighting, image_weights, init_state, update_state
from .els import DEFAULT_BANK_BUDGET, patch_sweep
from .local import LocalScoreModule


def _border_windows(padded: torch.Tensor, h: int, w: int, p: int, k: int):
    """The border-region windows of zero-padded images [n, h+2p, w+2p, c],
    region-major, each set one concatenation of window-view slices: rows
    [2p, n, w-2p, d] (top band then bottom band, interior columns), cols
    [2p, n, h-2p, d] (left then right, interior rows) and corners
    [4p^2, n, d] (top-left, top-right, bottom-left, bottom-right, each p x p
    in row-major order)."""
    n = padded.shape[0]
    v = window_view(padded, k)  # [n, h, w, k, k, c]
    top, bottom = slice(0, p), slice(h - p, h)
    left, right = slice(0, p), slice(w - p, w)
    rows = torch.cat([v[:, r, p : w - p].transpose(0, 1) for r in (top, bottom)])
    cols = torch.cat([v[:, p : h - p, c_].permute(2, 0, 1, 3, 4, 5)
                      for c_ in (left, right)])
    corners = torch.cat([v[:, r, c_].permute(1, 2, 0, 3, 4, 5)
                         for r in (top, bottom) for c_ in (left, right)])
    return (rows.reshape(2 * p, n, w - 2 * p, -1),
            cols.reshape(2 * p, n, h - 2 * p, -1),
            corners.reshape(4 * p * p, n, -1))


def _logits(q, qn, bank, pn, at, beta2, spec):
    """-(|q|^2 - 2 a <q, p> + a^2 |p|^2) / (2 beta^2) with fp32 dots."""
    dots = fp32_einsum(spec, q, bank)
    pn = pn.reshape(pn.shape[0], *([1] * (dots.ndim - 2)), pn.shape[-1])
    return -(qn[..., None] - 2.0 * at * dots + at**2 * pn) / beta2


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

    def _border_states(self, x, k, w_img, at, bt, g):
        """The border regions' states (rows, columns, corners), the images
        streamed chunk by chunk."""
        n, h, w, c = self.images.shape
        b = x.shape[0]
        p = k // 2
        hc, wc = h - 2 * p, w - 2 * p
        ctr = center_index(k, c)
        q_rows, q_cols, q_corners = _border_windows(
            pad_image(x, p, "zeros"), h, w, p, k
        )  # [2p, b, wc, d], [2p, b, hc, d], [4p^2, b, d]
        qn = [(q * q).sum(dim=-1) for q in (q_rows, q_cols, q_corners)]
        st_rows = init_state((2 * p, b, wc), c, device=self.device)
        st_cols = init_state((2 * p, b, hc), c, device=self.device)
        st_corners = init_state((4 * p * p, b), c, device=self.device)
        beta2 = 2.0 * bt**2
        for i0 in range(0, n, g.cs):
            imgs = self.images[i0 : i0 + g.cs]
            w_c = w_img[i0 : i0 + g.cs]
            cs = imgs.shape[0]
            rows, cols, corners = _border_windows(
                pad_image(imgs, p, "zeros"), h, w, p, k
            )
            rows = rows.reshape(2 * p, cs * wc, g.d)
            cols = cols.reshape(2 * p, cs * hc, g.d)
            st_rows = update_state(
                st_rows,
                _logits(q_rows, qn[0], rows, (rows * rows).sum(-1), at, beta2,
                        "rbqd,rpd->rbqp"),
                w_c.repeat_interleave(wc), rows[..., ctr],
            )
            st_cols = update_state(
                st_cols,
                _logits(q_cols, qn[1], cols, (cols * cols).sum(-1), at, beta2,
                        "rbqd,rpd->rbqp"),
                w_c.repeat_interleave(hc), cols[..., ctr],
            )
            st_corners = update_state(
                st_corners,
                _logits(q_corners, qn[2], corners, (corners * corners).sum(-1),
                        at, beta2, "rbd,rpd->rbp"),
                w_c, corners[..., ctr],
            )
        return [st_rows, st_cols, st_corners]

    @torch.no_grad()
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
        borders = self._border_states(x, k, w_img, at, bt, g) if p else []
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
