"""Plain PyTorch reference of the bbELS score (ELS under zeros boundaries).

x and the bank images are zero-padded by p = k // 2. A row is its own class
when it lies within p of the top or bottom border, and the rows between
form one class 'center'; columns likewise. A pixel of x looks at its k x k
window and its candidates are the windows of every bank image at the
positions of the same (row class, column class): the valid patches for a
center pixel, the windows along its own border row (or column) for a pixel
of a border band, and the one window at the same position for a corner
pixel. Candidates weigh their image's weight (the 'batch_quota' cutoff,
'sum' weighting) times exp(-|window - candidate|^2 / (2 beta)); the
posterior mean of their center pixels gives the score -(x - a mean) / beta.
Images of weight 0 are left out, which changes nothing.

`mode` rounds the products of the center class; the border classes take
the configuration's `border_dots` (the program runs them in plain fp32 at
every tier), or `mode` itself where that is the TF32 control.
"""

from __future__ import annotations

import torch

from .common import (
    CHUNK_ROWS,
    Posterior,
    center,
    coefficients,
    image_weights,
    logits,
    windows,
    zeros_pad,
)


def _groups(h: int, w: int, p: int, device) -> list:
    """The position classes in groups of one shape, each as (rows, cols)
    index tensors [G, m]: class g of a group is the m positions (rows[g],
    cols[g]). Center; the 2p border rows over the center columns; the
    center rows at each of the 2p border columns; the 4p^2 corner
    positions alone."""
    border_r = [*range(p), *range(h - p, h)]
    border_c = [*range(p), *range(w - p, w)]
    rc, cc = torch.arange(p, h - p), torch.arange(p, w - p)
    groups = [(rc.repeat_interleave(len(cc))[None], cc.repeat(len(rc))[None])]
    if p:
        br, bc = torch.tensor(border_r), torch.tensor(border_c)
        groups += [(br[:, None].expand(-1, len(cc)), cc[None].expand(len(br), -1)),
                   (rc[None].expand(len(bc), -1), bc[:, None].expand(-1, len(rc))),
                   (br.repeat_interleave(len(bc))[:, None], bc.repeat(len(br))[:, None])]
    return [(r.to(device), c.to(device)) for r, c in groups]


def weights(labels: torch.Tensor, label, config: dict, per_image: int = 1) -> torch.Tensor:
    """float64 weight [n] of each bank image for a seed of `label`."""
    return image_weights(labels, label, batch_size=config["scorebatchsize"],
                         max_samples=config["max_samples"], cutoff="batch_quota",
                         weighting="sum")


def score(t, x: torch.Tensor, k: int, images: torch.Tensor, labels: torch.Tensor,
          label, config: dict, mode: str) -> torch.Tensor:
    """The bbELS score at time t of one sample x [1, h, w, c] (float32, on
    the bank's device) with kernel size k < h over the bank; label None or
    an int."""
    a, beta = coefficients(t)
    n, h, w, c = images.shape
    if k >= h:
        raise ValueError(f"k = {k} >= the image size {h}: bbELS falls back to LS there")
    p = k // 2
    wimg = weights(labels, label, config)
    used = torch.nonzero(wimg > 0).flatten()
    xw = windows(zeros_pad(x, p), k)[0]  # [h, w, d]
    mean = torch.empty(h, w, c, device=x.device)
    step = max(1, CHUNK_ROWS // ((h - 2 * p) * (w - 2 * p)))
    for g, (rows, cols) in enumerate(_groups(h, w, p, x.device)):
        gmode = mode if g == 0 or mode == "tf32" else config["border_dots"]
        q = xw[rows, cols]  # [G, m, d]
        post = Posterior(q.shape[:2], c, x.device)
        for i0 in range(0, used.numel(), step):
            idx = used[i0:i0 + step]
            iw = windows(zeros_pad(images[idx], p), k)  # [n_c, h, w, d]
            keys = iw[:, rows, cols].transpose(0, 1).reshape(q.shape[0], -1, q.shape[2])
            post.add(logits(q, keys, a, beta, gmode),
                     wimg[idx].repeat_interleave(q.shape[1]), keys[..., center(k, c)], gmode)
        mean[rows, cols] = post.mean()
    return -(x - a * mean[None]) / beta
