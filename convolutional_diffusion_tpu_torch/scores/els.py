"""LocalEquivScoreModule (ELS): locality + translation equivariance.

Counterpart of `convolutional_diffusion_tpu/scores/els.py`. Every valid
k x k patch of every training image forms one bank; each pixel of x attends
over the bank with Gaussian weights on the distance between its circularly
padded k x k query window and the bank patch, and the posterior mean of the
bank patches' CENTER pixels gives the score. As flash attention:

  Q = circular windows of x            [b*h*w, d],  d = k*k*c
  K = all valid patches of the images  [P, d]
  V = patch center pixels              [P, c]
  logit = -(||q||^2 - 2 a_t qk + a_t^2 ||k||^2) / (2 beta_t)

swept chunk by chunk through `ops.flash_score.flash_score_update` (on CUDA
the hand-written kernel of the module's precision tier: K1 at 'highest',
K2 at 'high', K3/K4 at 'default'), never materialising [b, P, h, w].

Value strategy: the JAX package's rule, kept because the strategies round
differently. At 'default' a sweep whose d padded to 128 is at most
`_inbank_max_dp('default')` = 128 (RGB k <= 5, grayscale k <= 11) takes
'inbank': the centers are the bank's own columns, so the chunk's centers
are not read; every other sweep takes 'auto': 'vpu' for c <= 8 channels,
'mxu' (the matrix value sums e @ V) above, or 'mxu1' at 'default' over
P >= 2^18 bank rows in one call. So a bank of more than 8 channels (e.g.
`data.synthetic_dataset(num_channels=16)`) sweeps in 'mxu' at every tier:
its d = k * k * c padded to 128 is past the 'inbank' ceiling at every k.

Exact block pruning (`prune=True`, kernel variant K6, `ops.prune`): the
cached banks are clustered (`bank.ClusteredBank`, each row's weight taken
through its image index), and at 'highest' and 'high', with 1-D weights and
a query count that is a multiple of PRUNE_ROWS, every call builds one skip
mask per bank chunk from the banks' block statistics: the JAX package's
gate (`scores/els.py:391-409`). Streamed k's, 'default' and label vectors
sweep unmasked, as there.

Reference parity: per-batch means over n_kept * (h-k+1)^2 entries and the
UNFILTERED max_samples cutoff come from `image_weights`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_score import (
    NEG_INF,
    flash_score_update,
    flash_score_update_plain,
    state_from_kernel,
    state_to_kernel,
)
from ..ops.patches import center_index, extract_patches, pad_image
from ..ops.prune import PRUNE_ROWS, logw_block_stats, prune_masks
from .bank import BankCacheMixin, ClusteredBank, bank_geometry, chunk_patches
from .base import ScoreModuleBase
from .common import CutoffRule, Weighting, image_weights

# Cached-bank budget for an 80 GB H100. The machine visits the largest k
# first and the ledger is first come, first served: at 50k CIFAR10 images
# this caches k=17 (44.8 GB) and k=3 (5.6 GB) and streams the k's between,
# leaving ~29 GB for the image set, per-chunk transients and the queries.
DEFAULT_BANK_BUDGET = 48 << 30

# Per-tier ceiling on d padded to 128 for the 'inbank' value strategy: the
# JAX package's table (`scores/els.py:51`), without its environment override.
_INBANK_MAX_DP = {"default": 128, "high": 0, "highest": 0}


def _inbank_max_dp(precision: str) -> int:
    return _INBANK_MAX_DP[precision]


def _value_kw(precision: str, d: int, col0: int | None, c: int) -> dict:
    """flash_score_update's value-strategy keywords for a sweep of d
    features whose centers are the bank columns col0 .. col0 + c (None:
    not bank columns): 'inbank' where the table allows it."""
    if col0 is not None and -(-d // 128) * 128 <= _inbank_max_dp(precision):
        return dict(v_strategy="inbank", inbank_cols=(col0, c))
    return {}


def _empty_state(M: int, c: int, device):
    return (
        torch.full((M,), NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((M,), dtype=torch.float32, device=device),
        torch.zeros((M, c), dtype=torch.float32, device=device),
    )


def _update_fn(use_pallas):
    """The sweep `use_pallas` picks: None or True `flash_score_update` (the
    kernel on the card, the plain version on the CPU), False the plain
    version on any device, which autograd differentiates."""
    return flash_score_update_plain if use_pallas is False else flash_score_update


def _rows_per_seed(q_flat, w_img):
    """Query rows per seed for per-seed weights [S, n]; None for [n]."""
    return q_flat.shape[0] // w_img.shape[0] if w_img.ndim == 2 else None


def els_sweep(
    images,  # [n, h, w, c]
    w_img,  # [n] per-image weights, or [S, n] one row per seed
    xq_flat,  # [M, d] query windows (seed-major with per-seed weights)
    qn_flat,  # [M]
    at,
    bt,
    *,
    k: int,
    cs: int,  # images per chunk (bank_geometry(...).cs)
    precision: str = "highest",
    state0=None,  # (m [M], s1 [M], s2 [M, c]) -inf convention; None = empty
    use_pallas=None,  # False: the plain version on any device (`_update_fn`)
):
    """Stream the images through the online softmax, extracting each chunk's
    patches on the fly; returns (m, s1, s2) with the -inf empty convention.
    With per-seed weights [S, n] each chunk is one per-seed sweep (K5 on the
    card), the M query rows split into S equal seed blocks.
    Chaining: a sweep over images[:j] whose state feeds `state0` of a sweep
    over images[j:] (j a multiple of cs) equals one sweep over all of them."""
    update = _update_fn(use_pallas)
    n, h, w, c = images.shape
    per_img = (h - k + 1) * (w - k + 1)
    rps = _rows_per_seed(xq_flat, w_img)
    vkw = _value_kw(precision, k * k * c, center_index(k, c).start, c)
    state = (
        _empty_state(xq_flat.shape[0], c, xq_flat.device) if state0 is None
        else state_to_kernel(*state0)
    )
    for i0 in range(0, n, cs):
        p, ctr, pn = chunk_patches(images[i0 : i0 + cs], k)
        w_p = w_img[..., i0 : i0 + cs].repeat_interleave(per_img, dim=-1)
        state = update(
            xq_flat, qn_flat, p, pn, None if vkw else ctr, w_p, at, bt, state,
            precision=precision, rows_per_seed=rps, **vkw,
        )
    return state_from_kernel(*state)


def _row_weights(bank, w_img, i, per_img: int):
    """Chunk i's per-row weights ([B], or [S, B] per seed) from per-image
    weights [n] or [S, n]: padding images (index >= n) weigh 0; a clustered
    bank's rows take their image's weight through `img_idx` (there i may
    also be slice(None): every chunk's, [nblk, B])."""
    B = bank.bank.shape[1]
    if isinstance(bank, ClusteredBank):
        w_pad = F.pad(w_img, (0, bank.bank.shape[0] * (B // per_img) - w_img.shape[-1]))
        return w_pad[..., bank.img_idx[i].long()]
    cs = B // per_img
    w_c = w_img[..., i * cs : (i + 1) * cs]
    return F.pad(w_c, (0, cs - w_c.shape[-1])).repeat_interleave(per_img, dim=-1)


def banked_sweep(
    q_flat,  # [M, d] query windows (seed-major with per-seed weights)
    qn_flat,  # [M]
    bank,  # scores.bank.Bank or ClusteredBank: bank [nblk, B, d], centers
    # [nblk, B, c], pn [nblk, B] (and img_idx [nblk, B])
    w_img,  # [n] per-image weights, or [S, n] one row per seed; n <= nblk * cs
    at,
    bt,
    *,
    per_img: int,  # bank rows per image (bank_geometry(...).per_img)
    precision: str = "highest",
    state0=None,  # (m, s1, s2) -inf convention; None = empty
    inbank_col: int | None = None,  # centers == bank[..., col:col+c]
    masks=None,  # [nblk, ceil(M / PRUNE_ROWS), ceil(B / PRUNE_BLOCK)] (K6)
    use_pallas=None,  # False: the plain version on any device (`_update_fn`)
):
    """Sweep prebuilt bank chunks through the online softmax; returns
    (m, s1, s2) with the -inf empty convention (chainable via `state0`).
    Each chunk's per-patch weights ([B], or [S, B] with per-seed weights)
    are built from the per-image ones as the chunk is swept (`_row_weights`:
    through `img_idx` for a clustered bank); images past the end of `w_img`
    (the chunk padding) get zero weight. With `inbank_col` the sweeps take
    'inbank' where `_inbank_max_dp` allows it, and `bank.centers` is not
    read. `masks` (1-D weights) gives each chunk's sweep its prune mask."""
    update = _update_fn(use_pallas)
    nblk, B, d = bank.bank.shape
    c = bank.centers.shape[-1]
    rps = _rows_per_seed(q_flat, w_img)
    vkw = _value_kw(precision, d, inbank_col, c)
    state = (
        _empty_state(q_flat.shape[0], c, q_flat.device) if state0 is None
        else state_to_kernel(*state0)
    )
    for i in range(nblk):
        state = update(
            q_flat, qn_flat, bank.bank[i], bank.pn[i],
            None if vkw else bank.centers[i],
            _row_weights(bank, w_img, i, per_img), at, bt, state,
            precision=precision, rows_per_seed=rps,
            prune_mask=None if masks is None else masks[i], **vkw,
        )
    return state_from_kernel(*state)


@torch.no_grad()
def sweep_masks(bank: ClusteredBank, w_img, q_flat, qn_flat, at, bt, *,
                per_img: int):
    """One prune mask per chunk of a clustered bank, [nblk,
    M / PRUNE_ROWS, ceil(B / PRUNE_BLOCK)] int32, from its block statistics
    and the call's per-image weights [n] (`ops.prune`; the JAX package's
    `build_masks`, `scores/els.py:447-457`)."""
    nblk = bank.bank.shape[0]
    lmax, lmin, anyinc = logw_block_stats(_row_weights(bank, w_img, slice(None), per_img))
    mk = prune_masks(q_flat, qn_flat, at, bt, bank.stats, lmax, lmin, anyinc)
    return mk.view(mk.shape[0], nblk, -1).transpose(0, 1).contiguous()


def patch_sweep(module, k: int, q_flat, qn_flat, w_img, at, bt):
    """Sweep the queries over every valid k x k patch of `module`'s images
    (per-image weights `w_img`, [n] or [S, n] per seed): through the
    module's cached bank where the ledger holds it, else streamed chunk by
    chunk. Either way one sweep per bank chunk, with the module's precision
    and the value strategy of `_value_kw`; with the module's `prune` set, a
    clustered bank at 'highest' or 'high' with 1-D weights and M a multiple
    of PRUNE_ROWS sweeps with prune masks (`sweep_masks`, K6), on the
    kernel's route only, as in the JAX package. The module's `use_pallas`
    picks the sweep (`_update_fn`). Returns (m, s1, s2), -inf convention.
    The ELS module and the bbELS center region share it."""
    n, h, w, c = module.images.shape
    g = bank_geometry(n, h, w, c, k, module.target_block)
    bank = module._bank(k)
    if bank is None:
        return els_sweep(
            module.images, w_img, q_flat, qn_flat, at, bt,
            k=k, cs=g.cs, precision=module.precision, use_pallas=module.use_pallas,
        )
    masks = None
    if (module.prune and module.use_pallas is not False and isinstance(bank, ClusteredBank)
            and module.precision in ("highest", "high")
            and w_img.ndim == 1 and q_flat.shape[0] % PRUNE_ROWS == 0):
        masks = sweep_masks(bank, w_img, q_flat, qn_flat, at, bt, per_img=g.per_img)
    return banked_sweep(
        q_flat, qn_flat, bank, w_img, at, bt, per_img=g.per_img,
        precision=module.precision, inbank_col=center_index(k, c).start,
        masks=masks, use_pallas=module.use_pallas,
    )


class LocalEquivScoreModule(BankCacheMixin, ScoreModuleBase):
    """ELS score module. Banks are cached per k on the module's device while
    the ledger budget lasts (bank mode); a k whose bank does not fit streams
    its patches chunk by chunk (streaming mode). Both give the same result.

    label may be a [b] vector (one label per seed): each seed gets its own
    image weights and the call is still one sweep per bank chunk, with
    per-seed weights (kernel variant K5), banked or streamed.

    prune: cache clustered banks and skip the bank tiles whose weights are
    exactly 0 in fp32 (exact block pruning, `ops.prune`, kernel variant K6;
    see the module docstring for where masks apply)."""

    supports_vector_label = True

    def __init__(
        self,
        dataset,
        *,
        batch_size: int = 64,
        target_block: int = 65536,
        bank_budget_bytes: int = DEFAULT_BANK_BUDGET,
        bank_ledger=None,
        prune: bool = False,
        **kw,
    ):
        super().__init__(dataset, batch_size=batch_size, **kw)
        self._init_bank_cache(
            target_block=target_block, bank_budget_bytes=bank_budget_bytes,
            bank_ledger=bank_ledger, prune=prune,
        )

    def _image_weights(self, label, b: int, per_img: int, order):
        """Per-image weights: [n] for a scalar label or None, [b, n] for a
        [b] label vector (each distinct label's weights computed once)."""
        def weights(lab):
            return image_weights(
                self.labels, lab,
                batch_size=self.batch_size, max_samples=self.max_samples,
                cutoff=CutoffRule.UNFILTERED, weighting=Weighting.MEAN,
                per_image_bank=per_img, order=order,
            )

        if label is None or np.ndim(label) == 0:
            return weights(label)
        labs = [int(v) for v in np.asarray(label).reshape(-1)]
        if len(labs) != b:
            raise ValueError(
                f"a label vector needs one label per seed: got {len(labs)} "
                f"labels for {b} seeds"
            )
        by_label = {lab: weights(lab) for lab in set(labs)}
        return torch.stack([by_label[lab] for lab in labs])

    def _score(self, k, x, label, at, bt, order):
        n, h, w, c = self.images.shape
        b = x.shape[0]
        g = bank_geometry(n, h, w, c, k, self.target_block)
        w_img = self._local_weights(self._image_weights(label, b, g.per_img, order))
        xq = extract_patches(pad_image(x, k // 2, "circular"), k)
        xq = xq.reshape(b * h * w, g.d)
        qn = (xq * xq).sum(dim=-1)
        ((_, s1, s2),) = self._merge([patch_sweep(self, k, xq, qn, w_img, at, bt)])
        mean_center = (s2 / s1[:, None]).reshape(b, h * w, c)
        score = -(x.reshape(b, h * w, c) - at * mean_center) / (bt**2)
        return score.reshape(x.shape)
