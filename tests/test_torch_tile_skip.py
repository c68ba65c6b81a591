"""The kernels' K5 walk of only the live bank tiles, on the CPU.

With per-seed weights w [S, P] (one label per seed) the flash-score kernels
walk, for each seed, only the SPLIT_TILE-row bank tiles its weights admit:
a pass flags them from the sweep's bias (`fs.live_tiles_plain` is its plain
version), and a tile whose every bias entry is at the -1e30 sentinel is left
out. The claim is that this changes no bit: a dead tile leaves (m, s1, s2)
as it was, in every epilogue, the bf16 exponential's per-tile re-basing of m
included. Here:

- the plain flags of the wrapper's bias against a numpy reference computed
  from w (a tile is live where some weight over its rows is positive), over
  image geometries whose images do and do not line up with the tiles;
- a plain model of the kernels' walk (`_walk`: per seed, the kernel's split
  plan, one online-softmax step per tile in order, the splits merged by the
  plain merge pass) that skips each seed's dead tiles, bit-equal to the same
  walk over every tile, at every tier and value strategy, from the empty
  state, in a two-call chain and with sentinel rows in the carried state;
- the skipping walk against the JAX kernel's vmap over seeds in interpret
  mode, at the tolerances the K5 tests hold (`test_torch_flash_score.py`).
"""

import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu_torch.ops.flash_score as tfs
from test_torch_flash_score import (DEFAULT_LSE_TOL, DEFAULT_MEAN_TOL, _assert_same,
                                    _assert_tier, _empty, _inputs, _jax)

TILE = tfs.FAST_TILE


def _label_weights(per_img, n_img, order, S=4, pad=2, labels_n=5, seed=0):
    """w [S, n_img * per_img]: seed s admits the patches of the images of
    its label (uniform positive weights), seed S - 1 a label no image has;
    the last `pad` images are chunk padding (weight 0 for every seed).
    Labels cycle (0, 1, .. labels_n - 1, 0, ..) or are sorted."""
    labels = np.arange(n_img) % labels_n
    if order == "sorted":
        labels = np.sort(labels)
    seed_labels = list(range(S - 1)) + [labels_n + 1]
    rs = np.random.RandomState(seed)
    u = rs.uniform(0.5, 1.5, size=n_img * per_img).astype(np.float32)
    img = np.arange(n_img * per_img) // per_img
    w = np.stack([np.where((labels[img] == lab) & (img < n_img - pad), u, 0.0)
                  for lab in seed_labels]).astype(np.float32)
    return w


def _numpy_live(w):
    S, P = w.shape
    nt = -(-P // TILE)
    padded = np.zeros((S, nt * TILE), np.float32)
    padded[:, :P] = w
    return (padded.reshape(S, nt, TILE) > 0).any(axis=2)


@pytest.mark.parametrize("order", ["sorted", "cyclic"])
@pytest.mark.parametrize("per_img", [1024, 1000, 784], ids=["32x32", "P_not_x128", "rps784"])
def test_live_tiles_match_numpy(per_img, order):
    """The flags the kernels walk by, from the bias the wrapper builds: a
    tile is live for a seed exactly where some weight over its rows is
    positive. Images of 1000 and 784 patches (28x28, rows_per_seed 784)
    straddle tiles, and P is then no multiple of the tile; the padding
    images and the seed whose label no image has admit nothing."""
    w = _label_weights(per_img, 12, order)
    P = w.shape[1]
    pn = torch.from_numpy(np.random.RandomState(1).uniform(0, 30, P).astype(np.float32))
    bias = tfs.sweep_bias(pn, torch.from_numpy(w), 0.8, 0.6)
    live = tfs.live_tiles_plain(bias)
    want = _numpy_live(w)
    np.testing.assert_array_equal(live.numpy(), want)
    assert not want[-1].any()  # the seed of an absent label
    assert 0 < want[:-1].mean() < 0.5


def test_live_tiles_of_a_row_and_of_nan():
    """A 1-D bias is one seed; a NaN entry keeps its tile (the walk skips
    only what it can prove empty); an entry below the sentinel is dead."""
    bias = torch.full((300,), tfs.NEG_INF)
    bias[5] = 0.0
    bias[200] = float("nan")
    bias[260] = -2e30
    np.testing.assert_array_equal(tfs.live_tiles_plain(bias).numpy(), [[True, True, False]])


def _logits(q, bias, bank, dotscale, precision, fast):
    """The sweep's logits [M, P] as the plain version forms them."""
    with tfs.true_fp32():
        if precision != "highest":
            qh, ql = tfs._split_bf16(q)
            dots = tfs._split_dot(qh.double(), ql.double(), *tfs._split_bf16(bank))
            return tfs._add_bias(dots.double() * dotscale, bias.double()).float()
        if fast:
            return tfs.fp32_logits_in_order(q, bank, dotscale, bias)
        return tfs._fp32_logits(q, bank, dotscale, bias)


def _walk(skip):
    """A plain model of the kernels' walk with `fs.sweep_kernel`'s signature:
    each seed's rows apart; the kernel's split plan (`fs.sweep_plan`; each
    split from the empty state, folded into the carried state by
    `fs.merge_splits_plain`, where its loop splits the bank axis); one
    online-softmax step per tile of TILE rows, in order (`fs._online_step`,
    or `fs._fast_tiles` over one tile for the bf16 exponential, which
    re-bases m there). With `skip`, a seed's dead tiles are left out."""

    def sweep(q, bias, bank, values, dotscale, m, s1, s2, precision="highest",
              strategy="vpu", col0=-1, prune_mask=None, fast_exp=None):
        assert prune_mask is None
        bias2 = bias.reshape(-1, bank.shape[0])
        S, P, c = bias2.shape[0], bank.shape[0], s2.shape[1]
        rps = q.shape[0] // S
        plan = tfs.sweep_plan(precision, fast_exp, strategy, c, q.shape[0], rps, P, q.shape[1],
                              bias.ndim == 2, False,
                              (col0, c) if strategy == "inbank" else None)
        fast, split = plan.fast, plan.tier != "highest"
        logits = _logits(q, bias, bank, dotscale, precision, fast)
        v = bank[:, col0:col0 + c] if strategy == "inbank" else values
        live = tfs.live_tiles_plain(bias2)

        def run(state, rows, s, p0, p1):
            for t0 in range(p0, p1, TILE):
                t1 = min(t0 + TILE, p1)
                if skip and not live[s, t0 // TILE]:
                    continue
                lg, vv = logits[rows, t0:t1], v[t0:t1]
                if fast:
                    state = tfs._fast_tiles(lg, vv, *state, tfs._fast_rule(strategy, split))
                else:
                    product = (tfs._split_product if strategy == "inbank" and split
                               else torch.matmul)
                    state = tfs._online_step(lg, vv, *state, product)
            return state

        out = []
        for s in range(S):
            rows = slice(s * rps, (s + 1) * rps)
            state = (m[rows], s1[rows], s2[rows])
            if plan.loop in ("k1", "k2_ws"):  # the loops that split the bank axis
                empty = (torch.full((rps,), tfs.NEG_INF), torch.zeros(rps),
                         torch.zeros(rps, c))
                state = tfs.merge_splits_plain(
                    state, [run(empty, rows, s, p0, p1) for p0, p1 in plan.splits])
            else:
                state = run(state, rows, s, 0, P)
            out.append(state)
        return tuple(torch.cat(x) for x in zip(*out))

    return sweep


def _run(a, at, bt, state, precision, skip, **kw):
    """`flash_score_update` through `_walk(skip)` (numpy in and out)."""
    t = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
         for k, v in a.items()}
    out = tfs._update(_walk(skip), t["q"], t["qn"], t["bank"], t["pn"], t["values"], t["w"],
                      at, bt, tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in state),
                      precision, kw.get("rows_per_seed"), kw.get("v_strategy", "auto"),
                      kw.get("fast_exp"), kw.get("inbank_cols"), None)
    return tuple(o.numpy() for o in out)


def _case(strategy, c, per_img, n_img, rps=8, d=27, seed=0, order="cyclic"):
    """Label-filtered inputs (`_label_weights`, 4 seeds) and the keywords of
    `strategy` ('inbank': V = the bank's columns 12 .. 12 + c)."""
    w = _label_weights(per_img, n_img, order, seed=seed)
    S, P = w.shape
    a = _inputs(S * rps, d, P, c, seed=seed + 1)
    a["w"] = w
    kw = dict(rows_per_seed=rps)
    if strategy == "inbank":
        a["values"] = None
        kw.update(v_strategy="inbank", inbank_cols=(12, c))
    elif strategy != "auto":
        kw["v_strategy"] = strategy
    return a, kw


# (precision, value strategy, c): every tier in the strategies its kernels
# take on the ELS path ('vpu', 'inbank'), 'mxu1' with the bf16 exponential,
# and 'mxu' (what 'auto' takes) at c = 16
WALKS = [("highest", "vpu", 3), ("highest", "inbank", 3), ("highest", "auto", 16),
         ("high", "vpu", 3), ("high", "inbank", 3), ("high", "auto", 16),
         ("default", "vpu", 3), ("default", "inbank", 3), ("default", "mxu1", 3),
         ("default", "auto", 16)]


@pytest.mark.parametrize("start", ["empty", "chain", "sentinel"])
@pytest.mark.parametrize("precision,strategy,c", WALKS,
                         ids=[f"{p}-{s}-c{c}" for p, s, c in WALKS])
def test_skipping_dead_tiles_changes_no_bit(precision, strategy, c, start):
    """The walk that skips each seed's dead tiles returns the walk over
    every tile, bit for bit: 12 images of 784 patches (tiles straddle
    images; P = 9408, three 4096-row splits where the sweep splits), cyclic
    labels, padding images, a seed with no image. From the empty state; in
    two chained calls split 37 rows past the middle (each call walks its own
    chunk's tiles); from a carried state with sentinel rows."""
    a, kw = _case(strategy, c, 784, 12)
    M, P = a["q"].shape[0], a["w"].shape[1]
    at, bt = 0.8, 0.6
    if start == "chain":
        h = P // 2 + 37
        part = lambda lo, hi: {k: (v[..., lo:hi] if k == "w" else  # noqa: E731
                                  v[lo:hi] if v is not None and v.shape[0] == P else v)
                               for k, v in a.items()}
        got, want = (_run(part(h, P), at, bt, _run(part(0, h), at, bt, _empty(M, c),
                                                   precision, skip, **kw),
                          precision, skip, **kw) for skip in (True, False))
    else:
        state = _empty(M, c)
        if start == "sentinel":
            state = tuple(x.copy() for x in _run(a, 0.7, 0.7, state, precision, False, **kw))
            state[0][::7], state[1][::7], state[2][::7] = -1e30, 0.0, 0.0
        got, want = (_run(a, at, bt, state, precision, skip, **kw) for skip in (True, False))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    dead = slice(M - M // 4, M)  # the seed of an absent label: its state as it came
    if start != "sentinel":
        assert (got[0][dead] <= -5e29).all() and (got[1][dead] == 0).all()


JAX_WALKS = [("highest", "vpu", 3), ("highest", "auto", 16), ("high", "vpu", 3),
             ("high", "inbank", 3), ("default", "vpu", 3), ("default", "inbank", 3),
             ("default", "mxu1", 3)]


@pytest.mark.parametrize("precision,strategy,c", JAX_WALKS,
                         ids=[f"{p}-{s}-c{c}" for p, s, c in JAX_WALKS])
def test_skipping_walk_matches_jax_kernel_interpret(precision, strategy, c):
    """The skipping walk against the JAX kernel's vmap over seeds (2-D w,
    rows_per_seed) in interpret mode, block_p = 128 so both re-base m per
    128 rows with the bf16 exponential: 12 images of 100 patches, sorted
    labels. The K5 tests' tolerances: 'highest' and 'high' as
    `test_per_seed_matches_jax_kernel_interpret`, 'default' the tier's."""
    a, kw = _case(strategy, c, 100, 12, d=27 if c == 3 else 36, seed=5, order="sorted")
    M = a["q"].shape[0]
    ours = _run(a, 0.8, 0.6, _empty(M, c), precision, True, **kw)
    want = _jax(a, 0.8, 0.6, _empty(M, c), block_q=64, block_p=128, precision=precision,
                **kw)
    if precision == "default":
        _assert_tier(ours, want, DEFAULT_LSE_TOL, DEFAULT_MEAN_TOL)
    else:
        _assert_same(ours, want)
