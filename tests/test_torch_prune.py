"""Port vs JAX: exact block pruning (`ops.prune`, kernel variant K6), the
clustered bank and the pruned ELS module.

Same seeded numpy inputs to both packages; the JAX side runs its Pallas
kernel in interpret mode (`CDT_FLASH_INTERPRET=1` with `use_pallas=True`,
as `tests/test_prune.py` does). Tolerances: masks and cluster ids exact;
block statistics and k-means centers within 1e-6 relative to scale (fp32
sums in another order); masked sweeps at the flash-score tests' parity
rule, and within 1e-6 of the unmasked sweep (a sound mask skips only
weights that are exactly 0 in fp32); modules and machines at 1e-3 relative
to scale (clustering changes the summation order)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.ops.prune as jp
import convolutional_diffusion_tpu.scores as jscores
import convolutional_diffusion_tpu.scores.bank as jb
import convolutional_diffusion_tpu_torch.ops.flash_score as tfs
import convolutional_diffusion_tpu_torch.ops.prune as tp
import convolutional_diffusion_tpu_torch.scores.bank as tb
import convolutional_diffusion_tpu_torch.scores.els as tels
from convolutional_diffusion_tpu.data import synthetic_dataset
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
from convolutional_diffusion_tpu_torch import convert
from convolutional_diffusion_tpu_torch.ops import _build
from convolutional_diffusion_tpu_torch.scores import (
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)


def _clustered_problem(seed=0, M=512, P=8 * tp.PRUNE_BLOCK, d=27):
    """`tests/test_prune.py`'s fixture at the port's stats block: 8 tight
    clusters of P / 8 bank rows in order (one cluster per PRUNE_BLOCK rows
    by default), queries near M / 256 of them (256 rows each)."""
    rng = np.random.RandomState(seed)
    means = rng.normal(0, 2.0, (8, d)).astype(np.float32)
    cid = np.repeat(np.arange(8), P // 8)
    bank = (means[cid] + rng.normal(0, 0.2, (P, d))).astype(np.float32)
    qcid = np.repeat(rng.permutation(8)[: M // 256], 256)
    q = (means[qcid] + rng.normal(0, 0.1, (M, d))).astype(np.float32)
    w = np.full((P,), 1.0 / P, np.float32)
    return q, bank, w


AT, BT = 0.99, 0.08  # a low-noise step, where the bounds bite


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


def _both_stats(bank, w):
    P, d = bank.shape
    js = jp.block_stats(jnp.asarray(bank.reshape(1, -1)), jnp.ones((1, P), bool), P, d,
                        block=tp.PRUNE_BLOCK)
    jl = jp.logw_block_stats(jnp.asarray(w.reshape(1, P)), P, block=tp.PRUNE_BLOCK)
    ts = tp.block_stats(torch.from_numpy(bank)[None], torch.ones(1, P, dtype=torch.bool))
    tl = tp.logw_block_stats(torch.from_numpy(w)[None])
    return (js, jl), (ts, tl)


@pytest.mark.parametrize("excluded", ["strided_rows", "whole_block"])
def test_block_stats_match_jax(excluded):
    """Per PRUNE_BLOCK rows, against the JAX package's at the same block:
    excluded rows (w = 0) are left out of the log-weight stats, and a block
    with none included is flagged."""
    q, bank, w = _clustered_problem()
    if excluded == "strided_rows":
        w[::7] = 0.0
    else:
        w[tp.PRUNE_BLOCK : 2 * tp.PRUNE_BLOCK] = 0.0
    (js, jl), (ts, tl) = _both_stats(bank, w)
    for a, b in zip(js, ts):
        assert _rel(a, b) <= 1e-6
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tl[2].tolist() == [excluded == "strided_rows" or j != 1 for j in range(8)]


@pytest.mark.parametrize("M", [512, 1280])
def test_prune_masks_bit_equal_to_jax(M):
    """At block_q = 64 (the port's PRUNE_ROWS) on the JAX package's fixture,
    with clusters of one stats block each: the same mask, more than half
    skipped. M = 1280 spans two of the port's MASK_ROWS products, the second
    partial."""
    q, bank, w = _clustered_problem(M=M)
    (js, jl), (ts, tl) = _both_stats(bank, w)
    qn = (q**2).sum(1)
    want = np.asarray(jp.prune_masks(jnp.asarray(q), jnp.asarray(qn), jnp.float32(AT),
                                     jnp.float32(BT), js, *jl, block_q=64))
    got = tp.prune_masks(torch.from_numpy(q), torch.from_numpy(qn), AT, BT, ts, *tl)
    assert got.dtype == torch.int32 and got.shape == (M // 64, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.mean() > 0.5
    # thr: a huge threshold skips nothing
    assert not tp.prune_masks(torch.from_numpy(q), torch.from_numpy(qn), AT, BT, ts, *tl,
                              thr=1e9).any()
    with pytest.raises(ValueError, match="PRUNE_ROWS"):
        tp.prune_masks(torch.from_numpy(q[:100]), torch.from_numpy(qn[:100]), AT, BT, ts,
                       *tl)


def test_kmeans_and_assign_match_jax():
    """Lloyd's k-means from the strided init, and the nearest-center ids,
    against the JAX package's on the fixture (one center per cluster, so no
    row sits near a tie), over more rows than one of the port's CHUNK_ROWS
    products."""
    _, bank, _ = _clustered_problem(P=8 * 2560)
    assert bank.shape[0] > tp.CHUNK_ROWS
    want = np.asarray(jp.kmeans_centers(jnp.asarray(bank), 8, iters=8, chunk=1000))
    got = tp.kmeans_centers(torch.from_numpy(bank), 8, iters=8).numpy()
    assert _rel(got, want) <= 1e-6
    ids_j = np.asarray(jp.assign_clusters(jnp.asarray(bank.reshape(2, -1)),
                                          jnp.asarray(want), bank.shape[0] // 2, 27))
    ids_t = tp.assign_clusters(torch.from_numpy(bank), torch.from_numpy(want))
    assert ids_t.dtype == torch.int32
    np.testing.assert_array_equal(ids_t.numpy(), ids_j.reshape(-1))


@pytest.mark.parametrize("n,count", [(1000, 256), (256, 16), (5, 3), (7, 1), (9, 9)])
def test_strided_ids_match_jax_linspace(n, count):
    want = np.asarray(jnp.linspace(0, n - 1, count).astype(jnp.int32))
    np.testing.assert_array_equal(tp.strided_ids(n, count).numpy(), want)


def test_logw_block_stats_exclusion():
    """`tests/test_prune.py`'s case at PRUNE_BLOCK rows: the min runs over
    included rows only, a block with none is excluded, and a chunk's last
    block is padded with excluded rows."""
    B = tp.PRUNE_BLOCK
    w = torch.zeros(1, 2 * B)
    w[0, 0], w[0, 5], w[0, B + 3] = 0.5, 0.125, 0.25
    lmax, lmin, anyinc = tp.logw_block_stats(w)
    assert lmax.tolist() == [-1.0, -2.0] and lmin.tolist() == [-3.0, -2.0]
    assert anyinc.tolist() == [True, True]
    lmax, lmin, anyinc = tp.logw_block_stats(torch.zeros(1, B + 10))
    assert anyinc.tolist() == [False, False]
    assert (lmax <= -1e29).all() and (lmin <= -1e29).all()


def test_geometry_constants_are_the_kernels():
    """The mask cell is one pair of constants: ops._build passes both to
    nvcc, the plain version and the mask builders read the same values, and
    the shared header has no number of its own."""
    assert (tp.PRUNE_ROWS, tp.PRUNE_BLOCK) == (_build.PRUNE_ROWS, _build.PRUNE_BLOCK)
    assert (tfs.PRUNE_ROWS, tfs.PRUNE_BLOCK) == (64, 2048) == (
        _build.PRUNE_ROWS, _build.PRUNE_BLOCK)
    assert tp.PRUNE_BLOCK == jp.PRUNE_BLOCK  # the JAX package's stats block
    assert f"-DPRUNE_ROWS={tp.PRUNE_ROWS}" in _build.NVCC_FLAGS
    assert f"-DPRUNE_BLOCK={tp.PRUNE_BLOCK}" in _build.NVCC_FLAGS
    header = (_build.CSRC / "split_bank.cuh").read_text()  # the K6 tile walk
    assert "PRUNE_ROWS % BQ == 0" in header and "PRUNE_BLOCK % BP == 0" in header
    assert not re.search(r"\bPRUNE_(ROWS|BLOCK)\s*=\s*\d", header)
    for src in ("flash_score.cu", "flash_score_split_rows.cuh"):
        assert '#include "split_bank.cuh"' in (_build.CSRC / src).read_text()
    assert tfs.prune_grid(8192, 64800) == (128, 32)
    assert tfs.prune_grid(100, 2048) == (2, 1)


# ---- the clustered bank ---------------------------------------------------


@pytest.mark.parametrize("target_block", [1024, 300])
def test_build_clustered_bank_matches_jax(target_block):
    """`build_clustered_bank` on `synthetic_dataset(10, 12)` with 16 centers
    over 256 sampled rows: JAX's rows in JAX's order (the same img_idx,
    padding images' rows zero), the same stats, and the ledger's bytes. At
    target block 300 the last chunk holds two padding images."""
    ds = synthetic_dataset(num_samples=10, image_size=12, num_channels=3)
    imgs = np.asarray(ds.images)
    g = tb.bank_geometry(10, 12, 12, 3, 3, target_block)
    want = jb.build_clustered_bank(jnp.asarray(imgs), 3, target_block, n_centers=16,
                                   sample_size=256)
    got = tb.build_clustered_bank(torch.from_numpy(imgs), 3, target_block, n_centers=16,
                                  sample_size=256)
    assert set(got.build_seconds) == {"kmeans", "assign", "sort and fill", "stats"}
    np.testing.assert_array_equal(got.img_idx.numpy(), np.asarray(want.img_idx))
    np.testing.assert_array_equal(
        got.bank.numpy(), np.asarray(want.bank).reshape(g.nblk, g.block, g.d))
    np.testing.assert_array_equal(
        got.centers.numpy(), np.asarray(want.centers).reshape(g.nblk, g.block, 3))
    np.testing.assert_allclose(got.pn.numpy(), np.asarray(want.pn), rtol=1e-6)
    pad = got.img_idx >= 10
    assert pad.any() == (g.nblk * g.cs > 10) and not got.bank[pad].any()
    for a, b in zip(got.stats, want.stats):
        assert _rel(a, b) <= 1e-6
    carried = convert.clustered_bank_from_jax_numpy(
        *(np.asarray(a) for a in want[:4]), *(np.asarray(a) for a in want.stats), g,
        device="cpu")
    for a, b in zip(carried[:4], got[:4]):
        assert torch.equal(a, b) or torch.allclose(a, b, rtol=1e-6, atol=0)
    assert carried.build_seconds is None
    assert tb.bank_cache_nbytes(10, 12, 12, 3, 3, target_block, prune=True) == (
        tb.bank_nbytes(10, 12, 12, 3, 3, target_block) + g.nblk * g.block * 4)


def test_clustered_bank_from_jax_numpy_checks_geometry():
    g = tb.bank_geometry(4, 6, 6, 3, 3, 65536)
    ok = (np.zeros((g.nblk, g.block * g.d)), np.zeros((g.nblk, g.block * 3)),
          np.zeros((g.nblk, g.block)))
    with pytest.raises(ValueError, match="geometry"):
        convert.clustered_bank_from_jax_numpy(
            *ok, np.zeros((g.nblk, g.block + 1)), np.zeros((1, g.d)), np.zeros(1),
            np.ones(1, bool), g, device="cpu")


# ---- the pruned module ----------------------------------------------------


def _rgb(n=24, size=16):
    ds = synthetic_dataset(num_samples=n, image_size=size, num_channels=3)
    return np.asarray(ds.images), np.asarray(ds.labels)


def _x(b=2, seed=2, size=16):
    return np.random.RandomState(seed).normal(size=(b, size, size, 3)).astype(np.float32)


def test_prune_true_clusters_and_masks(monkeypatch):
    """`prune=True` caches a ClusteredBank and sweeps every chunk with a
    prune mask at 'highest' and 'high' (before this slice the keyword was
    swallowed: a plain bank, no masks); at 'default', with a label vector
    and without `prune`, no mask."""
    imgs, labs = _rgb()
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("prune_mask") is not None)
        return tfs.flash_score_update(*args, **kw)

    monkeypatch.setattr(tels, "flash_score_update", spy)
    for precision in ("highest", "high"):
        mod = LocalEquivScoreModule((imgs, labs), batch_size=8, precision=precision,
                                    prune=True, device="cpu")
        assert mod.prune is True
        out = mod(0.05, _x(), k=3)
        assert isinstance(mod._bank_cache[3], tb.ClusteredBank)
        assert calls and all(calls) and torch.isfinite(out).all()
        calls.clear()
        mod(0.05, _x(), k=3, label=np.array([1, 4]))
        assert calls and not any(calls)
        calls.clear()
    for kw in (dict(precision="default", prune=True), dict()):
        mod = LocalEquivScoreModule((imgs, labs), batch_size=8, device="cpu", **kw)
        mod(0.05, _x(), k=3)
        assert calls and not any(calls)
        calls.clear()
    assert not isinstance(mod._bank_cache[3], tb.ClusteredBank)


def test_bbels_never_clusters():
    imgs, labs = _rgb()
    mod = LocalEquivBordersScoreModule((imgs, labs), batch_size=8, prune=True,
                                       device="cpu")
    assert mod.prune is False
    assert torch.isfinite(mod(0.05, _x(), k=3)).all()
    assert type(mod._bank_cache[3]) is tb.Bank


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("call", [{}, {"label": 3}, {"label": np.array([1, 4], np.int32)}],
                         ids=["plain", "label", "label_vector"])
def test_pruned_module_matches_jax_pruned_module(monkeypatch, precision, call):
    """`tests/test_prune.py`'s module cases: the port's pruned module against
    the JAX package's pruned module (its kernel in interpret mode, masks at
    its own block_q), unconditional, a scalar label and a label vector
    (unmasked on both sides), at a low- and a mid-noise t."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    imgs, labs = _rgb()
    kw = dict(batch_size=8, precision=precision, prune=True)
    jmod = jscores.LocalEquivScoreModule((imgs, labs), schedule=jcos, use_pallas=True, **kw)
    ours = LocalEquivScoreModule((imgs, labs), device="cpu", **kw)
    for t in (0.05, 0.3):
        want = np.asarray(jmod(t, jnp.asarray(_x()), k=3, **call))
        assert _rel(ours(t, _x(), k=3, **call).numpy(), want) <= 1e-3


def test_pruned_machine_matches_jax_pruned_machine(monkeypatch):
    """A short trajectory (`tests/test_prune.py`'s scales [3, 3, 3, 5]) of
    the port's pruned machine against the JAX package's pruned machine."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    imgs, labs = _rgb()
    x = _x(seed=5)
    scales = [3, 3, 3, 5]
    jm = jscores.ScheduledScoreMachine(
        jscores.LocalEquivScoreModule((imgs, labs), batch_size=8, schedule=jcos,
                                      use_pallas=True, prune=True),
        in_channels=3, imsize=16, scales=scales)
    tm = ScheduledScoreMachine(
        LocalEquivScoreModule((imgs, labs), batch_size=8, prune=True, device="cpu"),
        in_channels=3, imsize=16, scales=scales)
    assert _rel(tm(x).numpy(), np.asarray(jm(jnp.asarray(x)))) <= 1e-3


def prototype_set(n=64, protos=4, size=16, noise=0.01, seed=0):
    """n images in `protos` runs of one flat colour each plus small noise:
    the clustered bank's blocks hold one colour each, so the bounds bite at
    low noise (bank rows in image order, or random images, give no skip)."""
    rs = np.random.RandomState(seed)
    colour = rs.uniform(-1, 1, (protos, 1, 1, 3)).astype(np.float32)
    idx = np.arange(n) * protos // n
    imgs = colour[idx] + noise * rs.normal(size=(n, size, size, 3))
    return imgs.astype(np.float32), idx.astype(np.int32)


def test_pruned_sweep_equals_unmasked_on_the_carried_bank():
    """The JAX package's clustered bank carried across (its k-means settles
    near-ties between patches of one colour otherwise than the port's): the
    port's masks from its stats are JAX's `prune_masks` at block_q = 64 bit
    for bit, the masked sweep skips and is within 1e-6 of the unmasked one,
    and the port-built bank agrees with it to fp32 summation order."""
    imgs, labs = prototype_set()
    g = tb.bank_geometry(64, 16, 16, 3, 3, 65536)
    jcb = jb.build_clustered_bank(jnp.asarray(imgs), 3, 65536)
    carried = convert.clustered_bank_from_jax_numpy(
        *(np.asarray(a) for a in jcb[:4]), *(np.asarray(a) for a in jcb.stats), g,
        device="cpu")
    mod = LocalEquivScoreModule((imgs, labs), batch_size=8, prune=True, device="cpu")
    at, bt = mod._coeffs(0.02)
    x = at * torch.from_numpy(imgs[:2]) + bt * torch.from_numpy(_x(seed=3))
    from convolutional_diffusion_tpu_torch.ops.patches import extract_patches, pad_image

    xq = extract_patches(pad_image(x, 1, "circular"), 3).reshape(-1, g.d)
    qn = (xq * xq).sum(-1)
    w_img = mod._image_weights(None, 2, g.per_img, torch.arange(64))
    masks = tels.sweep_masks(carried, w_img, xq, qn, at, bt, per_img=g.per_img)
    w_rows = w_img[carried.img_idx.long()]
    lmax, lmin, anyinc = jp.logw_block_stats(jnp.asarray(w_rows.numpy()), g.block)
    want = jp.prune_masks(jnp.asarray(xq.numpy()), jnp.asarray(qn.numpy()),
                          jnp.float32(at), jnp.float32(bt), jcb.stats, lmax, lmin, anyinc,
                          block_q=64)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(want)[None])
    assert masks.float().mean() > 0.2
    kw = dict(per_img=g.per_img, inbank_col=12)
    pruned = tels.banked_sweep(xq, qn, carried, w_img, at, bt, masks=masks, **kw)
    plain = tels.banked_sweep(xq, qn, carried, w_img, at, bt, **kw)
    own = tb.build_clustered_bank(torch.from_numpy(imgs), 3, 65536)
    own_masks = tels.sweep_masks(own, w_img, xq, qn, at, bt, per_img=g.per_img)
    assert own_masks.float().mean() > 0.2
    ours = tels.banked_sweep(xq, qn, own, w_img, at, bt, masks=own_masks, **kw)
    for got, tol in ((pruned, 1e-6), (ours, 1e-5)):
        lse = [s[0] + torch.log(s[1]) for s in (got, plain)]
        assert _rel(lse[0], lse[1]) <= tol
        assert _rel(got[2] / got[1][:, None], plain[2] / plain[1][:, None]) <= tol
