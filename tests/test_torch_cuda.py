"""The hand-written flash-score kernels, K1 (fp32 dots), K2 ('high') and
K3/K4 ('default'), in every value strategy ('vpu', 'mxu', 'inbank', and
with the bf16 exponential 'mxu1') and with either exponential after fp32
dots, with 1-D and per-seed (K5) weights and with prune masks (K6),
against their plain PyTorch version, on the card.
Marked `cuda`; skips (from inside each test) where no CUDA device
is present. On the card:
`python -m pytest tests/test_torch_cuda.py -m cuda`.

The neural half's card tests close the file: the backbones at 'highest' on
the card against the CPU (1e-3 relative to scale), and `ops.fp32`'s
switch, which must turn cuDNN's TF32 off (a 256-channel conv within 1e-5
of float64) and restore both flags; then training: one train step card
against CPU within 1e-5 (loss, gradients, BatchNorm statistics; TF32 must
exceed it), the TF32 flags as the step's backward sees them, and a resumed
run bit-equal to an unbroken one under cudnn.deterministic.

Tolerance: the repo's parity rule on the offset-invariant quantities,
max|a-b| / max(|a|,|b|,1) <= 1e-3 for the log total weight m + log s1 and
for the posterior mean s2/s1 (two fp32 summation orders of the same dots;
at 'high' and 'default' of the same bf16 parts, at 'default' with the same
bf16 roundings of the exponential and the values)."""

import os

import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu_torch.ops.flash_score as tfs


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(M, d, P, c, seed, dev, zero_frac=0.2):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(M, d, generator=g)
    bank = torch.randn(P, d, generator=g)
    values = torch.randn(P, c, generator=g)
    w = torch.rand(P, generator=g)
    w[w < zero_frac] = 0.0
    t = [q, (q * q).sum(1), bank, (bank * bank).sum(1), values, w]
    return [x.to(dev) for x in t]


def _empty(M, c, dev):
    return (torch.full((M,), tfs.NEG_INF, device=dev), torch.zeros(M, device=dev),
            torch.zeros(M, c, device=dev))


def _rel(a, b):
    a, b = a.double(), b.double()
    ok = torch.isfinite(b)
    assert torch.equal(ok, torch.isfinite(a))
    scale = max(a[ok].abs().max().item(), b[ok].abs().max().item(), 1.0)
    return (a[ok] - b[ok]).abs().max().item() / scale


def _assert_close(got, want):
    lse = [s[0] + torch.log(s[1]) for s in (got, want)]
    mean = [s[2] / s[1][:, None] for s in (got, want)]
    assert _rel(*lse) <= 1e-3
    assert _rel(*mean) <= 1e-3


SHAPES = [
    (8, 12, 24, 1), (300, 27, 700, 3), (1025, 75, 513, 3), (64, 867, 600, 3),
    (128, 2187, 300, 3), (96, 128, 2048, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,d,P,c", SHAPES)
def test_kernel_matches_plain(M, d, P, c):
    dev = _need_cuda()
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=M + d, dev=dev)
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, _empty(M, c, dev))
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {
        **before, "flash_score": before["flash_score"] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("M,d,P,c", SHAPES)
def test_bf16x3_kernel_matches_plain(M, d, P, c):
    """'high' launches K2, and only K2, and matches the plain split."""
    dev = _need_cuda()
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=M + d + 1, dev=dev)
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, _empty(M, c, dev))
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args, precision="high")
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {
        **before, "flash_score_bf16x3": before["flash_score_bf16x3"] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args, precision="high"))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_kernel_chaining_and_excluded_chunk(precision):
    dev = _need_cuda()
    M, d, P, c = 256, 147, 1000, 3
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=1, dev=dev)
    kw = dict(precision=precision)
    whole = tfs.flash_score_update(q, qn, bank, pn, values, w, 0.7, 0.7,
                                   _empty(M, c, dev), **kw)
    half = tfs.flash_score_update(q, qn, bank[:400], pn[:400], values[:400], w[:400],
                                  0.7, 0.7, _empty(M, c, dev), **kw)
    chained = tfs.flash_score_update(q, qn, bank[400:], pn[400:], values[400:], w[400:],
                                     0.7, 0.7, half, **kw)
    _assert_close(chained, whole)
    same = tfs.flash_score_update(q, qn, bank, pn, values, torch.zeros_like(w),
                                  0.7, 0.7, whole, **kw)
    # s1/s2 exactly (scale 2^0 = 1, nothing added); m up to the wrapper's
    # float32 shift into and out of the kernel's qn-less base-2 convention
    assert torch.equal(same[1], whole[1]) and torch.equal(same[2], whole[2])
    torch.testing.assert_close(same[0], whole[0], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    """Non-contiguous inputs and more value channels than the wide sums
    hold raise before a launch; 9 channels in 'vpu' run (the wide sums)."""
    dev = _need_cuda()
    q, qn, bank, pn, values, w = _case(16, 12, 32, 3, seed=2, dev=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfs.flash_score_update(q.t().contiguous().t(), qn, bank, pn, values, w,
                               0.8, 0.6, _empty(16, 3, dev))
    c = tfs.WIDE_MAX_CHANNELS + 1
    with pytest.raises(ValueError, match="value channels"):
        tfs.flash_score_update(q, qn, bank, pn, torch.zeros(32, c, device=dev), w, 0.8,
                               0.6, _empty(16, c, dev), v_strategy="mxu")
    big = torch.randn(32, 9, device=dev)
    args = (q, qn, bank, pn, big, w, 0.8, 0.6, _empty(16, 9, dev))
    _assert_close(tfs.flash_score_update(*args, v_strategy="vpu"),
                  tfs.flash_score_update_plain(*args, v_strategy="vpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("rps", [144, 784, 1024])
def test_per_seed_kernel_matches_plain(precision, rps):
    """K5 in the tier's kernel: 2-D weights [S, P] with rows_per_seed, a
    partial last query block per seed at 144 (12x12) and 784 (28x28), one
    seed with its whole chunk excluded. Launches count under the per-seed
    key only; the kernel equals S one-seed 1-D launches on each seed's rows
    (rows are independent) within 1e-6."""
    dev = _need_cuda()
    S, d, P, c = 4, 75, 700, 3
    M = S * rps
    q, qn, bank, pn, values, _ = _case(M, d, P, c, seed=rps, dev=dev)
    w = torch.rand(S, P, generator=torch.Generator().manual_seed(rps)).to(dev)
    w[w < 0.3] = 0.0
    w[2] = 0.0
    state = tfs.flash_score_update_plain(q, qn, bank, pn, values, w[0], 0.8, 0.6,
                                         _empty(M, c, dev), precision=precision)
    args = (q, qn, bank, pn, values, w, 0.7, 0.5, state)
    name = tfs.KERNEL_OF[precision]
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args, precision=precision, rows_per_seed=rps)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {
        **before, name + tfs.PER_SEED: before[name + tfs.PER_SEED] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args, precision=precision,
                                                    rows_per_seed=rps))
    for s in range(S):
        r = slice(s * rps, (s + 1) * rps)
        one = tfs.flash_score_update(q[r], qn[r], bank, pn, values, w[s].contiguous(),
                                     0.7, 0.5, tuple(x[r] for x in state),
                                     precision=precision)
        for a, b in zip(one, got):
            assert _rel(a, b[r]) <= 1e-6
    r = slice(2 * rps, 3 * rps)  # the excluded seed keeps its state
    assert torch.equal(got[1][r], state[1][r]) and torch.equal(got[2][r], state[2][r])


def _fast(strategy, values, d, c):
    """('default' keywords, values) of a value strategy; 'inbank' takes the
    bank's columns from the middle of d and no values."""
    if strategy == "inbank":
        return dict(v_strategy="inbank", inbank_cols=((d - c) // 2, c)), None
    return dict(v_strategy=strategy), values


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["vpu", "mxu1", "inbank"])
@pytest.mark.parametrize("M,d,P,c", SHAPES)
def test_default_kernel_matches_plain(M, d, P, c, strategy):
    """'default' launches the bf16-exp kernel under its strategy's count,
    and only that, and matches the plain version (the same roundings)."""
    dev = _need_cuda()
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=M + d + 2, dev=dev)
    kw, values = _fast(strategy, values, d, c)
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, _empty(M, c, dev))
    key = "flash_score_fast" + tfs.STRATEGY_SUFFIX[strategy]
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args, precision="default", **kw)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {**before, key: before[key] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args, precision="default", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["vpu", "mxu1", "inbank"])
def test_default_kernel_chaining_and_excluded_chunk(strategy):
    """Two chained 'default' launches against the plain version chained at
    the same row (one call differs from two by the tier's re-basing of m),
    and an all-excluded chunk leaves s1, s2 bit-identical."""
    dev = _need_cuda()
    M, d, P, c = 256, 147, 1000, 3
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=3, dev=dev)
    kw, values = _fast(strategy, values, d, c)
    kw["precision"] = "default"
    v = (lambda a, b: None) if values is None else (lambda a, b: values[a:b])
    outs = []
    for fn in (tfs.flash_score_update, tfs.flash_score_update_plain):
        half = fn(q, qn, bank[:400], pn[:400], v(0, 400), w[:400], 0.7, 0.7,
                  _empty(M, c, dev), **kw)
        outs.append(fn(q, qn, bank[400:], pn[400:], v(400, P), w[400:], 0.7, 0.7,
                       half, **kw))
    _assert_close(*outs)
    whole = outs[0]
    same = tfs.flash_score_update(q, qn, bank, pn, values, torch.zeros_like(w),
                                  0.7, 0.7, whole, **kw)
    assert torch.equal(same[1], whole[1]) and torch.equal(same[2], whole[2])
    torch.testing.assert_close(same[0], whole[0], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["mxu1", "inbank"])
def test_default_per_seed_tensor_core_values(strategy):
    """K5 with the tensor-core value sums: per-seed weights at rows_per_seed
    784 (a partial last block per seed) with an all-excluded seed, against
    the plain version and against one-seed 1-D launches (1e-6)."""
    dev = _need_cuda()
    S, rps, d, P, c = 4, 784, 75, 700, 3
    M = S * rps
    q, qn, bank, pn, values, _ = _case(M, d, P, c, seed=7, dev=dev)
    kw, values = _fast(strategy, values, d, c)
    kw["precision"] = "default"
    w = torch.rand(S, P, generator=torch.Generator().manual_seed(7)).to(dev)
    w[w < 0.3] = 0.0
    w[2] = 0.0
    key = "flash_score_fast" + tfs.STRATEGY_SUFFIX[strategy] + tfs.PER_SEED
    before = dict(tfs.flash_score_update.launches)
    args = (q, qn, bank, pn, values, w, 0.7, 0.5, _empty(M, c, dev))
    got = tfs.flash_score_update(*args, rows_per_seed=rps, **kw)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {**before, key: before[key] + 1}
    live = got[1] > 0
    want = tfs.flash_score_update_plain(*args, rows_per_seed=rps, **kw)
    assert torch.equal(live, want[1] > 0)
    _assert_close(tuple(x[live] for x in got), tuple(x[live] for x in want))
    for s in (0, 3):
        r = slice(s * rps, (s + 1) * rps)
        one = tfs.flash_score_update(q[r], qn[r], bank, pn, values, w[s].contiguous(),
                                     0.7, 0.5, _empty(rps, c, dev), **kw)
        for a, b in zip(one, got):
            assert _rel(a, b[r]) <= 1e-6


def _forced_mask(M, P, dev):
    """A skip mask that tests the mechanism, not the bound: the first and
    the last stats block, every other one, and every block of two query
    blocks (the first and one in the middle)."""
    mask = torch.zeros(tfs.prune_grid(M, P), dtype=torch.int32)
    mask[:, ::2] = 1
    mask[:, -1] = 1
    mask[[0, mask.shape[0] // 2]] = 1
    return mask.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,strategy", [
    ("highest", "vpu"), ("high", "vpu"), ("default", "vpu"), ("default", "mxu1"),
    ("default", "inbank")])
@pytest.mark.parametrize("P", [4096 + 700, 3 * 2048])
def test_prune_kernel_matches_plain(precision, strategy, P):
    """K6 in every kernel: a forced mask against the plain version with the
    same mask (launches under the '/prune' key only), a partial last query
    block and a partial last stats block; an all-skipped query block
    keeps its carried state bit for bit; an all-zero mask equals no mask
    bit for bit."""
    dev = _need_cuda()
    M, d, c = 1000, 75, 3
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=P, dev=dev)
    kw, values = _fast(strategy, values, d, c) if precision == "default" else ({}, values)
    kw["precision"] = precision
    state = tfs.flash_score_update_plain(q, qn, bank[:500], pn[:500],
                                         None if values is None else values[:500],
                                         w[:500], 0.8, 0.6, _empty(M, c, dev), **kw)
    mask = _forced_mask(M, P, dev)
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, state)
    key = tfs.KERNEL_OF[precision] + tfs.STRATEGY_SUFFIX[strategy] + tfs.PRUNE
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args, prune_mask=mask, **kw)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {**before, key: before[key] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args, prune_mask=mask, **kw))
    for r in (slice(0, 64), slice(mask.shape[0] // 2 * 64, mask.shape[0] // 2 * 64 + 64)):
        assert torch.equal(got[1][r], state[1][r]) and torch.equal(got[2][r], state[2][r])
        torch.testing.assert_close(got[0][r], state[0][r], rtol=1e-6, atol=0)
    zero = tfs.flash_score_update(*args, prune_mask=torch.zeros_like(mask), **kw)
    for a, b in zip(zero, tfs.flash_score_update(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_prune_mask_refused_before_launch():
    dev = _need_cuda()
    q, qn, bank, pn, values, w = _case(128, 27, 4096, 3, seed=9, dev=dev)
    before = dict(tfs.flash_score_update.launches)
    with pytest.raises(ValueError, match="prune_mask shape"):
        tfs.flash_score_update(q, qn, bank, pn, values, w, 0.8, 0.6, _empty(128, 3, dev),
                               prune_mask=torch.zeros(2, 3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="vector-label"):
        tfs.flash_score_update(q, qn, bank, pn, values, w[None].repeat(2, 1), 0.8, 0.6,
                               _empty(128, 3, dev), rows_per_seed=64,
                               prune_mask=torch.zeros(2, 2, dtype=torch.int32, device=dev))
    assert tfs.flash_score_update.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_pruned_module_card_vs_cpu(precision):
    """A pruned ELS module on the card (its own k-means, masks, K6 launches)
    against the same module on the CPU, on flat-colour prototype images
    where the masks skip, at 1e-3 relative to scale."""
    dev = _need_cuda()
    rs = np.random.RandomState(0)
    colour = rs.uniform(-1, 1, (4, 1, 1, 3)).astype(np.float32)
    idx = np.arange(64) * 4 // 64
    imgs = (colour[idx] + 0.01 * rs.normal(size=(64, 16, 16, 3))).astype(np.float32)
    from convolutional_diffusion_tpu_torch.scores import LocalEquivScoreModule

    x = (0.99 * imgs[:2] + 0.1 * rs.normal(size=(2, 16, 16, 3))).astype(np.float32)
    outs = []
    key = tfs.KERNEL_OF[precision] + tfs.PRUNE
    before = tfs.flash_score_update.launches[key]
    for device in (dev, "cpu"):
        mod = LocalEquivScoreModule((imgs, idx), batch_size=16, precision=precision,
                                    prune=True, device=device)
        outs.append(mod(0.02, x, k=3).cpu())
    assert tfs.flash_score_update.launches[key] == before + 1
    assert _rel(*outs) <= 1e-3


# The variants of the matrix value sums and the exponential apart from the
# tier: (precision, fast_exp, strategy), every combination the JAX wrapper
# takes ('high' + bf16 exp runs the 'default' kernel, 'default' + fp32 exp2
# the 'high' kernel).
VARIANTS = [
    (precision, fast, strategy)
    for precision in ("highest", "high", "default")
    for fast in (False, True)
    for strategy in ("vpu", "mxu", "inbank", "mxu1")
    if fast or strategy != "mxu1"
]


def _variant_kw(precision, fast, strategy, values, d, c):
    """(keywords, values, launch key) of a variant; 'inbank' reads the
    bank's columns from the middle of d and no values."""
    kw = dict(precision=precision, fast_exp=fast)
    if strategy == "inbank":
        kw.update(v_strategy="inbank", inbank_cols=((d - c) // 2, c))
        values = None
    else:
        kw.update(v_strategy=strategy)
    # the key depends on no shape and no c (c = 1 leaves 'mxu1' a spare lane)
    key = tfs.sweep_plan(precision, fast, strategy, 1, 0, 0, 0, d,
                         inbank_cols=kw.get("inbank_cols")).key
    return kw, values, key


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 9, 16, 48, 256])
@pytest.mark.parametrize("precision,fast,strategy", VARIANTS,
                         ids=lambda v: str(v).lower())
def test_variant_kernel_matches_plain(precision, fast, strategy, c):
    """Each (tier, exponential, value strategy) launches its kernel under
    its key, and only that, and matches the plain version, at c = 3 (the
    per-row sums where they apply), 9, 16, 48 and 256 (the wide sums, s2 in
    the state's rows in device memory; 48 takes two passes of the
    tensor-core value sums, 256 the most channels the kernels take)."""
    dev = _need_cuda()
    M, d, P = 1000, 9 * c, 2048 + 700
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=c + len(strategy), dev=dev)
    kw, values, key = _variant_kw(precision, fast, strategy, values, d, c)
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, _empty(M, c, dev))
    if strategy == "mxu1" and c % 128 == 0:  # the JAX wrapper's rule: no lane for s1
        with pytest.raises(ValueError, match="no spare lane"):
            tfs.flash_score_update(*args, **kw)
        return
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {**before, key: before[key] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fast,strategy", [
    ("highest", False, "mxu"), ("high", False, "mxu"), ("default", True, "mxu"),
    ("highest", False, "inbank"), ("high", False, "inbank"), ("highest", True, "mxu"),
    ("highest", True, "inbank")], ids=lambda v: str(v).lower())
def test_variant_per_seed_chained_and_excluded(precision, fast, strategy):
    """K5 with the new variants at c = 16: per-seed weights at rows_per_seed
    784 with an all-excluded seed, against the plain version and against
    one-seed 1-D launches (1e-6); two chained 1-D calls against the plain
    chain; an all-excluded chunk leaves s1 and s2 bit-identical."""
    dev = _need_cuda()
    S, rps, c = 4, 784, 16
    d, P, M = 9 * c, 700, S * rps
    q, qn, bank, pn, values, _ = _case(M, d, P, c, seed=11, dev=dev)
    kw, values, key = _variant_kw(precision, fast, strategy, values, d, c)
    w = torch.rand(S, P, generator=torch.Generator().manual_seed(11)).to(dev)
    w[w < 0.3] = 0.0
    w[2] = 0.0
    before = dict(tfs.flash_score_update.launches)
    args = (q, qn, bank, pn, values, w, 0.7, 0.5, _empty(M, c, dev))
    got = tfs.flash_score_update(*args, rows_per_seed=rps, **kw)
    torch.cuda.synchronize()
    pkey = key + tfs.PER_SEED
    assert tfs.flash_score_update.launches == {**before, pkey: before[pkey] + 1}
    live = got[1] > 0
    want = tfs.flash_score_update_plain(*args, rows_per_seed=rps, **kw)
    assert torch.equal(live, want[1] > 0)
    _assert_close(tuple(x[live] for x in got), tuple(x[live] for x in want))
    for s in (0, 3):
        r = slice(s * rps, (s + 1) * rps)
        one = tfs.flash_score_update(q[r], qn[r], bank, pn, values, w[s].contiguous(),
                                     0.7, 0.5, _empty(rps, c, dev), **kw)
        for a, b in zip(one, got):
            assert _rel(a, b[r]) <= 1e-6
    v = (lambda a, b: None) if values is None else (lambda a, b: values[a:b])
    w1 = w[0].contiguous()
    outs = []
    for fn in (tfs.flash_score_update, tfs.flash_score_update_plain):
        half = fn(q, qn, bank[:300], pn[:300], v(0, 300), w1[:300], 0.7, 0.7,
                  _empty(M, c, dev), **kw)
        outs.append(fn(q, qn, bank[300:], pn[300:], v(300, P), w1[300:], 0.7, 0.7,
                       half, **kw))
    _assert_close(*outs)
    same = tfs.flash_score_update(q, qn, bank, pn, values, torch.zeros_like(w1),
                                  0.7, 0.7, outs[0], **kw)
    assert torch.equal(same[1], outs[0][1]) and torch.equal(same[2], outs[0][2])


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fast,strategy", [
    ("highest", False, "mxu"), ("high", False, "mxu"), ("highest", False, "inbank"),
    ("high", False, "inbank"), ("highest", True, "mxu"), ("default", True, "mxu"),
    ("default", True, "vpu"), ("default", True, "inbank"), ("default", True, "mxu1"),
    ("high", False, "vpu"), ("highest", True, "vpu"), ("highest", False, "vpu")],
    ids=lambda v: str(v).lower())
def test_variant_prune_kernel_matches_plain(precision, fast, strategy):
    """K6 with the new variants at c = 16: a forced mask against the plain
    version with the same mask (launches under the '/prune' key only); an
    all-skipped query block keeps its carried state bit for bit; an
    all-zero mask equals no mask bit for bit."""
    dev = _need_cuda()
    M, c, P = 1000, 16, 4096 + 700
    d = 9 * c
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=13, dev=dev)
    kw, values, key = _variant_kw(precision, fast, strategy, values, d, c)
    state = tfs.flash_score_update_plain(q, qn, bank[:500], pn[:500],
                                         None if values is None else values[:500],
                                         w[:500], 0.8, 0.6, _empty(M, c, dev), **kw)
    mask = _forced_mask(M, P, dev)
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, state)
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args, prune_mask=mask, **kw)
    torch.cuda.synchronize()
    pkey = key + tfs.PRUNE
    assert tfs.flash_score_update.launches == {**before, pkey: before[pkey] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args, prune_mask=mask, **kw))
    r = slice(0, 64)
    assert torch.equal(got[1][r], state[1][r]) and torch.equal(got[2][r], state[2][r])
    zero = tfs.flash_score_update(*args, prune_mask=torch.zeros_like(mask), **kw)
    for a, b in zip(zero, tfs.flash_score_update(*args, **kw)):
        assert torch.equal(a, b)


# The split-bank grid of K1 and K2 ('vpu', c <= 8, fp32 exp2): chunks longer
# than one split (fs.SPLIT_ROWS) run as several splits merged in order.
SPLIT_P = 2 * tfs.SPLIT_ROWS + 777


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("case", ["1-D", "per-seed", "masked"])
def test_split_bank_kernels_match_plain(precision, case):
    dev = _need_cuda()
    M, d, P, c = 256, 75, SPLIT_P, 3
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=11, dev=dev)
    kw = dict(precision=precision)
    if case == "per-seed":
        w = torch.stack([w, w.flip(0), torch.zeros_like(w), w * (w > 0.5)])
        kw["rows_per_seed"] = M // 4
    if case == "masked":
        mask = torch.zeros(tfs.prune_grid(M, P), dtype=torch.int32, device=dev)
        mask[::2, ::3] = 1
        mask[1] = 1
        kw["prune_mask"] = mask
    assert len(tfs.sweep_plan(precision, None, "vpu", c, M, M, P, d).splits) == 3
    state = tuple(x.clone() for x in tfs.flash_score_update_plain(
        q, qn, bank[:500], pn[:500], values[:500], w[..., :500].contiguous(), 0.8, 0.6,
        _empty(M, c, dev), **{k_: v for k_, v in kw.items() if k_ != "prune_mask"}))
    state[0][::7], state[1][::7], state[2][::7] = tfs.NEG_INF, 0.0, 0.0
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, state)
    got = tfs.flash_score_update(*args, **kw)
    torch.cuda.synchronize()
    _assert_close(got, tfs.flash_score_update_plain(*args, **kw))
    if case == "masked":  # the all-skipped query block keeps its state bit for bit
        rows = slice(tfs.PRUNE_ROWS, 2 * tfs.PRUNE_ROWS)
        got_k = tfs.sweep_kernel(q, torch.zeros(P, device=dev), bank, values, 0.1,
                                 *(x.contiguous() for x in state), precision=precision,
                                 prune_mask=mask)
        assert all(torch.equal(a[rows], b[rows]) for a, b in zip(got_k, state))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_split_bank_per_seed_equals_one_seed_launches(precision):
    dev = _need_cuda()
    M, d, P, c, S = 512, 27, SPLIT_P, 3, 4
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=12, dev=dev)
    w2 = torch.stack([w, w.flip(0), torch.zeros_like(w), w * (w > 0.5)])
    rps = M // S
    got = tfs.flash_score_update(q, qn, bank, pn, values, w2, 0.8, 0.6, _empty(M, c, dev),
                                 precision=precision, rows_per_seed=rps)
    for s in range(S):
        r = slice(s * rps, (s + 1) * rps)
        one = tfs.flash_score_update(q[r], qn[r], bank, pn, values, w2[s].contiguous(),
                                     0.8, 0.6, _empty(rps, c, dev), precision=precision)
        assert all(torch.equal(a[r], b) for a, b in zip(got, one))


# K5's walk: each block walks only its seed's live tiles (`tile_counts`),
# and the launch is the one-seed launches' bits. (precision, fast_exp,
# strategy, c): both main loops, the split and the one-split modes.
WALKS = [("highest", False, "vpu", 3), ("highest", False, "mxu", 16),
         ("highest", True, "mxu", 16), ("high", False, "vpu", 3),
         ("high", False, "mxu", 16), ("default", True, "vpu", 3),
         ("default", True, "inbank", 3), ("default", True, "mxu", 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fast,strategy,c", WALKS, ids=lambda v: str(v).lower())
def test_k5_walks_each_seeds_live_tiles(precision, fast, strategy, c):
    """Label-filtered weights over a chunk of three splits (images of 300
    rows, so tiles straddle images; seed s admits every third image from
    the s-th, the last seed none): the tiles each block walked equal its
    seed's live tiles in its split (`live_tiles_plain`), and every seed's
    rows are its one-seed 1-D launch's, bit for bit."""
    dev = _need_cuda()
    S, rps, d, P = 4, 200, 9 * c if c > 3 else 75, SPLIT_P
    M = S * rps
    q, _, bank, _, values, _ = _case(M, d, P, c, seed=16, dev=dev)
    img = torch.arange(P, device=dev) // 300
    bias = torch.randn(S, P, generator=torch.Generator().manual_seed(16)).to(dev)
    for s in range(S):
        bias[s][(img % 3 != s) | (s == S - 1)] = tfs.NEG_INF
    plan = tfs.sweep_plan(precision, fast, strategy, c, M, rps, P, d, True, False,
                          ((d - c) // 2, c) if strategy == "inbank" else None)
    kw = dict(precision=plan.tier, fast_exp=fast, strategy=strategy)
    if strategy == "inbank":
        kw["col0"], values = (d - c) // 2, None
    split_rows, nsplit, grid = plan.splits[0][1], len(plan.splits), plan.grid
    counts = torch.full((grid[0] * grid[1] * grid[2],), -1, dtype=torch.int32, device=dev)
    got = tfs.sweep_kernel(q, bias, bank, values, 0.0537109375, *_empty(M, c, dev), **kw,
                           tile_counts=counts)
    live = tfs.live_tiles_plain(bias)
    per = -(-split_rows // tfs.FAST_TILE)
    want = torch.stack([live[:, z * per:(z + 1) * per].sum(1) for z in range(nsplit)])
    assert torch.equal(counts.long(), want[:, :, None].expand(nsplit, S, grid[0]).reshape(-1))
    assert 0 < live.float().mean() < 0.5
    for s in range(S):
        r = slice(s * rps, (s + 1) * rps)
        one = tfs.sweep_kernel(q[r].contiguous(), bias[s].contiguous(), bank, values,
                               0.0537109375, *_empty(rps, c, dev), **kw)
        assert all(torch.equal(a[r], b) for a, b in zip(got, one))


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fast,strategy,c", WALKS, ids=lambda v: str(v).lower())
def test_launch_follows_its_plan(precision, fast, strategy, c):
    """One K5 launch through `sweep_kernel` counts under its plan's key, and
    runs on its plan's grid: each of the grid's blocks writes its walked
    tiles into `tile_counts`, and no entry past the grid is written."""
    dev = _need_cuda()
    S, rps, d, P = 4, 200, 9 * c if c > 3 else 75, SPLIT_P
    M = S * rps
    q, _, bank, _, values, _ = _case(M, d, P, c, seed=18, dev=dev)
    bias = torch.randn(S, P, generator=torch.Generator().manual_seed(18)).to(dev)
    bias[:, ::3] = tfs.NEG_INF
    col0 = (d - c) // 2 if strategy == "inbank" else -1
    plan = tfs.sweep_plan(precision, fast, strategy, c, M, rps, P, d, True, False,
                          (col0, c) if strategy == "inbank" else None)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    counts = torch.full((blocks + 64,), -1, dtype=torch.int32, device=dev)
    before = dict(tfs.flash_score_update.launches)
    tfs.sweep_kernel(q, bias, bank, None if strategy == "inbank" else values, 0.0537109375,
                     *_empty(M, c, dev), precision=plan.tier, strategy=plan.strategy,
                     col0=col0, fast_exp=plan.fast, tile_counts=counts)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {**before, plan.key: before[plan.key] + 1}
    assert bool((counts[:blocks] >= 0).all()) and bool((counts[blocks:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,c", [("vpu", 3), ("mxu", 16)])
def test_k1_masked_walk_under_an_empty_mask_is_the_unmasked(strategy, c):
    """K1's list walk (K6) under a mask that skips nothing returns the
    unmasked launch's bits: the bias copies of its two mask rows are the
    bias, and the walk takes every tile in order."""
    dev = _need_cuda()
    args, kw = _kernel_args(256, 9 * c, SPLIT_P, c, 17, dev, strategy)
    state = _carried(256, c, dev, seed=17)
    mask = torch.zeros(tfs.prune_grid(256, SPLIT_P), dtype=torch.int32, device=dev)
    got = tfs.sweep_kernel(*args, *state, precision="highest", prune_mask=mask, **kw)
    want = tfs.sweep_kernel(*args, *state, precision="highest", **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_split_bank_logits_are_the_parents():
    """One launch from the empty state returns m = the row max of the
    logits: K1's equals the row max of its fp32 order
    (`fp32_logits_in_order`), K2's the 'default' kernel's (both run the one
    split-dot loop, whose dot is the per-block loop's before it, step for
    step)."""
    dev = _need_cuda()
    M, d, P, c = 128, 243, SPLIT_P, 3
    q, _, bank, _, values, _ = _case(M, d, P, c, seed=13, dev=dev)
    bias = torch.randn(P, device=dev)
    empty = _empty(M, c, dev)
    ds = 0.0537109375  # a float32 value, as the wrapper's dotscale is
    m1 = tfs.sweep_kernel(q, bias, bank, values, ds, *empty, precision="highest")[0]
    ref = tfs.fp32_logits_in_order(q, bank, ds, bias).amax(1)
    assert torch.equal(m1, ref)
    m2 = tfs.sweep_kernel(q, bias, bank, values, ds, *empty, precision="high")[0]
    m3 = tfs.sweep_kernel(q, bias, bank, values, ds, *empty, precision="default")[0]
    assert torch.equal(m2, m3)


def _kernel_args(M, d, P, c, seed, dev, strategy):
    """Kernel-convention inputs of `tfs.sweep_kernel` (a random bias row with
    excluded patches, dotscale a float32 value) and the keywords of a value
    strategy ('inbank' reads the middle columns of d)."""
    q, _, bank, _, values, _ = _case(M, d, P, c, seed=seed, dev=dev)
    bias = torch.randn(P, generator=torch.Generator().manual_seed(seed)).to(dev) * 2
    bias[::11] = tfs.NEG_INF
    kw = dict(strategy=strategy)
    if strategy == "inbank":
        kw["col0"], values = (d - c) // 2, None
    return (q, bias, bank, values, 0.0537109375), kw


def _carried(M, c, dev, seed):
    """A carried state with sentinel rows, in the kernels' convention."""
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(M, generator=g) * 3 + 10
    s1 = torch.rand(M, generator=g) + 0.5
    s2 = torch.randn(M, c, generator=g)
    m[::5], s1[::5], s2[::5] = tfs.NEG_INF, 0.0, 0.0
    return tuple(x.to(dev) for x in (m, s1, s2))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16, 256])
@pytest.mark.parametrize("strategy", ["vpu", "mxu", "inbank"])
def test_merge_pass_matches_merge_splits_plain(strategy, c):
    """K1 with the fp32 exp2 over a chunk of three splits (the per-row sums
    at c = 3, the wide sums otherwise): one launch against the launches of
    each split's rows from the empty state, merged by `merge_splits_plain`
    into a carried state with sentinel rows, within 1e-6 on m + log s1 and
    s2 / s1 (the merge pass fuses each product and sum, the plain merge
    rounds them apart); a row that no split reaches keeps its state bit for
    bit."""
    dev = _need_cuda()
    M, c_ = 256, c
    d = 9 * c if strategy != "vpu" or c > 8 else 75
    args, kw = _kernel_args(M, d, SPLIT_P, c_, 14 + c, dev, strategy)
    q, bias, bank, values, ds = args
    state = _carried(M, c_, dev, seed=c)
    plan = tfs.sweep_plan("highest", None, strategy, c_, M, M, SPLIT_P, d,
                          inbank_cols=(kw["col0"], c_) if strategy == "inbank" else None).splits
    assert len(plan) == 3
    got = tfs.sweep_kernel(*args, *state, precision="highest", **kw)
    parts = [tfs.sweep_kernel(q, bias[p0:p1].contiguous(), bank[p0:p1].contiguous(),
                              None if values is None else values[p0:p1].contiguous(), ds,
                              *_empty(M, c_, dev), precision="highest", **kw)
             for p0, p1 in plan]
    want = tfs.merge_splits_plain(state, parts)
    live = want[1] > 0
    for a, b in zip(got, want):
        assert torch.equal(a[~live], b[~live])
    lse = [x[0][live] + torch.log(x[1][live]) for x in (got, want)]
    assert _rel(*lse) <= 1e-6
    assert _rel(got[2][live] / got[1][live, None], want[2][live] / want[1][live, None]) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fast,strategy", VARIANTS, ids=lambda v: str(v).lower())
def test_variant_per_seed_equals_one_seed_launches(precision, fast, strategy):
    """K5 on the two main loops at c = 16: per-seed weights at
    rows_per_seed 784 (a partial last block per seed) over a chunk of three
    splits, against one-seed 1-D launches on each seed's rows, bit for bit:
    a block never mixes seeds and does the one-seed launch's arithmetic."""
    dev = _need_cuda()
    S, rps, c = 3, 784, 16
    d, M = 9 * c, S * rps
    q, qn, bank, pn, values, _ = _case(M, d, SPLIT_P, c, seed=15, dev=dev)
    kw, values, _ = _variant_kw(precision, fast, strategy, values, d, c)
    w = torch.rand(S, SPLIT_P, generator=torch.Generator().manual_seed(15)).to(dev)
    w[w < 0.3] = 0.0
    got = tfs.flash_score_update(q, qn, bank, pn, values, w, 0.7, 0.5, _empty(M, c, dev),
                                 rows_per_seed=rps, **kw)
    for s in range(S):
        r = slice(s * rps, (s + 1) * rps)
        one = tfs.flash_score_update(q[r], qn[r], bank, pn, values, w[s].contiguous(), 0.7,
                                     0.5, _empty(rps, c, dev), **kw)
        assert all(torch.equal(a, b[r]) for a, b in zip(one, got))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16])
def test_moved_variants_logits_are_the_parents(c):
    """One launch from the empty state returns m = the row max of its
    logits. On K1's loop, every strategy with either exponential equals the
    row max of `fp32_logits_in_order` (K1's fp32 order); on the split-dot
    loop, every strategy of K2 and of the 'default' kernel equals K2's
    per-row launch, so the logits are the same bits in every mode."""
    dev = _need_cuda()
    M, P = 256, SPLIT_P
    d = 9 * c
    args, _ = _kernel_args(M, d, P, c, 16, dev, "vpu")
    q, bias, bank, values, ds = args
    empty = _empty(M, c, dev)
    ref = tfs.fp32_logits_in_order(q, bank, ds, bias).amax(1)
    k2 = tfs.sweep_kernel(q, bias, bank, values[:, :3].contiguous(), ds, *_empty(M, 3, dev),
                          precision="high")[0]
    for precision, fast, strategy in VARIANTS:
        prec = tfs.sweep_plan(precision, fast, strategy, c, M, M, P, d,
                              inbank_cols=((d - c) // 2, c)).tier
        kw = dict(strategy=strategy, fast_exp=fast)
        vals = values
        if strategy == "inbank":
            kw["col0"], vals = (d - c) // 2, None
        m = tfs.sweep_kernel(q, bias, bank, vals, ds, *empty, precision=prec, **kw)[0]
        assert torch.equal(m, ref if prec == "highest" else k2), (precision, fast, strategy)




# --- K2's per-row sums on the warp-specialised loop -----------------------------
# (128-row query blocks of two consumer warpgroups, TMA staging), at the bbELS
# centre's shapes: d = 3 k^2 and M = 4 (65 - k)^2 query rows, ragged against
# the blocks, over a chunk of three splits ragged against the 128-row tile.


def _centre(k, seed, dev, c=3):
    """The bbELS centre's sweep at k: inputs (`_case`) and a carried state
    with sentinel rows (the plain sweep over the chunk's first 500 rows,
    every seventh row reset to the empty state)."""
    M, d, P = 4 * (65 - k) ** 2, 3 * k * k, SPLIT_P
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=seed, dev=dev)
    state = tuple(x.clone() for x in tfs.flash_score_update_plain(
        q, qn, bank[:500], pn[:500], values[:500], w[:500], 0.8, 0.6, _empty(M, c, dev),
        precision="high"))
    state[0][::7], state[1][::7], state[2][::7] = tfs.NEG_INF, 0.0, 0.0
    return (q, qn, bank, pn, values, w), state


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 9, 27])
def test_k2_loop_at_the_bbels_centre(k):
    """One 'high' launch (K2, and only K2) from a carried state against the
    plain version."""
    dev = _need_cuda()
    inputs, state = _centre(k, 100 + k, dev)
    M, P = inputs[0].shape[0], inputs[2].shape[0]
    assert P % 128 != 0 and len(tfs.sweep_plan("high", None, "vpu", 3, M, M, P,
                                                 inputs[0].shape[1]).splits) == 3
    args = (*inputs, 0.8, 0.6, state)
    before = dict(tfs.flash_score_update.launches)
    got = tfs.flash_score_update(*args, precision="high")
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches == {
        **before, "flash_score_bf16x3": before["flash_score_bf16x3"] + 1}
    _assert_close(got, tfs.flash_score_update_plain(*args, precision="high"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 27])
def test_k2_loop_chains_and_keeps_an_excluded_chunk(k):
    """Two launches over the chunk's halves (cut off the tile) chain to the
    launch over the whole, from a carried state with sentinel rows; a chunk
    whose weights are all zero leaves s1 and s2 bit for bit."""
    dev = _need_cuda()
    (q, qn, bank, pn, values, w), state = _centre(k, 200 + k, dev)
    cut = 4096 + 300
    kw = dict(precision="high")
    whole = tfs.flash_score_update(q, qn, bank, pn, values, w, 0.8, 0.6, state, **kw)
    half = tfs.flash_score_update(q, qn, bank[:cut], pn[:cut], values[:cut], w[:cut], 0.8,
                                  0.6, state, **kw)
    chained = tfs.flash_score_update(q, qn, bank[cut:], pn[cut:], values[cut:], w[cut:],
                                     0.8, 0.6, half, **kw)
    _assert_close(chained, whole)
    same = tfs.flash_score_update(q, qn, bank, pn, values, torch.zeros_like(w), 0.8, 0.6,
                                  whole, **kw)
    assert torch.equal(same[1], whole[1]) and torch.equal(same[2], whole[2])
    torch.testing.assert_close(same[0], whole[0], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 9])
def test_k2_loop_per_seed_labels(k):
    """K5 on the loop: 8 seeds of the centre's rows, seed s admitting the
    bank rows of label s (images of 300 rows, label = image % 10), against
    the plain version; and two seeds' rows equal their one-seed launches bit
    for bit."""
    dev = _need_cuda()
    rps = (65 - k) ** 2
    M, d, P, c, S = 8 * rps, 3 * k * k, SPLIT_P, 3, 8
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=300 + k, dev=dev)
    label = (torch.arange(P, device=dev) // 300) % 10
    w2 = torch.stack([w * (label == s) for s in range(S)])
    kw = dict(precision="high", rows_per_seed=rps)
    args = (q, qn, bank, pn, values, w2, 0.8, 0.6, _empty(M, c, dev))
    before = tfs.flash_score_update.launches["flash_score_bf16x3/per_seed"]
    got = tfs.flash_score_update(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches["flash_score_bf16x3/per_seed"] == before + 1
    _assert_close(got, tfs.flash_score_update_plain(*args, **kw))
    for s in (0, S - 1):
        r = slice(s * rps, (s + 1) * rps)
        one = tfs.flash_score_update(q[r], qn[r], bank, pn, values, w2[s].contiguous(), 0.8,
                                     0.6, _empty(rps, c, dev), precision="high")
        assert all(torch.equal(a[r], b) for a, b in zip(got, one))


@pytest.mark.cuda
def test_k2_loop_under_a_mask():
    """K6 on the loop: a 128-row block spans two mask rows, and a tile that
    only one of them keeps is walked by that row's warpgroup alone (M = 64 x
    37, ragged against the blocks; cells skipped by one row, by both, by
    none), against the plain version; a block whose rows skip every tile
    keeps its state bit for bit."""
    dev = _need_cuda()
    M, d, P, c = 64 * 37, 75, SPLIT_P, 3
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=400, dev=dev)
    mask = torch.zeros(tfs.prune_grid(M, P), dtype=torch.int32, device=dev)
    mask[::2, ::2] = 1  # the first row of each block skips every other cell
    mask[1::4, 1] = 1  # and the second row of every other block one more
    mask[4:6] = 1  # block 2 skips every tile
    state = tuple(x.clone() for x in tfs.flash_score_update_plain(
        q, qn, bank[:500], pn[:500], values[:500], w[:500], 0.8, 0.6, _empty(M, c, dev),
        precision="high"))
    state[0][::7], state[1][::7], state[2][::7] = tfs.NEG_INF, 0.0, 0.0
    args = (q, qn, bank, pn, values, w, 0.8, 0.6, state)
    before = tfs.flash_score_update.launches["flash_score_bf16x3/prune"]
    got = tfs.flash_score_update(*args, precision="high", prune_mask=mask)
    torch.cuda.synchronize()
    assert tfs.flash_score_update.launches["flash_score_bf16x3/prune"] == before + 1
    _assert_close(got, tfs.flash_score_update_plain(*args, precision="high", prune_mask=mask))
    rows = slice(4 * tfs.PRUNE_ROWS, 6 * tfs.PRUNE_ROWS)
    got_k = tfs.sweep_kernel(q, torch.zeros(P, device=dev), bank, values, 0.1,
                             *(x.contiguous() for x in state), precision="high",
                             prune_mask=mask)
    assert all(torch.equal(a[rows], b[rows]) for a, b in zip(got_k, state))


@pytest.mark.cuda
@pytest.mark.parametrize("per_seed", [False, True])
def test_k2_launch_kernels_are_the_split_families(per_seed):
    """The benchmark's trace reader finds K2 by its kernels' names: every
    kernel one 'high' launch runs (the pre-split, the live-tile pass with
    per-seed weights, the loop, the merge pass) falls in the family
    'split' (1-D weights) or 'split_list' (K5) of
    `port_bench.devtrace.families`."""
    from port_bench import devtrace

    dev = _need_cuda()
    M, d, P, c = 512, 27, SPLIT_P, 3
    args, _ = _kernel_args(M, d, P, c, 17, dev, "vpu")
    q, bias, bank, values, ds = args
    if per_seed:
        bias = torch.stack([bias, bias.flip(0)])
    empty = _empty(M, c, dev)
    tfs.sweep_kernel(q, bias, bank, values, ds, *empty, precision="high")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tfs.sweep_kernel(q, bias, bank, values, ds, *empty, precision="high")
        torch.cuda.synchronize()
    device = devtrace.collect(prof).device
    fams = devtrace.families(device)
    want = "split_list" if per_seed else "split"
    assert [op.name for op in device if "rows_kernel" in op.name]
    assert all(f == want for f in fams), list(zip([op.name for op in device], fams))


# --- the sweep wrapper enqueues without waiting --------------------------------


def _wrapper_case(case, dev):
    """(args, keywords) of one `flash_score_update` at 'highest' on the card
    from a carried state with sentinel rows: 1-D weights (K1), [S, P]
    weights with rows_per_seed (K5), or 1-D weights with a prune mask that
    lies on the card as int32 (K6). The schedule scalars are float32 0-d
    CPU tensors, as the score modules pass them (cosine schedule, step 7 of
    20)."""
    from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule

    S, rps, d, P, c = 4, 256, 75, SPLIT_P, 3
    M = S * rps
    q, qn, bank, pn, values, w = _case(M, d, P, c, seed=21, dev=dev)
    kw = {}
    if case == "K5":
        w = torch.rand(S, P, generator=torch.Generator().manual_seed(21)).to(dev)
        w[w < 0.3] = 0.0
        kw["rows_per_seed"] = rps
    elif case == "K6":
        kw["prune_mask"] = _forced_mask(M, P, dev)
    beta = cosine_noise_schedule(torch.tensor(7.0) / 20)
    at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
    return (q, qn, bank, pn, values, w, at, bt, _carried(M, c, dev, 21)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K1", "K5", "K6"])
def test_update_makes_no_synchronising_call(case):
    """Under `torch.cuda.set_sync_debug_mode("error")` three chained
    `flash_score_update` calls on inputs on the card raise nothing: the
    wrapper copies no schedule scalar to the card and reads nothing back,
    so the host enqueues sweep after sweep ahead of the card. The first
    call (the kernel's build and load) runs before the mode is set; a
    pageable copy of a 0-d CPU tensor to the card shows the mode acts. The
    mode is restored afterwards."""
    dev = _need_cuda()
    args, kw = _wrapper_case(case, dev)
    *inputs, state = args
    tfs.flash_score_update(*args, **kw)
    torch.cuda.synchronize()
    before = sum(tfs.flash_score_update.launches.values())
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.tensor(1.0).to(dev)
        for _ in range(3):
            state = tfs.flash_score_update(*inputs, state, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert torch.cuda.get_sync_debug_mode() == prev
    torch.cuda.synchronize()
    assert sum(tfs.flash_score_update.launches.values()) == before + 3
    assert all(torch.isfinite(x).all() for x in state[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K1", "K5", "K6"])
def test_update_equals_scalars_copied_to_the_card(case):
    """`sweep_bias`, and one `flash_score_update` from a carried state, bit
    for bit the wrapper's expressions with the schedule scalars copied to
    the card first: the bias, m moved by the scaled qn offset into the
    sweep and back out, s1 and s2."""
    dev = _need_cuda()
    args, kw = _wrapper_case(case, dev)
    q, qn, bank, pn, values, w, at, bt, (m0, s10, s20) = args
    inv2bt2 = 1.0 / (2.0 * bt * bt)
    coef = -(at * at) * inv2bt2 * tfs.LOG2E
    logw = torch.where(w > 0.0, torch.log2(torch.clamp(w, min=1e-38)),
                       torch.full_like(w, tfs.NEG_INF))
    bias = torch.clamp(coef.to(dev) * pn + logw, min=tfs.NEG_INF)
    assert torch.equal(tfs.sweep_bias(pn, w, at, bt), bias)
    qn_s = qn * inv2bt2.to(dev)
    m_k = torch.where(m0 <= tfs.NEG_INF * 0.5, m0, (m0 + qn_s) * tfs.LOG2E)
    m, s1, s2 = tfs.sweep_kernel(q, bias, bank, values, float(2.0 * at * inv2bt2 * tfs.LOG2E),
                                 m_k, s10, s20, precision="highest",
                                 prune_mask=kw.get("prune_mask"), fast_exp=False)
    want = (torch.where(m <= tfs.NEG_INF * 0.5, m, m * tfs.LN2 - qn_s), s1, s2)
    got = tfs.flash_score_update(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[0], m0)

# --- the neural half: backbones on the card ---------------------------------


def _rel_scale(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / max(a.abs().max(), b.abs().max(), 1.0)).item()


def test_true_fp32_turns_cudnn_tf32_off_and_restores():
    """Runs anywhere: the flags only."""
    from convolutional_diffusion_tpu_torch.ops.fp32 import tf32_products, true_fp32

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with tf32_products(True):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        with true_fp32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == prev


@pytest.mark.cuda
def test_true_fp32_conv_on_the_card_is_fp32():
    """A 256-channel conv at 'highest' is within fp32 rounding of float64;
    with TF32 allowed it is ~2^-11 off (which shows the switch acts)."""
    from convolutional_diffusion_tpu_torch.ops.fp32 import tf32_products, true_fp32

    dev = _need_cuda()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, 32, 32, generator=g)
    w = torch.randn(256, 256, 3, 3, generator=g) / 48
    exact = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
    xd, wd = x.to(dev), w.to(dev)
    with true_fp32():
        fp32 = torch.nn.functional.conv2d(xd, wd, padding=1)
    with tf32_products(True):
        tf32 = torch.nn.functional.conv2d(xd, wd, padding=1)
    assert _rel_scale(fp32, exact) < 1e-5
    assert _rel_scale(tf32, exact) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["resnet", "unet", "unet_batchnorm"])
def test_backbone_on_the_card_matches_cpu(kind):
    """The same seeded weights and NHWC input, forward at 'highest' on the
    card and on the CPU: within 1e-3 relative to scale (BASELINE.md), and
    within 1e-5, true fp32 against true fp32. The same backbone with TF32
    allowed (precision=None) falls outside 1e-5, which shows that the bound
    sees TF32 reach the backbone's convolutions."""
    from convolutional_diffusion_tpu_torch.models import (
        DiffusionModel,
        MinimalResNet,
        MinimalUNet,
    )

    dev = _need_cuda()

    def build(device, precision="highest"):
        if kind == "resnet":
            net = MinimalResNet(channels=3, emb_dim=256, num_layers=8, mode="zeros",
                                conditional=True, num_classes=10, lastksize=3,
                                precision=precision)
        else:
            net = MinimalUNet(channels=3, fsizes=(64, 128, 256), mode="circular",
                              conditional=True, num_classes=10, lastksize=3,
                              normalization="BatchNorm" if "batchnorm" in kind else "GroupNorm",
                              last_norm=True, precision=precision)
        return DiffusionModel(net, seed=5, device=device)

    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 32, 32, 3, generator=g)
    t = torch.rand(4, generator=g)
    label = torch.randint(0, 10, (4,), generator=g)
    with torch.no_grad():
        cpu = build("cpu")(t, x, label)
        card = build(dev)(t.to(dev), x.to(dev), label.to(dev))
        tf32 = build(dev, precision=None)(t.to(dev), x.to(dev), label.to(dev))
    assert card.shape == cpu.shape and torch.isfinite(card).all()
    assert _rel_scale(card, cpu) <= 1e-3
    assert _rel_scale(card, cpu) <= 1e-5
    assert _rel_scale(tf32, cpu) > 1e-5


# --- the training half on the card ---------------------------------------------


def _train_model(device, precision="highest", normalization=None, seed=3):
    from convolutional_diffusion_tpu_torch.models import (
        DiffusionModel,
        MinimalResNet,
        MinimalUNet,
    )

    if normalization == "BatchNorm":
        net = MinimalUNet(channels=3, fsizes=(64, 128, 256), mode="zeros", conditional=True,
                          num_classes=10, lastksize=3, normalization="BatchNorm",
                          precision=precision)
    else:
        net = MinimalResNet(channels=3, emb_dim=128, num_layers=3, mode="zeros",
                            conditional=True, num_classes=10, lastksize=3, precision=precision)
    return DiffusionModel(net, seed=seed, device=device)


def _train_inputs(b=4, seed=4):
    from convolutional_diffusion_tpu_torch.training import draw_noise

    g = torch.Generator().manual_seed(seed)
    images = torch.rand(b, 32, 32, 3, generator=g) * 2 - 1
    labels = torch.randint(0, 10, (b,), generator=g)
    return (images, labels, *draw_noise(images, g, 1000))


def _one_step(model, images, labels, t, eps):
    """Loss, gradients by name and buffers (CPU float64) of one step in the
    model's dtype."""
    from convolutional_diffusion_tpu_torch.training import (
        TrainConfig,
        TrainState,
        step_with_noise,
    )

    dev, dtype = model.device, next(model.parameters()).dtype
    loss = step_with_noise(TrainState(model, TrainConfig()), images.to(dev, dtype),
                           labels.to(dev), t.to(dev), eps.to(dev, dtype), conditional=True)
    grads = {n: p.grad.double().cpu() for n, p in model.backbone.named_parameters()}
    return loss.double().cpu(), grads, {k: v.double().cpu()
                                        for k, v in model.backbone.named_buffers()}


def _grad_rel(a, b, skip=()):
    keys = [k for k in b if k not in skip]
    return (max((a[k] - b[k]).abs().max().item() for k in keys)
            / max(b[k].abs().max().item() for k in keys))


@pytest.mark.cuda
@pytest.mark.parametrize("normalization", [None, "BatchNorm"])
def test_train_step_on_the_card_matches_cpu(normalization):
    """One train step at 'highest' on the card and on the CPU from the same
    weights, images, t and eps, each against the CPU's float64 step: the
    card's loss, gradients (and BatchNorm's running statistics) within 1e-5
    of it plus twice the CPU float32's own distance from it (float32's
    rounding of these gradients alone reaches ~1e-5 of their scale, and
    the card's is a draw of that size, not the same draw); with TF32
    allowed the step falls outside that bound. The BatchNorm UNet's conv
    biases, whose gradient BatchNorm zeroes, are left out."""
    dev = _need_cuda()
    inputs = _train_inputs()
    ref = _one_step(_train_model("cpu", normalization=normalization).double(), *inputs)
    cpu = _one_step(_train_model("cpu", normalization=normalization), *inputs)
    card = _one_step(_train_model(dev, normalization=normalization), *inputs)
    tf32 = _one_step(_train_model(dev, None, normalization), *inputs)
    skip = ({n for n in ref[1] if n.endswith(("model.0.bias", "model.3.bias"))}
            if normalization else set())

    def errs(x):
        stats = [_rel_scale(x[2][k], ref[2][k]) for k in ref[2] if "running" in k]
        return [_rel_scale(x[0], ref[0]), _grad_rel(x[1], ref[1], skip), max(stats, default=0)]

    own, got, t32 = errs(cpu), errs(card), errs(tf32)
    assert all(e <= 1e-5 + 2 * o for e, o in zip(got, own)), (got, own)
    assert any(e > 1e-5 + 2 * o for e, o in zip(t32, own)), (t32, own)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,allowed", [("highest", False), (None, True)])
def test_tf32_flags_inside_the_backward_on_the_card(precision, allowed):
    """The flags as a conv's gradient hook reads them while autograd runs
    the step's backward on the card (its own thread)."""
    from convolutional_diffusion_tpu_torch.training import (
        TrainConfig,
        TrainState,
        step_with_noise,
    )

    dev = _need_cuda()
    model = _train_model(dev, precision)
    seen = []

    def on_forward(module, args, out):
        out.register_hook(lambda g: seen.append(
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))

    model.backbone.up_projection.register_forward_hook(on_forward)
    images, labels, t, eps = (x.to(dev) for x in _train_inputs())
    step_with_noise(TrainState(model, TrainConfig()), images, labels, t, eps, conditional=True)
    assert seen == [(allowed, allowed)]


@pytest.mark.cuda
def test_resume_on_the_card_is_bit_for_bit(tmp_path):
    """Under cudnn.deterministic, 2 epochs straight against 1 epoch, a
    checkpoint, a restore into a model of other weights and 1 more: the
    same weights and AdamW moments, bit for bit."""
    from convolutional_diffusion_tpu_torch.training import TrainConfig, train_diffusion

    dev = _need_cuda()
    g = torch.Generator().manual_seed(5)
    data = (torch.rand(64, 32, 32, 3, generator=g) * 2 - 1, torch.randint(0, 10, (64,),
                                                                          generator=g))
    cfg = dict(batch_size=16, save_interval=1, seed=2)
    kw = dict(conditional=True, log_fn=lambda s: None)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        whole, _ = train_diffusion(_train_model(dev), data, TrainConfig(epochs=2, **cfg), **kw)
        train_diffusion(_train_model(dev), data, TrainConfig(epochs=1, **cfg),
                        checkpoint_dir=str(tmp_path), **kw)
        resumed, _ = train_diffusion(_train_model(dev, seed=8), data,
                                     TrainConfig(epochs=1, **cfg), resume_from=str(tmp_path),
                                     **kw)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    a, b = resumed.model.backbone.state_dict(), whole.model.backbone.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = resumed.optimizer.state_dict()["state"], whole.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in ob for k in ob[i])


@pytest.mark.cuda
def test_gloo_pair_on_one_card(tmp_path):
    """Two gloo ranks sharing cuda:0 (`tests/torch_multihost_worker.py`,
    suite `parallel`): the sharded ELS (K1 on each rank's shard), bbELS, IS
    and LS against the one-process modules on the card, 1e-5 relative to
    scale (a merge reorders two partial sums); the collective merge with an
    all-excluded shard exactly rank 0's state."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_multihost_worker as W

    from convolutional_diffusion_tpu_torch.cli.common import build_score_module
    from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule

    _need_cuda()
    ranks = W.run_pair("parallel", str(tmp_path), device="cuda")
    images, labels, x = W.parallel_data()
    order = np.arange(48)
    for kind in ("IS", "LS", "ELS", "bbELS"):
        name, dev, got = ranks[0]["routing"][kind]
        assert name.startswith("Sharded") and dev == "cuda"
        one = build_score_module(kind, (images, labels), batch_size=12, image_size=8,
                                 channels=3, schedule=cosine_noise_schedule)
        assert _rel_scale(got, one(0.5, x, order=order).cpu()) <= 1e-5, kind
    _, (m, s1, s2) = W.merge_inputs()
    mg, s1g, s2g = ranks[1]["merge_excluded"]
    assert torch.equal(mg[:4], m[0, :4]) and torch.equal(s1g, s1[0]) and torch.equal(s2g, s2[0])


@pytest.mark.cuda
def test_nccl_world_of_one_is_bit_equal(tmp_path):
    """A world of one over NCCL, in process: the sharded ELS module and a DP
    train step equal the unsharded ones bit for bit (the collectives run,
    and are the identity)."""
    import torch.distributed as dist

    from convolutional_diffusion_tpu_torch.cli.common import build_score_module
    from convolutional_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
    from convolutional_diffusion_tpu_torch.training import (
        TrainConfig,
        TrainState,
        step_with_noise,
    )

    dev = _need_cuda()
    init_distributed("nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mesh = make_mesh(1)
        g = np.random.RandomState(3)
        images = g.uniform(-1, 1, (64, 16, 16, 3)).astype(np.float32)
        labels = g.randint(0, 3, 64)
        x = torch.from_numpy(g.normal(size=(4, 16, 16, 3)).astype(np.float32))
        kw = dict(batch_size=16, image_size=16, channels=3, schedule=cosine_noise_schedule)
        one = build_score_module("ELS", (images, labels), **kw)
        sharded = build_score_module("ELS", (images, labels), mesh=mesh, **kw)
        assert torch.equal(sharded(0.5, x), one(0.5, x))
        inputs = [a.to(dev) for a in _train_inputs()]
        a, b = _train_model(dev), _train_model(dev)
        la = step_with_noise(TrainState(a, TrainConfig()), *inputs, conditional=True)
        lb = step_with_noise(TrainState(b, TrainConfig()), *inputs, conditional=True,
                             mesh=mesh)
        assert torch.equal(la, lb)
        sa, sb = a.backbone.state_dict(), b.backbone.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
        dist.destroy_process_group()


# --- the analysis: differentiable score modules on the card ------------------


def _analysis_case():
    g = np.random.RandomState(5)
    images = g.uniform(-1, 1, (48, 12, 12, 3)).astype(np.float32)
    labels = g.randint(0, 3, 48)
    x = torch.from_numpy(g.normal(size=(1, 12, 12, 3)).astype(np.float32))
    return images, labels, x


@pytest.mark.cuda
def test_kernel_route_refuses_grad_under_jacrev():
    """The kernel has no backward: under jacrev a module on the kernel route
    raises (pointing to use_pallas=False) instead of a Jacobian of zeros."""
    from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import jacobian_nd
    from convolutional_diffusion_tpu_torch.scores import LocalEquivBordersScoreModule

    dev = _need_cuda()
    images, labels, x = _analysis_case()
    mod = LocalEquivBordersScoreModule((images, labels), kernel_size=3, batch_size=16,
                                       device=dev)
    x = x.to(dev)
    before = sum(tfs.flash_score_update.launches.values())
    mod(0.5, x)
    assert sum(tfs.flash_score_update.launches.values()) > before
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        jacobian_nd(x, lambda xb: mod(0.5, xb))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bbELS", "ELS"])
def test_use_pallas_false_jacobian_card_vs_cpu(kind):
    """With use_pallas=False the card differentiates the plain sweep, and
    launches no kernel: its Jacobian against the CPU's within 1e-5 of scale."""
    from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import jacobian_nd
    from convolutional_diffusion_tpu_torch.scores import (
        LocalEquivBordersScoreModule,
        LocalEquivScoreModule,
    )

    dev = _need_cuda()
    cls = LocalEquivBordersScoreModule if kind == "bbELS" else LocalEquivScoreModule
    images, labels, x = _analysis_case()
    jac = {}
    for d in (dev, torch.device("cpu")):
        mod = cls((images, labels), kernel_size=5, batch_size=16, use_pallas=False, device=d)
        mod(0.3, x.to(d))
        before = dict(tfs.flash_score_update.launches)
        jac[d.type] = jacobian_nd(x.to(d), lambda xb: mod(0.3, xb)).cpu()
        assert tfs.flash_score_update.launches == before
    scale = jac["cpu"].abs().max().item()
    assert scale > 1.0
    assert (jac["cuda"] - jac["cpu"]).abs().max().item() <= 1e-5 * scale


# --- bbELS at 64 x 64: K2's centre and the border regions' own chunking -------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [27, 3])
def test_bbels_64x64_high_card_vs_cpu(k):
    """One 'high' bbELS step at 64 x 64 (N = 8, two seeds): the card (K2 for
    the centre, the border regions in border chunks) against the CPU's
    plain route, at 1e-3 relative to scale. At
    k = 27 (d = 2187) the border classes hold 65% of the pixels."""
    from convolutional_diffusion_tpu_torch.scores import LocalEquivBordersScoreModule

    dev = _need_cuda()
    g = np.random.RandomState(27)
    images = g.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
    labels = np.zeros(8, dtype=np.int64)
    x = torch.from_numpy(g.normal(size=(2, 64, 64, 3)).astype(np.float32))
    key = tfs.KERNEL_OF["high"]
    outs = []
    for device in (dev, "cpu"):
        mod = LocalEquivBordersScoreModule((images, labels), batch_size=256,
                                           precision="high", device=device)
        before = tfs.flash_score_update.launches[key]
        outs.append(mod(torch.tensor(0.5), x, k=k).cpu())
        if device is dev:
            assert tfs.flash_score_update.launches[key] > before
    assert _rel(*outs) <= 1e-3
