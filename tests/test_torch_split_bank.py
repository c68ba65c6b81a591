"""Port: the split-bank grid of the per-row kernels K1 and K2, on the CPU.

The kernels cut a chunk's bank axis into `sweep_plan`'s splits, sweep each
from the empty state and fold the partial states into the carried state in
split order (`merge_splits_plain` is the merge pass's plain version); K2
also splits its inputs into bf16 planes once per launch
(`split_planes_plain`). Here: the plan's boundaries, the plain split-and-
merge against the unsplit plain sweep (1e-6 on m + log2 s1 and s2 / s1,
and bit for bit where every split is skipped) and, through the wrapper,
against the JAX kernel in interpret mode (the JAX tests' tolerances), the
planes against `_split_bf16`, and `chip_smoke.py`'s conversion to the
library yardstick (attention with an additive bias) against the plain
sweep in float64."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import convolutional_diffusion_tpu.ops.flash_score as jfs
import convolutional_diffusion_tpu_torch.ops.flash_score as fs
from convolutional_diffusion_tpu_torch.ops import _build

NEG = fs.NEG_INF


def _plan(P, precision="highest", strategy="vpu", c=3, fast=None, M=8192, rps=None, d=27,
          **kw):
    """`fs.sweep_plan` of a 1-D sweep ('inbank' from column 0)."""
    return fs.sweep_plan(precision, fast, strategy, c, M, rps or M, P, d,
                         inbank_cols=(0, c) if strategy == "inbank" else None, **kw)


@pytest.mark.parametrize("P", [1, 127, 4096, 4097, 8192 + 37, 65536, 65536 + 37,
                               524160, 10 ** 6])
def test_split_plan_boundaries(P):
    plan = _plan(P).splits
    assert plan[0][0] == 0 and plan[-1][1] == P
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert len(plan) <= fs.MAX_SPLITS
    for p0, p1 in plan[:-1]:  # every inner boundary on a tile and a prune cell
        assert p1 % 128 == 0 and p1 % fs.PRUNE_BLOCK == 0 and p1 > p0
    if P > fs.SPLIT_ROWS:
        assert len(plan) > 1


@pytest.mark.parametrize("precision,strategy,c,fast,split", [
    ("highest", "vpu", 3, None, True),
    ("high", "vpu", 8, None, True),
    ("default", "vpu", 3, False, True),  # routes to K2
    ("default", "vpu", 3, None, False),  # the bf16 exponential
    ("highest", "vpu", 3, True, False),
    ("high", "mxu", 16, None, False),  # K2's wide sums: one split, carried state
    ("highest", "inbank", 3, None, True),  # K1 splits in every strategy
    ("high", "vpu", 9, None, False),
    ("highest", "mxu", 16, None, True),
    ("highest", "vpu", 9, None, True),
    ("highest", "mxu", 256, None, True),
    ("high", "inbank", 3, None, False),
    ("default", "mxu", 16, None, False),
])
def test_split_plan_variants(precision, strategy, c, fast, split):
    """The loops of the fp32 exp2 split the bank axis (K1's, K2's
    warp-specialised one); the bf16 exponential and the split-dot loop
    run one split."""
    plan = _plan(65536, precision, strategy, c, fast, d=9 * c)
    assert (len(plan.splits) > 1) == split == (plan.grid[2] > 1)
    assert (plan.loop in ("k1", "k2_ws")) == split


@pytest.mark.parametrize("name,precision,M,rps,grid", [
    ("flash_score", "highest", 8192, 8192, (64, 1, 16)),
    ("flash_score", "highest", 8192, 1024, (8, 8, 16)),
    ("flash_score_bf16x3", "high", 8192, 8192, (64, 1, 16)),
    ("flash_score_bf16x3", "high", 2048, 2048, (16, 1, 16)),
    ("flash_score_bf16x3", "high", 8 * 784, 784, (7, 8, 16)),
    ("flash_score_bf16x3", "high", 4 * 62 ** 2, 4 * 62 ** 2, (121, 1, 16)),
])
def test_split_launch_grid(name, precision, M, rps, grid):
    """One plan gives a launch's kernel, splits and grid: the loops' block
    rows come from `_build.SPLIT_BQ` (their nvcc flags)."""
    plan = _plan(65536, precision, M=M, rps=rps)
    assert plan.kernel == name
    assert (plan.splits[0], len(plan.splits), plan.grid) == ((0, fs.SPLIT_ROWS), 16, grid)


@pytest.mark.parametrize("precision,strategy,c,fast", [
    ("default", "vpu", 3, None), ("high", "mxu", 16, None), ("highest", "vpu", 3, True),
    ("default", "inbank", 3, None), ("default", "mxu", 16, None), ("high", "inbank", 3, None),
    ("highest", "mxu", 256, True),
])
def test_split_launch_off_the_grid(precision, strategy, c, fast):
    """Off the split-bank grid (no split of the bank axis) a launch takes the
    whole chunk in one split from the carried state, on the same main loops:
    64-row query blocks (the split-dot loop's; K1's with the bf16
    exponential), one block per query block and seed."""
    plan = _plan(65536, precision, strategy, c, fast)
    assert (plan.splits, plan.grid) == (((0, 65536),), (128, 1, 1))
    plan = _plan(65536, precision, strategy, c, fast, M=8 * 784, rps=784)
    assert (plan.splits, plan.grid) == (((0, 65536),), (13, 8, 1))


@pytest.mark.parametrize("precision,strategy,c,grid", [
    ("highest", "mxu", 16, (64, 1, 16)), ("highest", "inbank", 3, (64, 1, 16)),
    ("highest", "vpu", 9, (64, 1, 16)), ("highest", "mxu", 256, (64, 1, 16)),
])
def test_split_launch_wide_grid(precision, strategy, c, grid):
    """K1's wide value sums after the fp32 exp2 take the per-row sums'
    split-bank grid: 128-row blocks, the same splits."""
    plan = _plan(65536, precision, strategy, c)
    assert (plan.kernel, plan.loop, plan.splits[0], len(plan.splits), plan.grid) == (
        "flash_score", "k1", (0, fs.SPLIT_ROWS), 16, grid)


def test_block_rows_are_the_kernels():
    """The grid's block rows are the loop's: K1 128 (64 with the bf16
    exponential, one split), K2's per-row sums 128 (the warp-specialised
    loop), and the split-dot loop 64 for the 'default' kernel and K2's wide
    modes alike (one loop, one -D flag)."""
    assert _build.SPLIT_BQ == {"k1": 128, "k1_bf16_exp": 64, "k2_ws": 128, "split_dot": 64}
    loops = {(p.kernel, p.loop, p.block_rows) for p in (
        _plan(1000), _plan(1000, fast=True), _plan(1000, "high"),
        _plan(1000, "high", "mxu", 16), _plan(1000, "default"))}
    assert loops == {("flash_score", "k1", 128), ("flash_score", "k1_bf16_exp", 64),
                     ("flash_score_bf16x3", "k2_ws", 128),
                     ("flash_score_bf16x3", "split_dot", 64),
                     ("flash_score_fast", "split_dot", 64)}


@pytest.mark.parametrize("precision,strategy,c,fast,rows", [
    ("high", "vpu", 3, None, 128), ("high", "vpu", 8, None, 128),
    ("default", "vpu", 3, False, 128),  # routes to K2's per-row sums
    ("high", "mxu", 16, None, 64), ("high", "inbank", 3, None, 64),
    ("high", "vpu", 9, None, 64), ("high", "mxu", 3, None, 64),
    ("default", "vpu", 3, None, 64), ("default", "mxu1", 3, None, 64),
    ("default", "inbank", 3, None, 64), ("default", "mxu", 16, None, 64),
])
def test_block_rows_follow_the_loop(precision, strategy, c, fast, rows):
    """A launch's block rows follow the loop its mode runs: K2's per-row
    sums ('vpu', c <= 8, the fp32 exp2) take the warp-specialised loop's
    128, K2's wide modes ('mxu', 'inbank', c > 8) and the 'default' kernel
    the split-dot loop's 64, at any chunk length."""
    for P in (1000, 65536):
        plan = _plan(P, precision, strategy, c, fast)
        assert plan.loop == ("k2_ws" if rows == 128 else "split_dot")
        assert plan.block_rows == rows and plan.grid[0] == 8192 // rows


def test_split_plan_ignores_queries_seeds_and_masks():
    """The split ranges are a function of P and the variant: a K5 launch and
    the one-seed launches it stands for, masked or not, at any number of
    query rows, split alike."""
    for precision, strategy, c in (("highest", "vpu", 3), ("highest", "mxu", 16),
                                   ("high", "vpu", 3), ("default", "vpu", 3)):
        for P in (1000, 65536 + 37):
            plans = [_plan(P, precision, strategy, c, M=M, rps=rps, per_seed=rps < M,
                           prune=prune)
                     for M, rps in ((8192, 8192), (8192, 1024), (7, 7), (8 * 784, 784))
                     for prune in (False, True) if not (prune and rps < M)]
            assert len({p.splits for p in plans}) == 1
            assert {p.key.endswith(fs.PER_SEED) for p in plans} == {False, True}


def test_sweep_plan_is_cached_per_shape():
    """A plan is made once per shape: the same arguments return the same
    object from the cache."""
    args = ("high", None, "vpu", 3, 8192, 1024, 65536, 27, True, False, None)
    first = fs.sweep_plan(*args)
    hits = fs.sweep_plan.cache_info().hits
    assert fs.sweep_plan(*args) is first
    assert fs.sweep_plan.cache_info().hits == hits + 1
    assert fs.sweep_plan.cache_info().maxsize == fs.PLAN_CACHE


def _kernel_inputs(M, d, P, c, seed, S=1):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.normal(size=(M, d)).astype(np.float32))
    bank = torch.from_numpy(rs.normal(size=(P, d)).astype(np.float32))
    values = torch.from_numpy(rs.normal(size=(P, c)).astype(np.float32))
    bias = rs.normal(size=(S, P) if S > 1 else (P,)).astype(np.float32) * 2
    bias[..., rs.rand(P) < 0.1] = NEG  # excluded patches
    return q, torch.from_numpy(bias), bank, values, 0.7


def _state(M, c, seed):
    rs = np.random.RandomState(seed + 100)
    m = torch.from_numpy(rs.normal(size=(M,)).astype(np.float32) * 3 + 10)
    s1 = torch.from_numpy(rs.uniform(0.5, 2, size=(M,)).astype(np.float32))
    s2 = torch.from_numpy(rs.normal(size=(M, c)).astype(np.float32))
    m[::5], s1[::5], s2[::5] = NEG, 0.0, 0.0  # sentinel rows
    return m, s1, s2


def _split_sweep(q, bias, bank, values, dotscale, m, s1, s2, precision="highest",
                 strategy="vpu", col0=-1, prune_mask=None, fast_exp=None):
    """The split-bank launch in plain PyTorch: sweep_plain over each range of
    the plan from the empty state, then the merge."""
    M, c = q.shape[0], s2.shape[1]
    parts = []
    for p0, p1 in _plan(bank.shape[0], precision, strategy, c, fast_exp, d=q.shape[1]).splits:
        mk = None
        if prune_mask is not None:
            mk = prune_mask[:, p0 // fs.PRUNE_BLOCK: -(-p1 // fs.PRUNE_BLOCK)]
        parts.append(fs.sweep_plain(
            q, bias[..., p0:p1], bank[p0:p1], None if values is None else values[p0:p1],
            dotscale, torch.full((M,), NEG), torch.zeros(M), torch.zeros(M, c),
            precision=precision, strategy=strategy, col0=col0, prune_mask=mk,
            fast_exp=fast_exp))
    return fs.merge_splits_plain((m, s1, s2), parts)


def _rel(a, b):
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    assert torch.equal(fin, torch.isfinite(a))
    a, b = a[fin], b[fin]
    return ((a - b).abs().max() / max(a.abs().max(), b.abs().max(), 1.0)).item()


def _invariants(state):
    m, s1, s2 = (x.double() for x in state)
    live = s1 > 0
    return torch.where(live, m + torch.log2(s1), m), s2[live] / s1[live][:, None]


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("case", ["1-D", "per-seed", "masked"])
def test_plain_split_and_merge_equals_unsplit(precision, case):
    M, d, P, c = 64 * 4, 12, 2 * fs.SPLIT_ROWS + 300, 3
    S = 4 if case == "per-seed" else 1
    q, bias, bank, values, ds = _kernel_inputs(M, d, P, c, seed=1, S=S)
    state = _state(M, c, seed=1)
    mask = None
    if case == "masked":
        mask = torch.zeros(fs.prune_grid(M, P), dtype=torch.int32)
        mask[::2, ::3] = 1
        mask[1, :] = 1  # a whole query block skipped
    kw = dict(precision=precision, prune_mask=mask)
    split = _split_sweep(q, bias, bank, values, ds, *state, **kw)
    whole = fs.sweep_plain(q, bias, bank, values, ds, *state, **kw)
    assert len(_plan(P, precision).splits) == 3
    for a, b in zip(_invariants(split), _invariants(whole)):
        assert _rel(a, b) <= 1e-6
    if mask is not None:  # the all-skipped query block keeps its state bit for bit
        rows = slice(fs.PRUNE_ROWS, 2 * fs.PRUNE_ROWS)
        assert all(torch.equal(x[rows], y[rows]) for x, y in zip(split, state))


def test_fully_skipped_splits_leave_the_state_bit_equal():
    M, d, P, c = 64, 8, 2 * fs.SPLIT_ROWS + 5, 3
    q, bias, bank, values, ds = _kernel_inputs(M, d, P, c, seed=2)
    state = _state(M, c, seed=2)
    mask = torch.ones(fs.prune_grid(M, P), dtype=torch.int32)
    out = _split_sweep(q, bias, bank, values, ds, *state, prune_mask=mask)
    assert all(torch.equal(x, y) for x, y in zip(out, state))
    # a split of excluded patches only (bias -1e30) adds nothing either
    empty_bias = torch.full_like(bias, NEG)
    out = _split_sweep(q, empty_bias, bank, values, ds, *state)
    assert all(torch.equal(x, y) for x, y in zip(out, state))


def test_merge_passes_over_empty_partials_bit_for_bit():
    M, c = 16, 2
    state = _state(M, c, seed=3)
    empty = (torch.full((M,), NEG), torch.zeros(M), torch.zeros(M, c))
    out = fs.merge_splits_plain(state, [empty, empty])
    assert all(torch.equal(x, y) for x, y in zip(out, state))
    # one live partial for a few rows, the rest keep their state as it is
    live = tuple(x.clone() for x in empty)
    live[0][:4], live[1][:4], live[2][:4] = 12.0, 1.5, 0.25
    out = fs.merge_splits_plain(state, [empty, live])
    assert all(torch.equal(x[4:], y[4:]) for x, y in zip(out, state))
    assert not torch.equal(out[1][:4], state[1][:4])


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_split_sweep_through_the_wrapper_matches_jax(precision):
    """The split-and-merge launch through the wrapper's conventions against
    the JAX kernel in interpret mode (the JAX kernel tests' tolerances)."""
    rs = np.random.RandomState(4)
    M, d, P, c = 64, 27, fs.SPLIT_ROWS + 700, 3
    q = rs.normal(size=(M, d)).astype(np.float32)
    bank = rs.normal(size=(P, d)).astype(np.float32)
    values = rs.normal(size=(P, c)).astype(np.float32)
    w = rs.uniform(0.5, 1.5, size=(P,)).astype(np.float32)
    w[rs.rand(P) < 0.1] = 0.0
    qn, pn = (q ** 2).sum(1), (bank ** 2).sum(1)
    at, bt = 0.9, 0.45
    empty = (np.full((M,), -1e30, np.float32), np.zeros(M, np.float32),
             np.zeros((M, c), np.float32))
    t = [torch.from_numpy(x) for x in (q, qn, bank, pn, values, w)]
    got = fs._update(_split_sweep, *t, at, bt, tuple(torch.from_numpy(s) for s in empty),
                     precision, None, "vpu", None, None, None)
    want = jfs.flash_score_update(*(jnp.asarray(x) for x in (q, qn, bank, pn, values, w)),
                                  jnp.float32(at), jnp.float32(bt),
                                  tuple(jnp.asarray(s) for s in empty),
                                  precision=precision, interpret=True)
    got = [g.numpy() for g in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_allclose(got[0] + np.log(got[1]), want[0] + np.log(want[1]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[2] / got[1][:, None], want[2] / want[1][:, None],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [1, 27, 32, 243])
def test_split_planes_match_split_bf16(d):
    rs = np.random.RandomState(d)
    x = torch.from_numpy((rs.normal(size=(50, d)) * 10 ** rs.uniform(-3, 3, (50, d)))
                         .astype(np.float32))
    d_pad = -(-d // fs.PLANE_K) * fs.PLANE_K
    hi, lo = fs.split_planes_plain(x, d_pad)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == (50, d_pad)
    ref_hi, ref_lo = fs._split_bf16(x)
    assert torch.equal(hi[:, :d].float(), ref_hi) and torch.equal(lo[:, :d].float(), ref_lo)
    assert not hi[:, d:].float().any() and not lo[:, d:].float().any()


def test_scratch_numel():
    assert _plan(65536, d=867).scratch_numel == 16 * 8192 * 5
    P = 2 * fs.SPLIT_ROWS + 100  # three splits
    n = _plan(P, "high", M=7).scratch_numel
    assert n == -(-3 * 7 * 5 // 4) * 4 + (7 + P) * 32


@pytest.mark.parametrize("c", [16, 256])
def test_scratch_numel_wide_and_default(c):
    """K1's wide partials [nsplit, M, 2 + c]; K1 with the bf16 exponential
    none (its state is written in place); the 'default' kernel and K2's
    wide sums one split's state rows, then the planes of queries and chunk."""
    assert _plan(65536, "highest", "mxu", c, d=4624).scratch_numel == 16 * 8192 * (2 + c)
    assert _plan(65536, "highest", "mxu", c, True, d=4624).scratch_numel == 0
    planes = (8192 + 65536) * 4640
    for precision in ("default", "high"):
        plan = _plan(65536, precision, "mxu", c, d=4624)
        assert plan.scratch_numel == 8192 * (2 + c) + planes
    assert _plan(100, "default", M=7).scratch_numel == 36 + (7 + 100) * 32


@pytest.mark.parametrize("precision,strategy", [
    ("highest", "mxu"), ("highest", "inbank"), ("high", "mxu"), ("high", "inbank")])
def test_plain_split_and_merge_equals_unsplit_wide(precision, strategy):
    """The merge pass over wide partials (c = 16): plain sweeps of the
    chunk's SPLIT_ROWS ranges from the empty state, merged in order into a
    carried state with sentinel rows, against one unsplit plain sweep,
    within 1e-6 on m + log2 s1 and s2 / s1 (fp32 sums in another order);
    'inbank' at 'high' within 2e-5 on s2 / s1: its split value product
    eh.vh + eh.vl + el.vh drops el.vl, ~2^-16 of each term, and e's bf16
    parts are taken against each split's own m."""
    M, c, P = 64 * 2, 16, 2 * fs.SPLIT_ROWS + 300
    d = 9 * c
    q, bias, bank, values, ds = _kernel_inputs(M, d, P, c, seed=6)
    state = _state(M, c, seed=6)
    col0 = (d - c) // 2 if strategy == "inbank" else -1
    vals = None if strategy == "inbank" else values
    kw = dict(precision=precision, strategy=strategy, col0=col0)
    parts = [fs.sweep_plain(q, bias[p0:p1], bank[p0:p1],
                            None if vals is None else vals[p0:p1], ds,
                            torch.full((M,), NEG), torch.zeros(M), torch.zeros(M, c), **kw)
             for p0 in range(0, P, fs.SPLIT_ROWS) for p1 in [min(P, p0 + fs.SPLIT_ROWS)]]
    assert len(parts) == 3
    split = fs.merge_splits_plain(state, parts)
    whole = fs.sweep_plain(q, bias, bank, vals, ds, *state, **kw)
    tol = (1e-6, 2e-5 if (precision, strategy) == ("high", "inbank") else 1e-6)
    for a, b, t in zip(_invariants(split), _invariants(whole), tol):
        assert _rel(a, b) <= t


@pytest.mark.parametrize("S", [1, 4])
def test_yardstick_conversion_matches_the_plain_sweep(S):
    """chip_smoke.py's conversion to the library yardstick: attention with
    an additive per-key bias (scale = dotscale ln 2, bias ln 2), run here as
    float64 F.scaled_dot_product_attention (math backend) with its log-sum-
    exp taken alongside, equals the plain sweep from the empty state
    within 1e-9 relative on m + log2 s1 (natural log, through the wrapper's
    offset) and s2 / s1."""
    M, d, P, c = 64 * S, 27, 600, 3
    q, bias, bank, values, ds = (x.double() if torch.is_tensor(x) else x
                                 for x in _kernel_inputs(M, d, P, c, seed=5, S=S))
    bias[..., :7] = NEG  # excluded patches as the wrapper writes them
    m, s1, s2 = fs.sweep_plain(q, bias, bank, values, ds, torch.full((M,), NEG,
                               dtype=torch.float64), torch.zeros(M, dtype=torch.float64),
                               torch.zeros(M, c, dtype=torch.float64))
    Q, K, V, ab, scale = chip_smoke.sdpa_inputs(q, bias, bank, values, ds)
    assert ab.stride(2) == 0  # broadcast over the query rows, not written out
    out = F.scaled_dot_product_attention(Q, K, V, attn_mask=ab, scale=scale)
    lse = torch.logsumexp(scale * Q @ K.transpose(-1, -2) + ab, dim=-1)
    qn_s = torch.rand(M, dtype=torch.float64)
    got = chip_smoke.sdpa_state(out, lse, qn_s, c)
    want_lse = (m + torch.log2(s1)) * math.log(2.0) - qn_s
    assert _rel(got[0] + torch.log(got[1]), want_lse) <= 1e-9
    assert _rel(got[2] / got[1][:, None], s2 / s1[:, None]) <= 1e-9
