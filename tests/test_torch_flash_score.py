"""Port vs JAX: the flash-score sweep. The port's CPU path (the kernels' plain
PyTorch version behind the same wrapper) against the JAX Pallas kernel in
interpret mode, at 'highest' (K1) and at 'high' (K2, the bf16x3 split dot),
and against the JAX `update_state` reference.

The kernels fold log w into their running max, so only the offset-invariant
quantities are compared: the log total weight m + log s1 (rtol 1e-5,
atol 1e-4) and the posterior mean s2/s1 (rtol 1e-4, atol 1e-5), as the JAX
package's own kernel tests do."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.ops.flash_score as jfs
import convolutional_diffusion_tpu.scores.common as jc
import convolutional_diffusion_tpu_torch.ops.flash_score as tfs
from convolutional_diffusion_tpu_torch.ops import _build


def _inputs(M, d, P, c, seed, w_lo=0.5):
    rs = np.random.RandomState(seed)
    q = rs.normal(size=(M, d)).astype(np.float32)
    bank = rs.normal(size=(P, d)).astype(np.float32)
    values = rs.normal(size=(P, c)).astype(np.float32)
    w = rs.uniform(w_lo, 1.5, size=(P,)).astype(np.float32)
    return dict(q=q, qn=(q**2).sum(1), bank=bank, pn=(bank**2).sum(1),
                values=values, w=w)


def _empty(M, c):
    return (np.full((M,), -1e30, np.float32), np.zeros((M,), np.float32),
            np.zeros((M, c), np.float32))


def _port(a, at, bt, state, precision="highest", **kw):
    t = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
         for k, v in a.items()}
    out = tfs.flash_score_update(
        t["q"], t["qn"], t["bank"], t["pn"], t["values"], t["w"], at, bt,
        tuple(torch.from_numpy(s) for s in state), precision=precision, **kw,
    )
    return tuple(o.numpy() for o in out)


def _jax(a, at, bt, state, **kw):
    out = jfs.flash_score_update(
        *(None if a[k] is None else jnp.asarray(a[k])
          for k in ("q", "qn", "bank", "pn", "values", "w")),
        jnp.float32(at), jnp.float32(bt), tuple(jnp.asarray(s) for s in state),
        interpret=True, **kw,
    )
    return tuple(np.asarray(o) for o in out)


def _invariants(m, s1, s2):
    m = np.where(m <= -5e29, -np.inf, m)
    with np.errstate(divide="ignore", invalid="ignore"):
        return m + np.log(s1), s2 / s1[:, None]


def _assert_same(ours, want):
    lse_o, mean_o = _invariants(*ours)
    lse_w, mean_w = _invariants(*want)
    np.testing.assert_allclose(lse_o, lse_w, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mean_o, mean_w, rtol=1e-4, atol=1e-5)


SHAPES = [
    (64, 27, 200, 3),    # k=3 c=3: unaligned everything
    (100, 75, 513, 1),   # k=5 c=3 grayscale-ish odd sizes
    (256, 128, 512, 3),  # fully aligned
]


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_jax_kernel_interpret(shapes):
    M, d, P, c = shapes
    a = _inputs(M, d, P, c, seed=0)
    ours = _port(a, 0.8, 0.6, _empty(M, c))
    want = _jax(a, 0.8, 0.6, _empty(M, c), block_q=64, block_p=128)
    _assert_same(ours, want)


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_jax_update_state(shapes):
    M, d, P, c = shapes
    a = _inputs(M, d, P, c, seed=1)
    at, bt = jnp.float32(0.8), jnp.float32(0.6)
    ours = tfs.state_from_kernel(*(torch.from_numpy(o) for o in _port(a, at, bt, _empty(M, c))))
    q, bank = jnp.asarray(a["q"]), jnp.asarray(a["bank"])
    logits = -(jnp.asarray(a["qn"])[:, None] - 2 * at * (q @ bank.T)
               + at**2 * jnp.asarray(a["pn"])[None, :]) / (2 * bt**2)
    ref = jc.update_state(jc.init_state((M,), c), logits,
                          jnp.asarray(a["w"])[None, :], jnp.asarray(a["values"]))
    o = [x.numpy() for x in ours]
    np.testing.assert_allclose(o[0] + np.log(o[1]), np.asarray(ref.m + jnp.log(ref.s1)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(o[2] / o[1][:, None], np.asarray(ref.s2 / ref.s1[:, None]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("split", [1, 128, 255])
def test_chaining_matches_single_sweep(split):
    """Two chained calls over bank parts == one call over the whole bank
    (the streaming-merge contract the chunk loop relies on)."""
    M, d, P, c = 32, 27, 256, 3
    a = _inputs(M, d, P, c, seed=2)
    full = _port(a, 0.7, 0.71, _empty(M, c))
    head = {k: (v[:split] if v.shape[0] == P else v) for k, v in a.items()}
    tail = {k: (v[split:] if v.shape[0] == P else v) for k, v in a.items()}
    chained = _port(tail, 0.7, 0.71, _port(head, 0.7, 0.71, _empty(M, c)))
    for x, y in zip(full, chained):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5)
    # and the JAX kernel fed the port's intermediate state agrees
    _assert_same(chained, _jax(tail, 0.7, 0.71, _port(head, 0.7, 0.71, _empty(M, c)),
                               block_q=32, block_p=64))


def test_zero_weight_entries_ignored():
    M, d, P, c = 16, 12, 64, 2
    a = _inputs(M, d, P, c, seed=3)
    a["w"][32:] = 0.0
    head = {k: (v[:32] if v.shape[0] == P else v) for k, v in a.items()}
    for x, y in zip(_port(a, 0.9, 0.44, _empty(M, c)), _port(head, 0.9, 0.44, _empty(M, c))):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)


def test_all_excluded_chunk_leaves_state_exactly_unchanged():
    M, d, P, c = 24, 27, 100, 3
    a = _inputs(M, d, P, c, seed=4)
    state = _port(a, 0.8, 0.6, _empty(M, c))
    # rows 0..3 keep the empty sentinel
    state = tuple(s.copy() for s in state)
    state[0][:4], state[1][:4], state[2][:4] = -1e30, 0.0, 0.0
    excluded = dict(_inputs(M, d, P, c, seed=5), q=a["q"], qn=a["qn"])
    excluded["w"][:] = 0.0
    after = _port(excluded, 0.8, 0.6, state)
    # s1/s2 exactly (scale 2^0 = 1, nothing added); m up to the wrapper's
    # float32 shift into and out of the sweep's qn-less base-2 convention
    np.testing.assert_array_equal(state[1][4:], after[1][4:])
    np.testing.assert_array_equal(state[2][4:], after[2][4:])
    np.testing.assert_allclose(state[0][4:], after[0][4:], rtol=1e-6)
    assert (after[0][:4] <= -5e29).all() and (after[1][:4] == 0).all()


def test_sentinel_rows_in_input_state_match_jax():
    """A carried state holding empty (sentinel) rows next to live rows."""
    M, d, P, c = 40, 75, 300, 3
    a = _inputs(M, d, P, c, seed=6, w_lo=0.0)
    a["w"][a["w"] < 0.3] = 0.0
    first = {k: (v[:150] if v.shape[0] == P else v) for k, v in a.items()}
    second = {k: (v[150:] if v.shape[0] == P else v) for k, v in a.items()}
    state = tuple(s.copy() for s in _port(first, 0.8, 0.6, _empty(M, c)))
    state[0][::3], state[1][::3], state[2][::3] = -1e30, 0.0, 0.0
    _assert_same(_port(second, 0.8, 0.6, state),
                 _jax(second, 0.8, 0.6, state, block_q=64, block_p=128))


def test_state_conversions_roundtrip():
    m = torch.tensor([float("-inf"), 1.5, -2.0])
    s = (torch.ones(3), torch.zeros(3, 2))
    k = tfs.state_to_kernel(m, *s)
    assert k[0][0] == torch.tensor(tfs.NEG_INF)
    back = tfs.state_from_kernel(*k)
    assert torch.isneginf(back[0][0]) and torch.equal(back[0][1:], m[1:])


@pytest.mark.parametrize("precision,variant", [("high", "K2"), ("default", "K3")])
def test_unported_tiers_raise(precision, variant):
    """'high' (K2) and 'default' (K3) run, in the wrapper and in its plain
    version, and so do the variants that once raised NotImplementedError
    here: the 'mxu' value strategy ('auto' at c > 8, K4), 'inbank' at
    'highest' and 'high' (K4), and fast_exp apart from the tier (K3); none
    raises any more. Per-seed weights (K5) run with rows_per_seed and raise
    the JAX wrapper's ValueError without it; a shape mismatch raises."""
    a = _inputs(8, 12, 16, 3, seed=7)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    st = tuple(torch.from_numpy(s) for s in _empty(8, 3))
    args = (t["q"], t["qn"], t["bank"], t["pn"], t["values"], t["w"], 0.8, 0.6, st)

    def runs(out, c=3):
        m, s1, s2 = out
        assert torch.isfinite(m).all() and (s1 > 0).all()
        assert s2.shape == (8, c) and torch.isfinite(s2).all()

    for fn in (tfs.flash_score_update, tfs.flash_score_update_plain):
        runs(fn(*args, precision=precision))
        wide = torch.from_numpy(np.random.RandomState(9).normal(size=(16, 9)).astype(np.float32))
        runs(fn(*args[:4], wide, *args[5:8], (*st[:2], torch.zeros(8, 9)),
                precision=precision), c=9)
        for tier in ("highest", "high"):
            runs(fn(*args[:4], None, *args[5:], precision=tier,
                    v_strategy="inbank", inbank_cols=(3, 3)))
        runs(fn(*args, precision=precision, fast_exp=precision != "default"))
    precision = "high" if variant == "K2" else "highest"
    w2 = t["w"][None].repeat(2, 1)
    with pytest.raises(ValueError, match="rows_per_seed"):
        tfs.flash_score_update(*args[:5], w2, 0.8, 0.6, st, precision=precision)
    with pytest.raises(ValueError, match="rows_per_seed"):
        tfs.flash_score_update(*args[:5], w2, 0.8, 0.6, st, precision=precision,
                               rows_per_seed=3)
    m, s1, _ = tfs.flash_score_update(*args[:5], w2, 0.8, 0.6, st,
                                      precision=precision, rows_per_seed=4)
    assert torch.isfinite(m).all() and (s1 > 0).all()
    with pytest.raises(ValueError, match="shape"):
        tfs.flash_score_update(t["q"], t["qn"], t["bank"][:5], *args[3:],
                               precision=precision)


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_high_matches_jax_kernel_interpret(shapes):
    """'high': the plain bf16x3 split against the JAX kernel's own split."""
    M, d, P, c = shapes
    a = _inputs(M, d, P, c, seed=10)
    ours = _port(a, 0.8, 0.6, _empty(M, c), precision="high")
    want = _jax(a, 0.8, 0.6, _empty(M, c), block_q=64, block_p=128,
                precision="high")
    _assert_same(ours, want)


@pytest.mark.parametrize("split", [128, 255])
def test_high_chaining_and_sentinel_rows_match_jax(split):
    """'high', chained over two bank parts with sentinel and zero-weight
    rows in the carried state, against the JAX kernel fed the same state."""
    M, d, P, c = 40, 75, 300, 3
    a = _inputs(M, d, P, c, seed=11, w_lo=0.0)
    a["w"][a["w"] < 0.3] = 0.0
    head = {k: (v[:split] if v.shape[0] == P else v) for k, v in a.items()}
    tail = {k: (v[split:] if v.shape[0] == P else v) for k, v in a.items()}
    state = tuple(s.copy() for s in _port(head, 0.8, 0.6, _empty(M, c), "high"))
    state[0][::3], state[1][::3], state[2][::3] = -1e30, 0.0, 0.0
    _assert_same(_port(tail, 0.8, 0.6, state, "high"),
                 _jax(tail, 0.8, 0.6, state, block_q=64, block_p=128,
                      precision="high"))
    full = _port(a, 0.8, 0.6, _empty(M, c), "high")
    chained = _port(tail, 0.8, 0.6, _port(head, 0.8, 0.6, _empty(M, c), "high"), "high")
    _assert_same(chained, full)


def test_high_splits_the_dot():
    """'high' is not bit-equal to 'highest' (the split is really done), and
    agrees with it to the tier's ~2^-16 relative dot error; with inputs that
    are bf16 values already (lo parts zero) the two tiers agree to fp32
    rounding."""
    M, d, P, c = 64, 243, 512, 3
    a = _inputs(M, d, P, c, seed=12)
    hi = _port(a, 0.9, 0.5, _empty(M, c), "high")
    ref = _port(a, 0.9, 0.5, _empty(M, c), "highest")
    assert not all(np.array_equal(x, y) for x, y in zip(hi, ref))
    lse_h, mean_h = _invariants(*hi)
    lse_r, mean_r = _invariants(*ref)
    np.testing.assert_allclose(lse_h, lse_r, rtol=1e-3)
    np.testing.assert_allclose(mean_h, mean_r, atol=1e-2)
    b16 = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy() for k, v in a.items()}
    b16["qn"], b16["pn"] = (b16["q"] ** 2).sum(1), (b16["bank"] ** 2).sum(1)
    _assert_same(_port(b16, 0.9, 0.5, _empty(M, c), "high"),
                 _port(b16, 0.9, 0.5, _empty(M, c), "highest"))


def test_high_all_excluded_chunk_leaves_state_unchanged():
    M, d, P, c = 24, 27, 100, 3
    a = _inputs(M, d, P, c, seed=13)
    state = tuple(s.copy() for s in _port(a, 0.8, 0.6, _empty(M, c), "high"))
    state[0][:4], state[1][:4], state[2][:4] = -1e30, 0.0, 0.0
    excluded = dict(_inputs(M, d, P, c, seed=14), q=a["q"], qn=a["qn"])
    excluded["w"][:] = 0.0
    after = _port(excluded, 0.8, 0.6, state, "high")
    np.testing.assert_array_equal(state[1], after[1])
    np.testing.assert_array_equal(state[2], after[2])
    np.testing.assert_allclose(state[0][4:], after[0][4:], rtol=1e-6)
    assert (after[0][:4] <= -5e29).all()


def test_cpu_path_does_not_count_launches():
    """One count per kernel variant (each kernel by value strategy, the fp32
    kernel also with the bf16 exponential; each also per seed and with a
    prune mask); CPU tensors count none."""
    before = dict(tfs.flash_score_update.launches)
    assert set(before) == {
        name + strategy + variant
        for name, strategies in (
            ("flash_score", ("", "/inbank", "/mxu")),
            ("flash_score/bf16_exp", ("", "/mxu1", "/inbank", "/mxu")),
            ("flash_score_bf16x3", ("", "/inbank", "/mxu")),
            ("flash_score_fast", ("", "/mxu1", "/inbank", "/mxu")))
        for strategy in strategies
        for variant in ("", "/per_seed", "/prune")
    }
    a = _inputs(8, 12, 16, 3, seed=8)
    _port(a, 0.8, 0.6, _empty(8, 3))
    _port(a, 0.8, 0.6, _empty(8, 3), "high")
    _port(a, 0.8, 0.6, _empty(8, 3), "high", prune_mask=torch.zeros(1, 1, dtype=torch.int32))
    _port(dict(a, w=np.stack([a["w"], a["w"][::-1]])), 0.8, 0.6, _empty(8, 3),
          "high", rows_per_seed=4)
    for strategy in ("vpu", "mxu1"):
        _port(a, 0.8, 0.6, _empty(8, 3), "default", v_strategy=strategy)
    _port(dict(a, values=None), 0.8, 0.6, _empty(8, 3), "default",
          v_strategy="inbank", inbank_cols=(3, 3))
    _port(a, 0.8, 0.6, _empty(8, 3), "highest", v_strategy="mxu", fast_exp=True)
    _port(dict(a, values=None), 0.8, 0.6, _empty(8, 3), "high",
          v_strategy="inbank", inbank_cols=(3, 3))
    assert tfs.flash_score_update.launches == before


# Per-seed weights (K5): S seeds of rows_per_seed query rows each, one weight
# row per seed. (S, rows_per_seed, P, d, c): the JAX package's own case
# (tests/test_cutoffs.py, per-seed bias rows through the kernel), a seed
# block of 12 rows (not a multiple of any query block), and aligned sizes.
K5_SHAPES = [(3, 16, 40, 12, 3), (4, 12, 200, 27, 3), (2, 128, 512, 75, 1)]


def _per_seed(S, rps, P, d, c, seed):
    a = _inputs(S * rps, d, P, c, seed=seed)
    w = np.random.RandomState(seed + 100).uniform(0.0, 1.0, size=(S, P)).astype(np.float32)
    w[w < 0.3] = 0.0  # some excluded entries
    w[-1, : P // 2] = 0.0  # and a seed with half its bank excluded
    a["w"] = w
    return a


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("shapes", K5_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_per_seed_matches_jax_kernel_interpret(shapes, precision):
    """K5's plain version against the JAX kernel (its vmap over seeds) in
    interpret mode, with rows_per_seed."""
    S, rps, P, d, c = shapes
    M = S * rps
    a = _per_seed(S, rps, P, d, c, seed=20 + rps)
    ours = _port(a, 0.8, 0.6, _empty(M, c), precision, rows_per_seed=rps)
    want = _jax(a, 0.8, 0.6, _empty(M, c), block_q=64, block_p=128,
                precision=precision, rows_per_seed=rps)
    _assert_same(ours, want)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_per_seed_equals_one_seed_calls(precision):
    """One per-seed sweep equals S one-seed sweeps with 1-D weights on each
    seed's rows, bit for bit (rows are independent), with sentinel rows in
    the carried state and a seed whose whole bank is excluded: that seed's
    rows keep their state."""
    S, rps, P, d, c = 3, 12, 300, 27, 3
    M = S * rps
    a = _per_seed(S, rps, P, d, c, seed=30)
    a["w"][1] = 0.0
    state = tuple(s.copy() for s in _port(dict(a, w=a["w"][0]), 0.8, 0.6, _empty(M, c),
                                          precision))
    state[0][::5], state[1][::5], state[2][::5] = -1e30, 0.0, 0.0
    got = _port(a, 0.7, 0.5, state, precision, rows_per_seed=rps)
    for s in range(S):
        rows = slice(s * rps, (s + 1) * rps)
        one = {k: (v[rows] if k in ("q", "qn") else v) for k, v in a.items()}
        one["w"] = a["w"][s]
        want = _port(one, 0.7, 0.5, tuple(x[rows] for x in state), precision)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[rows], w)
    rows = slice(rps, 2 * rps)
    np.testing.assert_array_equal(got[1][rows], state[1][rows])
    np.testing.assert_array_equal(got[2][rows], state[2][rows])


def test_per_seed_chaining_matches_single_sweep():
    S, rps, P, d, c = 2, 12, 256, 27, 3
    M = S * rps
    a = _per_seed(S, rps, P, d, c, seed=40)
    full = _port(a, 0.7, 0.71, _empty(M, c), rows_per_seed=rps)
    head = {k: (v[..., :100] if k == "w" else v[:100] if v.shape[0] == P else v)
            for k, v in a.items()}
    tail = {k: (v[..., 100:] if k == "w" else v[100:] if v.shape[0] == P else v)
            for k, v in a.items()}
    chained = _port(tail, 0.7, 0.71, _port(head, 0.7, 0.71, _empty(M, c), rows_per_seed=rps),
                    rows_per_seed=rps)
    _assert_same(chained, full)


# 'default' (K3, K4 'inbank'): the plain version against the JAX kernel in
# interpret mode, with block_p = 128 so that both re-base m every 128 bank
# rows (FAST_TILE, the CUDA kernel's tile). The rounding points differ by
# design: the port rounds where the Pallas kernel's dtypes say, XLA's CPU
# backend drops some bf16 roundings ('vpu's bf16 product e * v); see
# `sweep_plain`. So the comparison is relative to scale,
# max|a-b| / max(|a|,|b|,1): 1e-3 on m + log s1 and 3e-3 on s2/s1, within
# the tier's own tolerance (the JAX package holds 'default' at rtol 4e-3,
# tests/test_flash_score.py:407). Worst observed here: ~1e-4 on m + log s1,
# ~1e-3 on s2/s1 ('vpu'; 'mxu1' and 'inbank' ~1e-6).
DEFAULT_LSE_TOL, DEFAULT_MEAN_TOL = 1e-3, 3e-3
STRATEGIES = ["vpu", "inbank", "mxu1"]


def _rel(a, b):
    fin = np.isfinite(b)
    assert (fin == np.isfinite(a)).all()
    a, b = a[fin].astype(np.float64), b[fin].astype(np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


def _assert_tier(ours, want, lse_tol=DEFAULT_LSE_TOL, mean_tol=DEFAULT_MEAN_TOL):
    (lse_o, mean_o), (lse_w, mean_w) = _invariants(*ours), _invariants(*want)
    assert _rel(lse_o, lse_w) <= lse_tol
    assert _rel(mean_o, mean_w) <= mean_tol


def _strategy_inputs(a, strategy, col0=12):
    """The strategy's keywords, and the inputs with V = the bank's columns
    col0 .. col0 + c for 'inbank' (values None: not read)."""
    if strategy != "inbank":
        return a, dict(v_strategy=strategy)
    c = a["values"].shape[1]
    return (dict(a, values=None),
            dict(v_strategy="inbank", inbank_cols=(col0, c)))


@pytest.mark.parametrize("weights", ["1d", "per_seed"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_default_matches_jax_kernel_interpret(strategy, weights):
    """The plain 'default' sweep against the JAX kernel at 'default' (fast
    exp) with the same value strategy, 1-D or per-seed weights."""
    S, rps, P, d, c = 2, 32, 200, 27, 3
    a = (_per_seed(S, rps, P, d, c, seed=50) if weights == "per_seed"
         else _inputs(S * rps, d, P, c, seed=50))
    a, kw = _strategy_inputs(a, strategy)
    if weights == "per_seed":
        kw["rows_per_seed"] = rps
    ours = _port(a, 0.8, 0.6, _empty(S * rps, c), "default", **kw)
    want = _jax(a, 0.8, 0.6, _empty(S * rps, c), block_q=64, block_p=128,
                precision="default", **kw)
    _assert_tier(ours, want)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_default_chaining_and_sentinel_rows_match_jax(strategy):
    """'default' chained over two bank parts, with sentinel and zero-weight
    rows in the carried state, against the JAX kernel fed the same state;
    and two chained calls against one, at the tier's tolerance: the second
    call rounds x = logit - m under the first part's m, one call under the
    whole bank's."""
    M, d, P, c = 40, 75, 300, 3
    a = _inputs(M, d, P, c, seed=51, w_lo=0.0)
    a["w"][a["w"] < 0.3] = 0.0
    a, kw = _strategy_inputs(a, strategy, col0=36)
    head = {k: (v[:128] if v is not None and v.shape[0] == P else v) for k, v in a.items()}
    tail = {k: (v[128:] if v is not None and v.shape[0] == P else v) for k, v in a.items()}
    state = tuple(s.copy() for s in _port(head, 0.8, 0.6, _empty(M, c), "default", **kw))
    state[0][::3], state[1][::3], state[2][::3] = -1e30, 0.0, 0.0
    _assert_tier(_port(tail, 0.8, 0.6, state, "default", **kw),
                 _jax(tail, 0.8, 0.6, state, block_q=64, block_p=128,
                      precision="default", **kw))
    full = _port(a, 0.8, 0.6, _empty(M, c), "default", **kw)
    chained = _port(tail, 0.8, 0.6,
                    _port(head, 0.8, 0.6, _empty(M, c), "default", **kw),
                    "default", **kw)
    _assert_tier(chained, full)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_default_all_excluded_chunk_leaves_state_unchanged(strategy):
    M, d, P, c = 24, 27, 100, 3
    a, kw = _strategy_inputs(_inputs(M, d, P, c, seed=52), strategy)
    state = tuple(s.copy() for s in _port(a, 0.8, 0.6, _empty(M, c), "default", **kw))
    state[0][:4], state[1][:4], state[2][:4] = -1e30, 0.0, 0.0
    excluded = dict(_inputs(M, d, P, c, seed=53), q=a["q"], qn=a["qn"])
    excluded, _ = _strategy_inputs(excluded, strategy)
    excluded["w"][:] = 0.0
    after = _port(excluded, 0.8, 0.6, state, "default", **kw)
    np.testing.assert_array_equal(state[1], after[1])
    np.testing.assert_array_equal(state[2], after[2])
    np.testing.assert_allclose(state[0][4:], after[0][4:], rtol=1e-6)
    assert (after[0][:4] <= -5e29).all()


def test_default_strategies_share_the_exponential():
    """'inbank' over the bank's columns equals 'mxu1' over the same columns
    as values, bit for bit (one arithmetic); 'vpu' rounds the products e * v
    to bf16 and differs from both, within the tier's tolerance."""
    M, d, P, c = 32, 27, 256, 3
    a = _inputs(M, d, P, c, seed=54)
    a["values"] = np.ascontiguousarray(a["bank"][:, 12:15])
    ib = _port(dict(a, values=None), 0.8, 0.6, _empty(M, c), "default",
               v_strategy="inbank", inbank_cols=(12, 3))
    mx = _port(a, 0.8, 0.6, _empty(M, c), "default", v_strategy="mxu1")
    vp = _port(a, 0.8, 0.6, _empty(M, c), "default", v_strategy="vpu")
    for x, y in zip(ib, mx):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(mx[0], vp[0])
    np.testing.assert_array_equal(mx[1], vp[1])
    assert not np.array_equal(mx[2], vp[2])
    _assert_tier(vp, mx)


def test_default_auto_strategy_rule():
    """'auto' with the bf16 exponential takes 'mxu1' from P = 2^18 bank rows
    in one call (c + 1 <= 128) and 'vpu' below; without it 'vpu' (c <= 8)
    or 'mxu' (c > 8). The plan's `fast_exp` picks it, not the tier (both
    at 'high' here)."""
    big = tfs.MXU1_MIN_P

    def rule(fast, v_strategy, c, P, inbank_cols=None):
        plan = tfs.sweep_plan("high", fast, v_strategy, c, 8, 8, P, 27,
                              inbank_cols=inbank_cols)
        return plan.strategy, plan.c

    assert rule(True, "auto", 3, big) == ("mxu1", 3)
    assert rule(True, "auto", 3, big - 1) == ("vpu", 3)
    assert rule(False, "auto", 3, big) == ("vpu", 3)
    assert rule(True, "inbank", -1, 10, (12, 3)) == ("inbank", 3)
    assert rule(False, "auto", 9, 10) == ("mxu", 9)
    assert rule(True, "auto", 9, big) == ("mxu1", 9)
    assert rule(True, "auto", 127, big) == ("mxu1", 127)
    assert rule(True, "auto", 128, big) == ("mxu", 128)
    with pytest.raises(ValueError, match="mxu1"):
        rule(False, "mxu1", 3, 10)
    with pytest.raises(ValueError, match="inbank_cols"):
        rule(True, "inbank", -1, 10)
    with pytest.raises(ValueError, match="out of range"):
        rule(True, "inbank", -1, 10, (26, 3))


def test_default_tile_is_the_kernels_tile():
    """Where m is re-based is part of the 'default' function: the plain
    version re-bases every FAST_TILE bank rows, and the split-dot kernels'
    tile (BP of csrc/flash_score_split.cuh) is the same constant, passed to
    nvcc by _build, with no number of its own in the header."""
    assert tfs.FAST_TILE == _build.SPLIT_TILE
    assert f"-DSPLIT_TILE={tfs.FAST_TILE}" in _build.NVCC_FLAGS
    header = (_build.CSRC / "flash_score_split.cuh").read_text()
    assert "constexpr int BP = SPLIT_TILE;" in header
    assert not re.search(r"\bBP\s*=\s*\d", header)

def test_default_exp_is_the_bf16_exp2_of_jax():
    """The tier's exponential is JAX's lowering of `jnp.exp2` on a bf16
    array, exp(bf16(ln 2) * x) with the product in bf16: the port's
    e = bf16(exp(bf16(bf16(x) * 0.69140625))) equals jnp.exp2(bf16(x)) bit
    for bit over x in [-30, 0], where a true exp2 is off by up to ~11%. In
    a whole 'mxu1' sweep (no rounding that XLA's CPU backend drops) the
    port's form agrees with the JAX kernel to ~1e-6 on the posterior mean,
    a true exp2 only to ~2.6e-3."""
    x = np.linspace(-30.0, 0.0, 4001).astype(np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    xt = tfs._bf16(torch.from_numpy(x))
    ours = tfs._bf16(torch.exp(tfs._bf16(xt * tfs.LN2_BF16).double()).float()).numpy()
    np.testing.assert_array_equal(ours, want)
    true = tfs._bf16(torch.exp2(xt)).numpy()
    assert np.abs(true / want - 1).max() > 0.05

    M, d, P, c = 64, 27, 200, 3
    a = _inputs(M, d, P, c, seed=0)
    jx = _invariants(*_jax(a, 0.8, 0.6, _empty(M, c), block_q=64, block_p=128,
                           precision="default", v_strategy="mxu1"))[1]
    port = _invariants(*_port(a, 0.8, 0.6, _empty(M, c), "default", v_strategy="mxu1"))[1]
    orig = torch.exp
    with pytest.MonkeyPatch.context() as mp:
        # a true exp2: exp(y * ln 2 / bf16(ln 2)) == 2^(bf16(x)) up to rounding
        mp.setattr(tfs.torch, "exp", lambda y: orig(y * (tfs.LN2 / tfs.LN2_BF16)))
        true_exp2 = _invariants(*_port(a, 0.8, 0.6, _empty(M, c), "default",
                                       v_strategy="mxu1"))[1]
    assert _rel(port, jx) < 1e-5
    assert _rel(true_exp2, jx) > DEFAULT_LSE_TOL


# Prune masks (K6): the plain version with a mask against the JAX kernel with
# the same mask, on the JAX package's clustered fixture (`tests/test_prune.py`)
# with clusters of PRUNE_BLOCK bank rows, so that the port's sound mask skips.
def _pruned_inputs(M=256, P=16384, d=27, c=3, seed=0):
    import convolutional_diffusion_tpu_torch.ops.prune as tp

    rng = np.random.RandomState(seed)
    means = rng.normal(0, 2.0, (8, d)).astype(np.float32)
    bank = (means[np.arange(P) * 8 // P]
            + rng.normal(0, 0.2, (P, d))).astype(np.float32)
    q = (means[np.repeat(rng.permutation(8)[: M // 256], 256)]
         + rng.normal(0, 0.1, (M, d))).astype(np.float32)
    w = np.full((P,), 1.0 / P, np.float32)
    w[::5] = 0.0
    a = dict(q=q, qn=(q**2).sum(1), bank=bank, pn=(bank**2).sum(1),
             values=np.ascontiguousarray(bank[:, :c]), w=w)
    stats = tp.block_stats(torch.from_numpy(bank)[None], torch.ones(1, P, dtype=torch.bool))
    mask = tp.prune_masks(torch.from_numpy(q), torch.from_numpy(a["qn"]), 0.9, 0.3, stats,
                          *tp.logw_block_stats(torch.from_numpy(w)[None]))
    return a, mask


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_prune_mask_matches_jax_kernel_interpret(precision):
    """The plain version with a sound mask (7 of 8 stats blocks skipped)
    against the JAX kernel with the same mask at block_q = 64, block_p =
    2048, at the file's parity rule; and within 1e-6 of the unmasked plain
    sweep, since the skipped weights are exactly 0 in fp32."""
    a, mask = _pruned_inputs()
    M, c = a["q"].shape[0], 3
    assert mask.shape == tfs.prune_grid(M, a["bank"].shape[0]) == (4, 8)
    assert mask.float().mean() == 7 / 8
    ours = _port(a, 0.9, 0.3, _empty(M, c), precision, prune_mask=mask)
    _assert_same(ours, _jax(a, 0.9, 0.3, _empty(M, c), block_q=64, block_p=2048,
                            precision=precision, v_strategy="vpu",
                            prune_mask=jnp.asarray(mask.numpy())))
    unmasked = _port(a, 0.9, 0.3, _empty(M, c), precision)
    for x, y in zip(_invariants(*ours), _invariants(*unmasked)):
        assert _rel(x, y) <= 1e-6


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_default_prune_mask_matches_jax_kernel_interpret(strategy):
    """'default' with a forced mask (every other stats block, and all of one
    query block) against the JAX kernel at block_p = 128, the port's tile,
    fed the same mask column for column, at the tier's tolerance; the
    all-skipped query block keeps its carried state bit for bit."""
    a, _ = _pruned_inputs(P=4096 + 700)
    M, c = a["q"].shape[0], 3
    mask = torch.zeros(tfs.prune_grid(M, a["bank"].shape[0]), dtype=torch.int32)
    mask[:, ::2] = 1
    mask[2] = 1
    a, kw = _strategy_inputs(a, strategy)
    state = tuple(s.copy() for s in _port(a, 0.9, 0.3, _empty(M, c), "default", **kw))
    ours = _port(a, 0.9, 0.3, state, "default", prune_mask=mask, **kw)
    jmask = mask.repeat_interleave(tfs.PRUNE_BLOCK // 128, dim=1)[:, : -(-a["bank"].shape[0] // 128)]
    _assert_tier(ours, _jax(a, 0.9, 0.3, state, block_q=64, block_p=128, precision="default",
                            prune_mask=jnp.asarray(jmask.numpy()), **kw))
    rows = slice(128, 192)
    np.testing.assert_array_equal(ours[1][rows], state[1][rows])
    np.testing.assert_array_equal(ours[2][rows], state[2][rows])
    np.testing.assert_allclose(ours[0][rows], state[0][rows], rtol=1e-6)


def test_prune_mask_errors():
    """A mask of another shape than prune_grid(M, P) raises, and so does a
    mask with 2-D (per-seed) weights, with the JAX wrapper's message; both
    before anything runs."""
    a, mask = _pruned_inputs()
    M = a["q"].shape[0]
    for fn in (tfs.flash_score_update, tfs.flash_score_update_plain):
        t = {k: torch.from_numpy(v) for k, v in a.items()}
        args = (t["q"], t["qn"], t["bank"], t["pn"], t["values"])
        st = tuple(torch.from_numpy(s) for s in _empty(M, 3))
        with pytest.raises(ValueError, match="prune_mask shape"):
            fn(*args, t["w"], 0.9, 0.3, st, prune_mask=mask[:, :-1])
        with pytest.raises(ValueError, match="vector-label"):
            fn(*args, t["w"][None].repeat(2, 1), 0.9, 0.3, st, rows_per_seed=M // 2,
               prune_mask=mask)


# --- the wrapper's schedule scalars: the written-out float32 formula -------


def _schedule_coeffs(steps=(1, 7, 13, 19), nsteps=20):
    """(a_t, b_t) of the cosine schedule at a few steps of a 20-step run, as
    the score modules hand them to the sweep: float32 0-d CPU tensors."""
    from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule

    out = []
    for i in steps:
        beta = cosine_noise_schedule(torch.tensor(i, dtype=torch.float32) / nsteps)
        out.append((torch.sqrt(1.0 - beta), torch.sqrt(beta)))
    return out


def _f32_scalars(at, bt):
    """(coef, 1 / (2 b^2), dotscale) in numpy float32, one rounding per
    operation, in the wrapper's order."""
    a, b = np.float32(at), np.float32(bt)
    inv = np.float32(1.0) / (np.float32(2.0) * b * b)
    coef = -(a * a) * inv * np.float32(tfs.LOG2E)
    return coef, inv, float(np.float32(2.0) * a * inv * np.float32(tfs.LOG2E))


def _formula_bias(pn, w, coef):
    logw = torch.where(w > 0.0, torch.log2(torch.clamp(w, min=1e-38)),
                       torch.full_like(w, tfs.NEG_INF))
    return torch.clamp(torch.tensor(coef) * pn + logw, min=tfs.NEG_INF)


def _formula_update(q, qn, bank, pn, values, w, at, bt, state):
    """The wrapper written out: its float32 scalars, the bias, the scaled qn
    offset into and out of m around the plain sweep."""
    coef, inv, dotscale = _f32_scalars(at, bt)
    m0, s10, s20 = state
    qn_s = qn * torch.tensor(inv)
    m_k = torch.where(m0 <= tfs.NEG_INF * 0.5, m0, (m0 + qn_s) * tfs.LOG2E)
    m, s1, s2 = tfs.sweep_plain(q, _formula_bias(pn, w, coef), bank, values, dotscale,
                                m_k, s10, s20, precision="highest", fast_exp=False)
    return torch.where(m <= tfs.NEG_INF * 0.5, m, m * tfs.LN2 - qn_s), s1, s2


def _formula_case(weights, seed=5):
    a = {k: torch.from_numpy(v) for k, v in _inputs(96, 27, 700, 3, seed, w_lo=-0.5).items()}
    a["w"] = torch.clamp(a["w"], min=0.0)  # about a quarter of the patches excluded
    if weights == "per_seed":
        g = torch.Generator().manual_seed(seed)
        a["w"] = torch.clamp(torch.rand(4, 700, generator=g) - 0.3, min=0.0)
    # a carried state with sentinel rows, so the qn offset moves m both ways
    g = torch.Generator().manual_seed(seed + 1)
    m = torch.randn(96, generator=g) * 3 - 40.0
    m[::7] = tfs.NEG_INF
    state = (m, torch.rand(96, generator=g) + 0.5, torch.randn(96, 3, generator=g))
    return a, state, ({"rows_per_seed": 24} if weights == "per_seed" else {})


@pytest.mark.parametrize("weights", ["1d", "per_seed"])
def test_sweep_bias_is_the_written_out_float32_formula(weights):
    """`sweep_bias` at (a_t, b_t) of the schedule, [P] and [S, P] weights,
    bit for bit the formula with each scalar operation rounded to float32."""
    a, _, _ = _formula_case(weights)
    for at, bt in _schedule_coeffs():
        coef, _, _ = _f32_scalars(at, bt)
        assert torch.equal(tfs.sweep_bias(a["pn"], a["w"], at, bt),
                           _formula_bias(a["pn"], a["w"], coef))


@pytest.mark.parametrize("weights", ["1d", "per_seed"])
def test_plain_update_is_the_written_out_float32_formula(weights):
    """`flash_score_update_plain` (and the CPU route of `flash_score_update`)
    from a carried state, bit for bit the written-out wrapper around the
    plain sweep, at (a_t, b_t) of the schedule."""
    a, state, kw = _formula_case(weights)
    args = [a[k] for k in ("q", "qn", "bank", "pn", "values", "w")]
    for at, bt in _schedule_coeffs():
        want = _formula_update(*args, at, bt, state)
        for fn in (tfs.flash_score_update_plain, tfs.flash_score_update):
            got = fn(*args, at, bt, state, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (fn.__name__, at, bt)


def test_plain_route_jacobian_is_unchanged():
    """`torch.func.jacrev` of the posterior mean with respect to q through
    the plain route (qn a function of q): not zero, and bit for bit the
    Jacobian through the written-out wrapper."""
    a, state, _ = _formula_case("1d")
    q, state = a["q"][:16], tuple(s[:16] for s in state)
    at, bt = (float(x) for x in _schedule_coeffs(steps=(13,))[0])  # no tensor under jacrev
    rest = [a[k] for k in ("bank", "pn", "values", "w")]

    def mean(fn):
        def f(q):
            _, s1, s2 = fn(q, (q * q).sum(1), *rest, at, bt, state)
            return s2 / s1[:, None]
        return f

    got = torch.func.jacrev(mean(tfs.flash_score_update_plain))(q)
    want = torch.func.jacrev(mean(_formula_update))(q)
    assert got.shape == (16, 3, 16, 27)
    assert torch.equal(got, want)
    rows = torch.arange(16)
    assert got[rows, :, rows].abs().amax(dim=(1, 2)).gt(0).all()  # each row moves with its q
