"""Port vs JAX: the flash-score sweep. The port's CPU path (the kernels' plain
PyTorch version behind the same wrapper) against the JAX Pallas kernel in
interpret mode, at 'highest' (K1) and at 'high' (K2, the bf16x3 split dot),
and against the JAX `update_state` reference.

The kernels fold log w into their running max, so only the offset-invariant
quantities are compared: the log total weight m + log s1 (rtol 1e-5,
atol 1e-4) and the posterior mean s2/s1 (rtol 1e-4, atol 1e-5), as the JAX
package's own kernel tests do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.ops.flash_score as jfs
import convolutional_diffusion_tpu.scores.common as jc
import convolutional_diffusion_tpu_torch.ops.flash_score as tfs


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
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    out = tfs.flash_score_update(
        t["q"], t["qn"], t["bank"], t["pn"], t["values"], t["w"], at, bt,
        tuple(torch.from_numpy(s) for s in state), precision=precision, **kw,
    )
    return tuple(o.numpy() for o in out)


def _jax(a, at, bt, state, **kw):
    out = jfs.flash_score_update(
        *(jnp.asarray(a[k]) for k in ("q", "qn", "bank", "pn", "values", "w")),
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
    """'default' (K3) is not ported and raises, naming its variant; 'high'
    (K2) is ported and runs. At the ported tiers per-seed weights (K5) run
    with rows_per_seed and raise the JAX wrapper's ValueError without it;
    a shape mismatch raises."""
    a = _inputs(8, 12, 16, 3, seed=7)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    st = tuple(torch.from_numpy(s) for s in _empty(8, 3))
    args = (t["q"], t["qn"], t["bank"], t["pn"], t["values"], t["w"], 0.8, 0.6, st)
    if variant == "K2":
        for fn in (tfs.flash_score_update, tfs.flash_score_update_plain):
            m, s1, s2 = fn(*args, precision=precision)
            assert torch.isfinite(m).all() and (s1 > 0).all()
            assert torch.isfinite(s2).all()
    else:
        with pytest.raises(NotImplementedError, match=variant):
            tfs.flash_score_update(*args, precision=precision)
        with pytest.raises(NotImplementedError, match=variant):
            tfs.flash_score_update_plain(*args, precision=precision)
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
    before = dict(tfs.flash_score_update.launches)
    assert set(before) == {"flash_score", "flash_score_bf16x3",
                           "flash_score/per_seed", "flash_score_bf16x3/per_seed"}
    a = _inputs(8, 12, 16, 3, seed=8)
    _port(a, 0.8, 0.6, _empty(8, 3))
    _port(a, 0.8, 0.6, _empty(8, 3), "high")
    _port(dict(a, w=np.stack([a["w"], a["w"][::-1]])), 0.8, 0.6, _empty(8, 3),
          "high", rows_per_seed=4)
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
