"""Port vs JAX: the flash-score variants 'mxu', 'inbank' at 'highest'/'high'
and the exponential apart from the tier, through the port's CPU path (the
kernels' plain PyTorch version behind the same wrapper) against the JAX
Pallas kernel in interpret mode:

- 'mxu', the matrix value sums e @ V (K4; what 'auto' takes at c > 8), at
  every tier, at c in {9, 16, 130} and forced at c = 3;
- 'inbank' at 'highest' and 'high' (K4): 1-D and per-seed weights, two
  chained calls, and m bit-equal to 'vpu''s;
- `fast_exp` apart from the tier (K3): every combination of tier,
  exponential and value strategy JAX takes, 'mxu1' refused without the
  bf16 exponential, and 'high' + bf16 exp equal to 'default' (and 'default'
  + fp32 exp equal to 'high') in the port bit for bit.

Compared on the offset-invariant quantities m + log s1 and s2/s1 at
max|a-b| / max(|a|,|b|,1): 2e-4 with the fp32 exp2 ('highest', 'high'),
and the 'default' tier's 4e-3 (`tests/test_flash_score.py:407`) with the
bf16 exponential, where both sides re-base m every 128 bank rows (the JAX
kernel at block_p = 128, the port's FAST_TILE)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu_torch.ops.flash_score as tfs
from test_torch_flash_score import _empty, _inputs, _invariants, _jax, _per_seed, _port, _rel

TOL = 2e-4  # fp32 exp2
FAST_TOL = 4e-3  # bf16 exponential: the 'default' tier's own


def _assert_close(ours, want, tol):
    (lse_o, mean_o), (lse_w, mean_w) = _invariants(*ours), _invariants(*want)
    assert _rel(lse_o, lse_w) <= tol
    assert _rel(mean_o, mean_w) <= tol


def _tol(precision, fast_exp=None):
    fast = precision == "default" if fast_exp is None else fast_exp
    return FAST_TOL if fast else TOL


def _inbank(a, col0, c):
    """The inputs and keywords of 'inbank' over the bank's columns col0 ..
    col0 + c (values None: not read)."""
    return dict(a, values=None), dict(v_strategy="inbank", inbank_cols=(col0, c))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("c,d,strategy", [
    (9, 27, "auto"), (16, 144, "auto"), (130, 27, "auto"), (3, 27, "mxu"),
], ids=["c9", "c16", "c130", "c3_forced"])
def test_mxu_matches_jax_kernel_interpret(precision, c, d, strategy):
    """'mxu' (what 'auto' takes at c > 8, and forced at c = 3) against the
    JAX kernel's e @ V; at c = 3 also against 'vpu' on the same inputs."""
    M, P = 64, 300
    a = _inputs(M, d, P, c, seed=60 + c)
    ours = _port(a, 0.8, 0.6, _empty(M, c), precision, v_strategy=strategy)
    want = _jax(a, 0.8, 0.6, _empty(M, c), block_q=64, block_p=128,
                precision=precision, v_strategy=strategy)
    _assert_close(ours, want, _tol(precision))
    explicit = _port(a, 0.8, 0.6, _empty(M, c), precision, v_strategy="mxu")
    for x, y in zip(ours, explicit):  # 'auto' took 'mxu'
        np.testing.assert_array_equal(x, y)
    if c == 3:
        _assert_close(ours, _port(a, 0.8, 0.6, _empty(M, c), precision, v_strategy="vpu"),
                      _tol(precision))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_mxu_per_seed_and_chained_match_jax(precision):
    """'mxu' at c = 16 with per-seed weights (K5) against the JAX kernel's
    vmap; and chained over two bank parts with sentinel rows in the carried
    state, against the JAX kernel fed the same state."""
    S, rps, P, d, c = 2, 32, 300, 144, 16
    a = _per_seed(S, rps, P, d, c, seed=70)
    ours = _port(a, 0.8, 0.6, _empty(S * rps, c), precision, rows_per_seed=rps)
    want = _jax(a, 0.8, 0.6, _empty(S * rps, c), block_q=64, block_p=128,
                precision=precision, rows_per_seed=rps)
    _assert_close(ours, want, _tol(precision))
    a = _inputs(40, d, P, c, seed=71, w_lo=0.0)
    a["w"][a["w"] < 0.3] = 0.0
    head = {k: (v[:128] if v.shape[0] == P else v) for k, v in a.items()}
    tail = {k: (v[128:] if v.shape[0] == P else v) for k, v in a.items()}
    state = tuple(s.copy() for s in _port(head, 0.8, 0.6, _empty(40, c), precision))
    state[0][::3], state[1][::3], state[2][::3] = -1e30, 0.0, 0.0
    _assert_close(_port(tail, 0.8, 0.6, state, precision),
                  _jax(tail, 0.8, 0.6, state, block_q=64, block_p=128,
                       precision=precision), _tol(precision))


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("weights", ["1d", "per_seed"])
def test_inbank_matches_jax_kernel_interpret(precision, weights):
    """'inbank' at 'highest' (fp32 e @ K) and 'high' (the split product
    eh.kh + eh.kl + el.kh) against the JAX kernel, 1-D and per-seed; m is
    bit-equal to the port's 'vpu' over the same columns as values (the
    same code path), s1 and s2 within the tier's tolerance of it."""
    S, rps, P, d, c, col0 = 3, 32, 300, 27, 3, 12
    a = (_per_seed(S, rps, P, d, c, seed=72) if weights == "per_seed"
         else _inputs(S * rps, d, P, c, seed=72))
    kw = dict(rows_per_seed=rps) if weights == "per_seed" else {}
    ib, ikw = _inbank(a, col0, c)
    ours = _port(ib, 0.8, 0.6, _empty(S * rps, c), precision, **ikw, **kw)
    want = _jax(ib, 0.8, 0.6, _empty(S * rps, c), block_q=32, block_p=128,
                precision=precision, **ikw, **kw)
    _assert_close(ours, want, TOL)
    vals = dict(a, values=np.ascontiguousarray(a["bank"][:, col0 : col0 + c]))
    vpu = _port(vals, 0.8, 0.6, _empty(S * rps, c), precision, v_strategy="vpu", **kw)
    np.testing.assert_array_equal(ours[0], vpu[0])
    _assert_close(ours, vpu, TOL)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_inbank_chained_calls_match_jax(precision):
    """Two chained 'inbank' calls (the machines' chunk loop) against one
    call, and the second against the JAX kernel fed the first's state,
    with sentinel rows in it."""
    M, P, d, c, col0 = 32, 256, 75, 3, 36
    a, kw = _inbank(_inputs(M, d, P, c, seed=73), col0, c)
    head = {k: (v[:128] if v is not None and v.shape[0] == P else v) for k, v in a.items()}
    tail = {k: (v[128:] if v is not None and v.shape[0] == P else v) for k, v in a.items()}
    whole = _port(a, 0.7, 0.5, _empty(M, c), precision, **kw)
    half = _port(head, 0.7, 0.5, _empty(M, c), precision, **kw)
    _assert_close(_port(tail, 0.7, 0.5, half, precision, **kw), whole, TOL)
    state = tuple(s.copy() for s in half)
    state[0][::5], state[1][::5], state[2][::5] = -1e30, 0.0, 0.0
    _assert_close(_port(tail, 0.7, 0.5, state, precision, **kw),
                  _jax(tail, 0.7, 0.5, state, block_q=32, block_p=128,
                       precision=precision, **kw), TOL)


# every (tier, exponential, strategy) the JAX wrapper takes
FAST_CASES = [
    (precision, fast, strategy)
    for precision in ("highest", "high", "default")
    for fast in (False, True)
    for strategy in ("vpu", "mxu", "inbank", "mxu1")
    if fast or strategy != "mxu1"
]


@pytest.mark.parametrize("precision,fast,strategy", FAST_CASES,
                         ids=lambda v: str(v).lower())
def test_fast_exp_apart_from_the_tier_matches_jax(precision, fast, strategy):
    """fast_exp set against the tier's default: the bf16 exponential after
    fp32 dots ('highest'), the fp32 exp2 after the 'default' tier's split
    dots, and the tier's own, in each value strategy, against the JAX
    kernel with the same keywords."""
    M, P, d, c = 64, 300, 27, 3
    a = _inputs(M, d, P, c, seed=74)
    if strategy == "inbank":
        a, kw = _inbank(a, 12, c)
    else:
        kw = dict(v_strategy=strategy)
    ours = _port(a, 0.8, 0.6, _empty(M, c), precision, fast_exp=fast, **kw)
    want = _jax(a, 0.8, 0.6, _empty(M, c), block_q=64, block_p=128,
                precision=precision, fast_exp=fast, **kw)
    _assert_close(ours, want, _tol(precision, fast))


@pytest.mark.parametrize("strategy", ["vpu", "mxu", "inbank", "mxu1"])
def test_fast_exp_routes_to_the_tier_that_computes_it(strategy):
    """'high' with the bf16 exponential is the 'default' tier's function
    and 'default' with the fp32 exp2 the 'high' tier's: the port computes
    them bit for bit as those tiers ('mxu1' exists only with the bf16
    exponential)."""
    M, P, d, c = 32, 200, 27, 3
    a = _inputs(M, d, P, c, seed=75)
    if strategy == "inbank":
        a, kw = _inbank(a, 12, c)
    else:
        kw = dict(v_strategy=strategy)
    pairs = [(("high", True), ("default", None))]
    if strategy != "mxu1":
        pairs.append((("default", False), ("high", None)))
    for (p1, f1), (p2, f2) in pairs:
        x = _port(a, 0.8, 0.6, _empty(M, c), p1, fast_exp=f1, **kw)
        y = _port(a, 0.8, 0.6, _empty(M, c), p2, fast_exp=f2, **kw)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_mxu1_refused_without_the_bf16_exp(precision):
    """'mxu1' without the bf16 exponential raises, in the port (wrapper and
    plain version) as in the JAX wrapper."""
    a = _inputs(8, 12, 16, 3, seed=76)
    with pytest.raises(ValueError, match="mxu1"):
        _jax(a, 0.8, 0.6, _empty(8, 3), precision=precision, fast_exp=False,
             v_strategy="mxu1")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    st = tuple(torch.from_numpy(s) for s in _empty(8, 3))
    for fn in (tfs.flash_score_update, tfs.flash_score_update_plain):
        with pytest.raises(ValueError, match="mxu1"):
            fn(t["q"], t["qn"], t["bank"], t["pn"], t["values"], t["w"], 0.8, 0.6, st,
               precision=precision, fast_exp=False, v_strategy="mxu1")


@pytest.mark.parametrize("precision,fast", [("highest", True), ("high", True),
                                            ("default", False), ("highest", False)])
def test_auto_picks_mxu1_by_the_exponential(monkeypatch, precision, fast):
    """'auto' over P >= MXU1_MIN_P bank rows takes 'mxu1' exactly when the
    exponential is bf16, whatever the tier (the JAX rule reads fast_exp):
    the threshold is lowered for the test, and the result equals the
    explicit strategy's bit for bit."""
    monkeypatch.setattr(tfs, "MXU1_MIN_P", 256)
    M, P, d, c = 16, 300, 27, 3
    a = _inputs(M, d, P, c, seed=77)
    auto = _port(a, 0.8, 0.6, _empty(M, c), precision, fast_exp=fast)
    explicit = _port(a, 0.8, 0.6, _empty(M, c), precision, fast_exp=fast,
                     v_strategy="mxu1" if fast else "vpu")
    for x, y in zip(auto, explicit):
        np.testing.assert_array_equal(x, y)
    if fast:
        assert not np.array_equal(
            auto[2], _port(a, 0.8, 0.6, _empty(M, c), precision, fast_exp=fast,
                           v_strategy="vpu")[2])


def test_highest_bf16_exp_rebases_per_tile():
    """After fp32 dots the bf16 exponential rounds x = logit - m against
    the m of each 128-row tile (K1's tile): the plain version is the
    'default' arithmetic over fp32 logits, and so differs from 'default'
    (split dots) only through the dots, within the tier's tolerance, while
    the fp32 exp2 of 'highest' differs from it by more than the bf16
    rounding alone would leave invisible."""
    M, P, d, c = 64, 512, 27, 3
    a = _inputs(M, d, P, c, seed=78)
    fast = _port(a, 0.9, 0.5, _empty(M, c), "highest", fast_exp=True)
    _assert_close(fast, _port(a, 0.9, 0.5, _empty(M, c), "default"), FAST_TOL)
    exact = _port(a, 0.9, 0.5, _empty(M, c), "highest")
    assert not np.array_equal(fast[2], exact[2])
    _assert_close(fast, exact, FAST_TOL)
    jx = _jax(a, 0.9, 0.5, _empty(M, c), block_q=64, block_p=128, precision="highest",
              fast_exp=True, v_strategy="mxu")
    _assert_close(_port(a, 0.9, 0.5, _empty(M, c), "highest", fast_exp=True,
                        v_strategy="mxu"), jx, FAST_TOL)
    assert jnp.isfinite(jx[2]).all()


def test_fp32_logits_in_order():
    """K1's summation order for the plain version at large d (the card's
    yardstick): with small-integer inputs every partial sum is exact, so it
    equals the BLAS order bit for bit; with random inputs the two differ
    only in fp32 rounding."""
    rs = np.random.RandomState(79)
    q = torch.from_numpy(rs.randint(-4, 5, size=(16, 40)).astype(np.float32))
    k = torch.from_numpy(rs.randint(-4, 5, size=(24, 40)).astype(np.float32))
    bias = torch.from_numpy(rs.randint(-8, 9, size=(24,)).astype(np.float32))
    assert torch.equal(tfs.fp32_logits_in_order(q, k, 0.5, bias),
                       tfs._fp32_logits(q, k, 0.5, bias))
    q, k = torch.randn(16, 300), torch.randn(24, 300)
    a = tfs.fp32_logits_in_order(q, k, 0.7, bias)
    b = tfs._fp32_logits(q, k, 0.7, bias)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
