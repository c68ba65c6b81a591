"""Fused flash-score sweep — the ELS inner loop.

Counterpart of `convolutional_diffusion_tpu/ops/flash_score.py`. For a block
of queries Q (x's k x k windows) against a bank chunk K of training patches
with values V (patch centers) and per-patch weights w, it advances the
running online-softmax statistics

    logit(q, p) = -(||q||^2 - 2 a_t <q, p> + a_t^2 ||p||^2) / (2 beta_t)
    m  = max_p logit,   s1 = sum_p w_p e^{logit - m},
    s2 = sum_p w_p e^{logit - m} V_p

without materialising the [M, P] logits in device memory.

`flash_score_update` keeps the JAX wrapper's signature and conventions: the
finite -1e30 sentinel for empty rows (`state_to_kernel` /
`state_from_kernel`, the counterparts of `state_to_pallas` /
`state_from_pallas`), the per-patch bias row that folds
-a_t^2 ||p||^2 / (2 beta^2) and log2 w together in base-2 log space, and the
shift of m by the per-query ||q||^2 / (2 beta^2) on entry and exit.

The tensor's device picks the sweep: on CUDA a hand-written kernel, on the
CPU `sweep_plain`, the same function in plain PyTorch. The dots and the
exponential pick the kernel (`_route`): fp32 dots run the fp32 kernel
(`csrc/flash_score.cu`, variant K1, with either exponential); the bf16x3
split dots with an fp32 exp2 the tensor-core kernel
(`csrc/flash_score_bf16x3.cu`, variant K2); the split dots with the bf16
exponential the bf16-exp kernel (`csrc/flash_score_fast.cu`, variants K3
and K4). The tier gives the dots ('highest' fp32, 'high' and 'default' the
split) and `fast_exp` the exponential (default: precision == 'default').
So 'high' with `fast_exp=True` computes the 'default' tier's function and
'default' with `fast_exp=False` the 'high' tier's, as in the JAX kernel
body, and each runs on that tier's kernel. Nothing falls back from one
device, or one kernel, to another.

Value strategies, as in the JAX wrapper: 'vpu' sums the value channels per
row; 'mxu' takes s2 as the matrix product e @ V, for any c; with the bf16
exponential, 'mxu1' takes s2 and s1 as one bf16 product e @ [V | 1]; and
'inbank' takes the product against the bank's own center columns
`inbank_cols = (start, c)`, with no values operand, at every tier. 'auto'
picks 'mxu1' for a bf16-exp sweep over P >= 2^18 bank rows in one call
(c + 1 <= 128), else 'vpu' for c <= 8 and 'mxu' above.

The value sums follow the JAX kernel's dtypes. With the fp32 exp2 every
product e * v is fp32: e @ V is true fp32 at 'high' too, where JAX clamps
HIGH to HIGHEST; 'inbank' after split dots takes the split product
eh.kh + eh.kl + el.kh; s1 is the fp32 row sum. With the bf16 exponential
(e a bf16 value), 'vpu' rounds each product e * bf16(v) to bf16, 'mxu' and
'mxu1' take the exact products e * bf16(v), and 'inbank' e * bf16(k) after
split dots but e * k in fp32 after fp32 dots (HIGHEST promotes the bf16 e).
Where m is re-based is part of that function: every FAST_TILE bank rows.

Per-seed weights (variant K5): `w` may be [S, P], one weight row per seed,
with `rows_per_seed` query rows per seed (M = S * rows_per_seed, seed-major),
as in batched conditional generation with one label per seed. The kernels
take it on a 2-D grid of (query block, seed), so a block never mixes seeds.

Prune masks (variant K6, `ops.prune`): `prune_mask` is an integer skip
mask [ceil(M / PRUNE_ROWS), ceil(P / PRUNE_BLOCK)], one flag per 64 query
rows and 2048 bank rows (`prune_grid`); a set flag skips that cell. With 1-D
weights only, at every tier and value strategy, as the JAX wrapper takes
it. The kernels walk only the live bank tiles; the plain version sets the
skipped cells' logits to -1e30, which leaves the state as skipping does.

Split-bank grid: every kernel runs one main loop per dot type (K1's fp32
FFMA loop, the split dots' pipelined tensor-core loop), one thread block
per (query block, seed, split). The sweeps with the fp32 exp2 (K1 in every
value strategy, K2 in 'vpu' with c <= MAX_CHANNELS; with K5 and K6) cut the
chunk's bank axis into `split_plan`'s ranges; each block writes a partial
state to a scratch the wrapper allocates (`scratch_numel`), and a second
pass folds the partials into the carried state in split order
(`merge_splits_plain` is its plain version). The bf16 exponential rounds
x = logit - m against each tile's m, so those sweeps, and K2's wide value
sums, run one split from the carried state. The split-dot kernels also
write the bf16 hi/lo planes of their inputs once per launch into that
scratch (`split_planes_plain`). The plan depends on P alone, so a K5
launch and the one-seed launches it stands for split alike.

Launch counts: each launch adds one to `flash_score_update.launches` under
`launch_key`: the kernel's name, then '/bf16_exp' for the fp32 kernel with
the bf16 exponential, then '/mxu1', '/inbank' or '/mxu' for those
strategies, then '/per_seed' for 2-D weights or '/prune' with a mask, so a
run shows which variant every chunk took.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .fp32 import true_fp32

NEG_INF = float(-1e30)  # finite -inf stand-in: keeps exp2()/rescale exact at fp32
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
LN2_BF16 = 0.69140625  # ln 2 rounded to bf16: the 'default' tier's exp2 factor
MAX_CHANNELS = 8  # value channels the kernels' 'vpu' sums hold per row
# value channels the kernels' matrix value sums take ('mxu', and 'vpu' or
# 'inbank' past MAX_CHANNELS): the range the card tests hold; their state
# rows live in device memory, so no shared memory grows with c
WIDE_MAX_CHANNELS = 256
PLAIN_BLOCK = 8192  # bank rows per step of the plain version
FAST_TILE = _build.SPLIT_TILE  # bank rows per online-softmax step of the bf16-exp kernels
MXU1_MIN_P = 1 << 18  # 'auto' takes 'mxu1' for bf16-exp sweeps this long
# precision tier -> the kernel that runs its dots on the card (ops._build.KERNELS)
KERNEL_OF = {"highest": "flash_score", "high": "flash_score_bf16x3",
             "default": "flash_score_fast"}
# value strategy -> its code in the kernels' C interface and the suffix of
# its launch count
STRATEGY_CODE = {"vpu": 0, "mxu1": 1, "inbank": 2, "mxu": 3}
STRATEGY_SUFFIX = {"vpu": "", "mxu1": "/mxu1", "inbank": "/inbank", "mxu": "/mxu"}
# suffix of the fp32 kernel's launch count with the bf16 exponential, with
# per-seed weights (variant K5), and with a prune mask (variant K6)
BF16_EXP = "/bf16_exp"
PER_SEED = "/per_seed"
PRUNE = "/prune"
PRUNE_ROWS = _build.PRUNE_ROWS  # query rows per prune-mask cell
PRUNE_BLOCK = _build.PRUNE_BLOCK  # bank rows per prune-mask cell
# the split-bank grid (`split_plan`): bank rows per split, a multiple of
# PRUNE_BLOCK and so of every kernel tile; at M = 8192 a 65536-row chunk
# gives K1 64 x 16 and K2 128 x 16 blocks, several waves on 132 SMs
SPLIT_ROWS = 4096
MAX_SPLITS = 32  # longer chunks take longer splits, whole multiples of SPLIT_ROWS
PLANE_K = 32  # the split-dot loop's staged features: its bf16 planes' rows are d rounded up to this

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check_precision(precision: str) -> None:
    if precision not in KERNEL_OF:
        raise ValueError(
            f"precision must be 'highest', 'high' or 'default', got {precision!r}"
        )


def _route(precision: str, fast: bool) -> str:
    """The tier whose kernel computes (precision's dots, fast exponential):
    the split dots take 'default' with the bf16 exponential and 'high'
    without (the JAX kernel body computes the same function for both
    enums; its one difference, 'mxu' at DEFAULT with an fp32 exp, runs in
    fp32 in interpret mode, the reference this port follows)."""
    if precision == "highest":
        return precision
    return "default" if fast else "high"


def launch_key(precision: str, strategy: str = "vpu", fast_exp: bool | None = None,
               per_seed: bool = False, prune: bool = False) -> str:
    """The launch-count key of a sweep at `precision` (after `_route`) in
    value strategy `strategy`."""
    fast = precision == "default" if fast_exp is None else fast_exp
    return (KERNEL_OF[precision] + (BF16_EXP if precision == "highest" and fast else "")
            + STRATEGY_SUFFIX[strategy]
            + (PER_SEED if per_seed else PRUNE if prune else ""))


def _strategy(fast, v_strategy, values, inbank_cols, d, P):
    """The value strategy that runs and the value channels c, by the JAX
    wrapper's rules (`flash_score.py:380-386, 556-576`); `fast` is the
    bf16 exponential."""
    if v_strategy == "inbank":
        if inbank_cols is None:
            raise ValueError("v_strategy='inbank' requires inbank_cols=(start, c)")
        col0, c = inbank_cols
        if not (0 <= col0 and col0 + c <= d):
            raise ValueError(f"inbank_cols {inbank_cols} out of range for d={d}")
        return "inbank", c
    c = values.shape[1] if values is not None and values.ndim == 2 else -1
    if v_strategy == "auto":
        if fast and c + 1 <= 128 and P >= MXU1_MIN_P:
            v_strategy = "mxu1"
        else:
            v_strategy = "vpu" if c <= MAX_CHANNELS else "mxu"
    if v_strategy == "mxu1":
        if not fast:
            raise ValueError(
                "v_strategy='mxu1' is a fast-mode path (bf16 e @ [V|1]); "
                "parity mode keeps the fp32 VPU accumulation"
            )
        if c % 128 == 0:
            raise ValueError(f"no spare lane for s1 (c={c}, cp={c})")
    elif v_strategy not in ("vpu", "mxu"):
        raise ValueError(
            "v_strategy must be 'auto', 'vpu', 'mxu1', 'inbank' or 'mxu', "
            f"got {v_strategy!r}"
        )
    return v_strategy, c


def prune_grid(M: int, P: int) -> Tuple[int, int]:
    """The shape of a prune mask over M query rows and P bank rows."""
    return -(-M // PRUNE_ROWS), -(-P // PRUNE_BLOCK)


def splits_bank(precision: str, strategy: str, c: int, fast_exp: bool | None = None) -> bool:
    """Whether a sweep (at `precision` after `_route`) splits the bank axis:
    the fp32 exp2 after fp32 dots (K1, every value strategy) or, after split
    dots (K2), the per-row sums ('vpu', c <= MAX_CHANNELS). The bf16
    exponential rounds x = logit - m against the m of each bank tile, so
    splitting P would change its numbers; K2's wide value sums run one split
    from the carried state, as the 'default' kernel does."""
    fast = precision == "default" if fast_exp is None else bool(fast_exp)
    return not fast and (precision == "highest" or (strategy == "vpu" and c <= MAX_CHANNELS))


def split_plan(P: int, precision: str = "highest", strategy: str = "vpu", c: int = 3,
               fast_exp: bool | None = None):
    """The bank-row ranges [(p0, p1), ...] the kernel's blocks split a chunk
    of P rows into, in merge order: one range unless `splits_bank`, else
    ranges of SPLIT_ROWS rows (whole SPLIT_ROWS multiples past MAX_SPLITS
    of them), so every boundary falls on a 128-row tile and a 2048-row
    prune cell. It depends on P and the variant alone, not on the query
    rows, the seeds or a mask."""
    if not splits_bank(precision, strategy, c, fast_exp) or P <= SPLIT_ROWS:
        return [(0, P)]
    tiles = -(-P // SPLIT_ROWS)  # splits of SPLIT_ROWS rows
    per = SPLIT_ROWS * -(-tiles // MAX_SPLITS)
    return [(p0, min(P, p0 + per)) for p0 in range(0, P, per)]


def block_rows(name: str, fast_exp: bool) -> int:
    """Query rows per thread block of kernel `name` (`_build.SPLIT_BQ`): K1
    takes 64 with the bf16 exponential (one split: M = 8192 still fills the
    card), 128 otherwise; the split-dot loop 64."""
    return _build.SPLIT_BQ[name + (BF16_EXP if name == KERNEL_OF["highest"] and fast_exp
                                   else "")]


def split_launch(name: str, M: int, rows_per_seed: int, P: int, precision: str,
                 strategy: str = "vpu", c: int = 3, fast_exp: bool | None = None):
    """(split_rows, nsplit, grid) of one launch of kernel `name`: the rows
    per split its C entry takes (`split_plan`'s first range), the number of
    splits, and the thread blocks (query blocks of `block_rows` rows per
    seed, seeds, splits)."""
    fast = precision == "default" if fast_exp is None else bool(fast_exp)
    plan = split_plan(P, precision, strategy, c, fast)
    bq = block_rows(name, fast)
    return (plan[0][1] - plan[0][0], len(plan),
            (-(-rows_per_seed // bq), M // rows_per_seed, len(plan)))


def scratch_numel(name: str, nsplit: int, M: int, P: int, d: int, c: int,
                  fast_exp: bool = False) -> int:
    """float32 elements of the scratch of kernel `name`: the partial states
    [nsplit, M, 2 + c] rounded up to 4 (the split-dot kernels' wide
    tensor-core sums keep a second copy of the state rows there), and for
    the split-dot kernels the bf16 hi and lo planes of the queries and the
    chunk, [M + P, d_pad] each (two bf16 a float32 element). K1 with the
    bf16 exponential writes its state in place and takes none."""
    if name == KERNEL_OF["highest"]:
        return 0 if fast_exp else -(-nsplit * M * (2 + c) // 4) * 4
    return -(-nsplit * M * (2 + c) // 4) * 4 + (M + P) * (-(-d // PLANE_K) * PLANE_K)


def merge_splits_plain(state: State, partials) -> State:
    """Plain version of the merge pass: fold partial states (m, s1, s2) of
    the splits, each swept from the empty state, into the carried `state`
    in split order; a term whose m is at the sentinel adds nothing, and a
    row with no live partial keeps its carried state as it is."""
    m0, s10, s20 = state
    ms = torch.stack([p[0] for p in partials])
    m = torch.maximum(m0, ms.amax(dim=0))
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    live = ms > NEG_INF * 0.5
    f0 = torch.where(m0 <= NEG_INF * 0.5, zero, torch.exp2(m0 - m))
    s1, s2 = s10 * f0, s20 * f0[:, None]
    for (mj, s1j, s2j), lj in zip(partials, live):
        f = torch.where(lj, torch.exp2(mj - m), zero)
        s1 = s1 + s1j * f
        s2 = s2 + s2j * f[:, None]
    any_live = live.any(dim=0)
    return (torch.where(any_live, m, m0), torch.where(any_live, s1, s10),
            torch.where(any_live[:, None], s2, s20))


def split_planes_plain(x: torch.Tensor, d_pad: int):
    """Plain version of K2's pre-split pass: the bf16 hi and lo parts of
    x [R, d] (`_split_bf16`), zero-padded to [R, d_pad], as bf16."""
    hi, lo = (F.pad(t, (0, d_pad - x.shape[1])).to(torch.bfloat16) for t in _split_bf16(x))
    return hi, lo


def _mask_cells(mask: torch.Tensor, M: int, p0: int, p1: int) -> torch.Tensor:
    """[M, p1 - p0] bool: the skipped cells of bank rows p0 .. p1 - 1."""
    cols = torch.arange(p0, p1, device=mask.device) // PRUNE_BLOCK
    return mask[:, cols].bool().repeat_interleave(PRUNE_ROWS, dim=0)[:M]


def _scalar(x) -> torch.Tensor:
    """A float32 0-d CPU tensor (schedule scalars stay on the host)."""
    return torch.as_tensor(x, dtype=torch.float32).reshape(()).cpu()


MMA_K = 16  # features per tensor-core product step of the bf16x3 kernel


def _split_bf16(x: torch.Tensor):
    """x = hi + lo + O(2^-16 |x|): both parts bf16 values (round to nearest
    even, as the TPU kernel's casts), returned in float32."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), returned in float32."""
    return x.to(torch.bfloat16).float()


def _rz32(x64: torch.Tensor) -> torch.Tensor:
    """float64 x rounded toward zero to float32 precision, in place and
    still float64: the low 29 of the 52 mantissa bits cleared (exact for x
    in float32's normal range, and for 0)."""
    x64.view(torch.int64).bitwise_and_(~((1 << 29) - 1))
    return x64


def _split_dot(qh64, ql64, kh, kl) -> torch.Tensor:
    """The bf16x3 split dot qh.kh + qh.kl + ql.kh as the tensor-core kernels
    compute it, step for step over the MMA_K-feature slices: each qh.kh
    slice product from a zero accumulator, added into the running sum by an
    fp32 TwoSum whose error is added (fp32) into the cross-term
    accumulator; then the qh.kl and ql.kh slice products accumulated into
    it; the dot is the fp32 sum of the two accumulators. A tensor-core
    product step is taken as the exact sum of its products and its
    accumulator rounded toward zero to float32: on an H100 91-99% of the
    inexact steps round so (`ops.k2_numerics`), the rest differ in the
    last bit. Products of bf16 values and their slice sums are exact in
    float64. The logit scale 1/(2 beta^2) turns a last-bit difference of
    the dot into a visible one of the posterior, most of all where the
    'default' tier rounds x = logit - m to bf16, so this version repeats
    the kernel's sum rather than a more exact one.

    Both accumulators are held as float64 arrays of float32 values: the
    sum of two of them is exact in float64 (their exponents lie within 29
    bits of each other), so the TwoSum is that exact sum and its rounding
    to float32, and rounding toward zero clears the low mantissa bits."""
    khT, klT = kh.double().T.contiguous(), kl.double().T.contiguous()
    acc_hh = torch.zeros(qh64.shape[0], kh.shape[0], dtype=torch.float64,
                         device=kh.device)
    acc_x = torch.zeros_like(acc_hh)
    for f0 in range(0, kh.shape[1], MMA_K):
        f = slice(f0, f0 + MMA_K)
        t = acc_hh.add_(_rz32(qh64[:, f] @ khT[f]))  # acc_hh + hh, exact
        acc_hh = t.float().double()
        acc_x.add_(t.sub_(acc_hh))  # + the TwoSum error, exact
        acc_x = acc_x.float().double()  # the kernel's float32 add
        acc_x = _rz32(torch.addmm(acc_x, qh64[:, f], klT[f]))
        acc_x = _rz32(torch.addmm(acc_x, ql64[:, f], khT[f]))
    return acc_hh.add_(acc_x).float()


def _fp32_logits(q, k, dotscale: float, bias) -> torch.Tensor:
    """The logits after fp32 dots: (q @ k^T) * dotscale + bias, the dot
    summed in the BLAS library's order."""
    return _add_bias((q @ k.T) * dotscale, bias)


def fp32_logits_in_order(q, k, dotscale: float, bias) -> torch.Tensor:
    """The logits as the fp32 kernel (K1) forms them: each dot a chain of
    fp32 fused multiply-adds over the features in order, then one fused
    multiply-add with dotscale and the bias. Each step is taken in float64
    (the product of two float32 values is exact there) and rounded to
    float32, which differs from the fused operation only where the float64
    sum itself rounds a float32 tie. The logit scale 1/(2 beta^2) makes the
    posterior sensitive to the dot's last bits: at d = 4624 and t = 0.05,
    BLAS's order and K1's differ by ~3e-3 on the posterior mean. d steps
    over [M, n]: the plain version's dots with the bf16 exponential, and a
    yardstick for the kernel at large d."""
    acc = torch.zeros(q.shape[0], k.shape[0], dtype=torch.float32, device=q.device)
    q64, kT64 = q.double(), k.double().T
    for f in range(q.shape[1]):
        acc = torch.addmm(acc.double(), q64[:, f : f + 1], kT64[f : f + 1]).float()
    return _add_bias(acc.double() * dotscale, bias.double()).float()


def _add_bias(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [M, n] + bias: a [n] row for every row of x, or [S, n] with row s
    for the s-th of S equal blocks of rows (one rounding either way)."""
    if bias.ndim == 1:
        return x + bias
    S, n = bias.shape
    return (x.view(S, -1, n) + bias[:, None, :]).view(x.shape)


# how a bf16 exponential meets the values (`_fast_tiles`, the kernels' rule)
BF16_PRODUCT = "bf16(e * bf16(v))"  # 'vpu'
BF16_VALUES = "e * bf16(v)"  # 'mxu', 'mxu1', 'inbank' after split dots
FP32_VALUES = "e * v"  # 'inbank' after fp32 dots


def _fast_rule(strategy: str, split: bool) -> str:
    if strategy == "vpu":
        return BF16_PRODUCT
    return FP32_VALUES if strategy == "inbank" and not split else BF16_VALUES


def _fast_tiles(logits, v, m, s1, s2, rule: str) -> State:
    """One block of a bf16-exp sweep (logits [M, n], values v [n, c]),
    re-basing m every FAST_TILE bank rows as the kernels do: the bf16
    rounding of x = logits - m depends on the m it is taken against. The
    value products follow `rule`. The tiles are folded in closed form,
    s * 2^(m_before - m_after) + t per tile, which differs from the
    kernels' sequential fold only in fp32 rounding."""
    M, n = logits.shape
    nt = -(-n // FAST_TILE)
    pad = nt * FAST_TILE - n
    lg = F.pad(logits, (0, pad), value=NEG_INF).view(M, nt, FAST_TILE)
    v = F.pad(v if rule == FP32_VALUES else _bf16(v), (0, 0, 0, pad)).view(
        nt, FAST_TILE, -1)
    # m before the first tile and after each one
    m_run = torch.cummax(torch.cat([m[:, None], lg.amax(dim=2)], dim=1), dim=1).values
    empty = m_run <= NEG_INF * 0.5
    m_safe = torch.where(empty, 0.0, m_run)
    x = _bf16(lg - m_safe[:, 1:, None])
    e = _bf16(torch.exp(_bf16(x * LN2_BF16).double()).float())
    if rule == BF16_PRODUCT:
        t2 = torch.stack([_bf16(e * v[None, :, :, ch]).sum(dim=2)
                          for ch in range(v.shape[2])], dim=2)
    else:
        t2 = torch.einsum("mtk,tkc->mtc", e, v)
    f = torch.where(empty, 0.0, torch.exp2(m_safe - m_safe[:, -1:]))
    s1 = s1 * f[:, 0] + (e.sum(dim=2) * f[:, 1:]).sum(dim=1)
    s2 = s2 * f[:, :1] + (t2 * f[:, 1:, None]).sum(dim=1)
    return m_run[:, -1], s1, s2


def _split_product(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """eh.vh + eh.vl + el.vh of the bf16x3 splits of e [M, n] and v [n, c],
    summed exactly (float64) and rounded once to float32: 'inbank' after
    split dots with the fp32 exp2 (JAX `_kernel_body`'s manual split)."""
    eh, el = (t.double() for t in _split_bf16(e))
    vh, vl = (t.double() for t in _split_bf16(v))
    return (eh @ vh + eh @ vl + el @ vh).float()


def sweep_plain(q, bias, bank, values, dotscale: float, m, s1, s2,
                precision: str = "highest", strategy: str = "vpu",
                col0: int = -1, prune_mask=None, fast_exp: bool | None = None) -> State:
    """Plain PyTorch version of the kernels: the same base-2 online softmax
    over the same bias row, PLAIN_BLOCK bank rows at a time, on any device.
    `bias` is [P], or [S, P] with row s for the s-th of S equal blocks of
    query rows (per-seed weights, K5). With strategy 'inbank' the values are
    the bank's columns col0 .. col0 + c (`values` is not read). A prune mask
    (K6, `prune_grid` shape) sets the logits of its skipped cells to NEG_INF:
    there m does not move and every exponential is 0, at every tier, so the
    state is what the kernels' skipping leaves. `fast_exp` (default:
    precision == 'default') takes the bf16 exponential; `flash_score_update`
    passes precision and fast_exp after `_route`.

    'highest' takes true fp32 dots (`fp32.true_fp32`: TF32 off for the
    call), summed in the BLAS library's order (`_fp32_logits`); with the
    bf16 exponential in the fp32 kernel's own order
    (`fp32_logits_in_order`), since the bf16 rounding of x = logit - m
    turns a last-bit difference of a logit into a visible one, as at
    'default' below.

    'high' and 'default' take the TPU kernel's bf16x3 split,
    qh.kh + qh.kl + ql.kh, and repeat the CUDA kernel's arithmetic: the
    split dot summed step for step as the kernel sums it (`_split_dot`),
    and the logit dot * dotscale + bias rounded once, as the kernel's fused
    multiply-add. The logit scale 1/(2 beta^2) makes the posterior
    sensitive to the dot's last bits: two fp32 summation orders of the same
    split differ by up to ~0.5% on the posterior mean at the sharpest
    softmax (k = 17, t = 0.05), so the kernel sums the hi.hi part exactly
    (TwoSum), and this version repeats the kernel's sum.

    With the fp32 exp2, e = exp2(logits - m_safe) and s2 += e @ V in fp32,
    or the split product of e and V (`_split_product`) for 'inbank' after
    split dots; s1 is the fp32 row sum.

    With the bf16 exponential it re-bases m every FAST_TILE bank rows as
    its kernels do (`_fast_tiles`), and rounds where they do (bf16 round
    to nearest even; x = logits - m_safe):
      e  = bf16(exp(bf16(bf16(x) * bf16(ln 2))))
      s1 = sum_f32 e
      s2 = sum_f32 bf16(e * bf16(V))      'vpu'
      s2 = sum_f32 e * bf16(V)            'mxu', 'mxu1', 'inbank' after split dots
      s2 = sum_f32 e * V                  'inbank' after fp32 dots
    with the rescale exp2(m_old - m_safe) in fp32 as before. Why these
    points: JAX lowers `jnp.exp2` of a bf16 array to exp(bf16(ln 2) * x),
    with the factor 0.69140625 and the product in bf16, so the TPU kernel
    computes 2^(0.9975 x), not 2^x; a true exp2 differs from it by ~2.5e-3
    on the posterior mean. And the Pallas kernel's dtypes make e a bf16
    array and 'vpu's e * v a bf16 product, which this version and the CUDA
    kernels keep; XLA's CPU backend drops some of those roundings, so the
    JAX kernel in interpret mode agrees with this version only to ~1.4e-3
    on s2, while the CUDA kernels and this version share every rounding
    point. The exp is taken in float64 and rounded to fp32 before its bf16
    rounding (the kernels' fp32 `expf` is within 2 ulp of that). Where m
    is re-based is part of the function with this exponential: x is
    rounded against the m current at its tile, so a sweep re-based every
    8192 rows, or two chained calls against one, differ from it by ~1e-3
    on the posterior mean.

    Autograd differentiates it with respect to q and the carried state
    (`torch.func.jacrev` of a score module with use_pallas=False) after
    fp32 dots with the fp32 exp2, each block's backward recomputing its
    exponentials (`_Fp32Block`); the split dots and the bf16 exponential
    raise under grad."""
    split = precision != "highest"
    fast = precision == "default" if fast_exp is None else bool(fast_exp)
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in (bias, bank, values)):
        raise NotImplementedError(
            "the plain flash-score sweep differentiates with respect to the "
            "queries and the carried state only; the bank, its weights and "
            "the values are constants")
    if (split or fast) and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, m, s1, s2)):
        raise NotImplementedError(
            "the plain flash-score sweep differentiates after fp32 dots with "
            "the fp32 exp2 only ('highest' without fast_exp): the split dots "
            "and the bf16 exponential repeat the kernels' roundings step by "
            "step, which autograd does not follow")
    with true_fp32():
        if split:
            qh, ql = _split_bf16(q)
            qh64, ql64 = qh.double(), ql.double()
        for p0 in range(0, bank.shape[0], PLAIN_BLOCK):
            p1 = min(p0 + PLAIN_BLOCK, bank.shape[0])
            skip = (None if prune_mask is None
                    else _mask_cells(prune_mask, q.shape[0], p0, p1))
            v = (bank[p0:p1, col0 : col0 + s2.shape[1]] if strategy == "inbank"
                 else values[p0:p1])
            if not (split or fast):
                m, s1, s2 = _Fp32Block.apply(q, bank[p0:p1], bias[..., p0:p1], v, skip,
                                             dotscale, m, s1, s2)
                continue
            if split:
                dots = _split_dot(qh64, ql64, *_split_bf16(bank[p0:p1]))
                logits = _add_bias(dots.double() * dotscale,
                                   bias[..., p0:p1].double()).float()
            else:
                logits = fp32_logits_in_order(q, bank[p0:p1], dotscale, bias[..., p0:p1])
            if skip is not None:
                logits = logits.masked_fill(skip, NEG_INF)
            if fast:
                m, s1, s2 = _fast_tiles(logits, v, m, s1, s2, _fast_rule(strategy, split))
            else:
                product = _split_product if strategy == "inbank" else torch.matmul
                m, s1, s2 = _online_step(logits, v, m, s1, s2, product)
    return m, s1, s2


def _online_step(logits, v, m, s1, s2, product=torch.matmul) -> State:
    """One block of the fp32-exp2 online softmax: m, s1 and s2 advanced by
    logits [M, n] with values v [n, c] (s2 += product(e, v))."""
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    m_new = torch.maximum(m, logits.amax(dim=1))
    m_safe = torch.where(m_new <= NEG_INF * 0.5, zero, m_new)
    scale = torch.where(m <= NEG_INF * 0.5, zero, torch.exp2(m - m_safe))
    e = torch.exp2(logits - m_safe[:, None])
    return m_new, s1 * scale + e.sum(dim=1), s2 * scale[:, None] + product(e, v)


class _Fp32Block(torch.autograd.Function):
    """One block of the plain sweep after fp32 dots and the fp32 exp2, with
    a backward that recomputes the block's exponentials from q and the bank
    (as flash attention's backward does) instead of keeping them, and whose
    work over the block does not depend on the cotangent.

    With e[m, p] = exp2(logit[m, p] - m_safe[m]) and logit = dotscale
    <q_m, k_p> + bias_p, the cotangents ds1 [.., M], ds2 [.., M, c] of
    s1 = sum_p e and s2 = sum_p e v_p give
        dq[.., m] = sum_j A[.., m, j] H[m, j],  A = [ds1 | ds2],
        H[m, j] = ln 2 dotscale sum_p e[m, p] u_j[p] k_p,  u = [1 | v],
    so the [M, P] work (H: one product per block) is done once for all the
    lanes of a `torch.func.jacrev` chunk, and each lane adds only
    [M, 1 + c, d]. m is a constant of the backward: the offset-invariant
    quantities m + log s1 and s2 / s1 do not depend on it, so their
    derivatives are exact. The gradient reaches q and the carried s1, s2
    only (the bank, its bias and the values are constants)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, bank, bias, v, skip, dotscale, m, s1, s2):
        return _online_step(_block_logits(q, bank, bias, skip, dotscale), v, m, s1, s2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, bank, bias, v, skip, dotscale, m, _, _ = inputs
        ctx.dotscale = dotscale
        ctx.save_for_backward(q, bank, bias, v, skip, m, output[0])

    @staticmethod
    def backward(ctx, _dm, ds1, ds2):
        q, bank, bias, v, skip, m, m_new = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        m_safe = torch.where(m_new <= NEG_INF * 0.5, zero, m_new)
        scale = torch.where(m <= NEG_INF * 0.5, zero, torch.exp2(m - m_safe))
        dq = None
        if ctx.needs_input_grad[0]:
            with true_fp32():
                logits = _block_logits(q, bank, bias, skip, ctx.dotscale)
                g = torch.exp2(logits - m_safe[:, None]) * (LN2 * ctx.dotscale)  # [M, n]
                u = torch.cat([torch.ones_like(v[:, :1]), v], dim=1).T  # [1 + c, n]
                h = (g[:, None, :] * u[None]) @ bank  # [M, 1 + c, d]
                a = torch.cat([ds1[..., None], ds2], dim=-1)  # [.., M, 1 + c]
                dq = (a[..., None] * h).sum(dim=-2)
        return (dq, None, None, None, None, None, None, ds1 * scale,
                ds2 * scale[:, None])


def _block_logits(q, bank, bias, skip, dotscale: float) -> torch.Tensor:
    logits = _fp32_logits(q, bank, dotscale, bias)
    return logits if skip is None else logits.masked_fill(skip, NEG_INF)


def sweep_kernel(q, bias, bank, values, dotscale: float, m, s1, s2,
                 precision: str = "highest", strategy: str = "vpu",
                 col0: int = -1, prune_mask=None, fast_exp: bool | None = None) -> State:
    """Launch the CUDA kernel of `precision` (after `_route`; at 'highest'
    with the bf16 exponential if fast_exp) on the current stream; returns
    new tensors. `bias` is [P], or [S, P] for S equal blocks of query rows
    (K5: the kernel's grid gains a seed axis). With strategy 'inbank'
    `values` is None and the kernel takes the bank's columns col0 ..
    col0 + c. A prune mask (1-D bias only) makes each block walk only its
    live bank tiles (K6). 'vpu' keeps c <= MAX_CHANNELS sums per row; the
    matrix value sums ('mxu', and 'vpu' or 'inbank' past MAX_CHANNELS)
    take any c up to WIDE_MAX_CHANNELS. Each launch adds one to its count
    in `flash_score_update.launches` (see the module docstring)."""
    name = KERNEL_OF[precision]
    fast = precision == "default" if fast_exp is None else bool(fast_exp)
    M, d = q.shape
    P = bank.shape[0]
    c = s2.shape[1]
    rows_per_seed = M // bias.shape[0] if bias.ndim == 2 else M
    if not 1 <= c <= WIDE_MAX_CHANNELS:
        raise ValueError(
            f"the kernels take 1..{WIDE_MAX_CHANNELS} value channels, got {c}"
        )
    tensors = (q, bias, bank, m, s1, s2) + (() if values is None else (values,))
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "flash-score kernel takes contiguous float32 CUDA tensors"
            )
    if prune_mask is not None:  # int32, shape checked by the wrapper
        tensors += (prune_mask,)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash-score kernel inputs lie on different devices")
    m_out = torch.empty_like(m)
    s1_out = torch.empty_like(s1)
    s2_out = torch.empty_like(s2)
    if M == 0:
        return m_out, s1_out, s2_out
    fn = _build.load(name)
    dev = q.device
    split_rows, nsplit, _ = split_launch(name, M, rows_per_seed, P, precision, strategy, c,
                                         fast)
    numel = scratch_numel(name, nsplit, M, P, d, c, fast)
    scratch = torch.empty(numel, dtype=torch.float32, device=dev) if numel else None
    err = fn(
        q.data_ptr(), bias.data_ptr(), bank.data_ptr(),
        None if values is None else values.data_ptr(),
        float(dotscale), m.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        m_out.data_ptr(), s1_out.data_ptr(), s2_out.data_ptr(),
        M, rows_per_seed, P, d, c,
        None if prune_mask is None else prune_mask.data_ptr(),
        0 if prune_mask is None else prune_mask.shape[1],
        STRATEGY_CODE[strategy], col0, int(fast),
        None if scratch is None else scratch.data_ptr(), split_rows,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    key = launch_key(precision, strategy, fast, per_seed=bias.ndim == 2,
                     prune=prune_mask is not None)
    flash_score_update.launches[key] += 1
    return m_out, s1_out, s2_out


def _update(sweep, q, qn, bank, pn, values, w, at, bt, state, precision,
            rows_per_seed, v_strategy, fast_exp, inbank_cols,
            prune_mask) -> State:
    _check_precision(precision)
    m0, s10, s20 = state
    M, d = q.shape
    P = bank.shape[0]
    fast = precision == "default" if fast_exp is None else bool(fast_exp)
    strategy, c = _strategy(fast, v_strategy, values, inbank_cols, d, P)
    if prune_mask is not None:
        if w.ndim == 2:  # the JAX wrapper's refusal (`flash_score.py:390-397`)
            raise ValueError(
                "prune_mask is unsupported on the vector-label and chunked "
                "paths (ops.prune targets the small-dp banked sweeps)"
            )
        if tuple(prune_mask.shape) != prune_grid(M, P):
            raise ValueError(
                f"prune_mask shape {tuple(prune_mask.shape)} != grid "
                f"{prune_grid(M, P)} — size it with prune_grid()"
            )
        prune_mask = prune_mask.to(q.device, torch.int32).contiguous()
    if w.ndim == 2:
        S = w.shape[0]
        if rows_per_seed is None or M != S * rows_per_seed:
            raise ValueError(
                "2-D weights need rows_per_seed with M == S * rows_per_seed"
            )
    shapes = {
        "qn": (qn.shape, (M,)), "bank": (bank.shape, (P, d)),
        "pn": (pn.shape, (P,)),
        "w": (w.shape, (P,) if w.ndim < 2 else (w.shape[0], P)),
        "m": (m0.shape, (M,)), "s1": (s10.shape, (M,)),
        "s2": (s20.shape, (M, c)),
    }
    if strategy == "inbank":
        values, col0 = None, inbank_cols[0]  # V == bank[:, col0:col0+c]
    else:
        shapes["values"] = (getattr(values, "shape", ()), (P, c))
        col0 = -1
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name} has shape {tuple(got)}, expected {want}")
    dev = q.device
    at = _scalar(at)
    bt = _scalar(bt)
    inv2bt2 = 1.0 / (2.0 * bt * bt)
    # per-patch bias in base-2 log space: -a^2 ||p||^2 / (2 beta^2) * log2(e)
    # + log2 w, with NEG_INF for excluded (w = 0) entries
    logw = torch.where(
        w > 0.0, torch.log2(torch.clamp(w, min=1e-38)),
        torch.full_like(w, NEG_INF),
    )
    coef = -(at * at) * inv2bt2 * LOG2E
    bias = torch.clamp(coef.to(dev) * pn + logw, min=NEG_INF)
    # the per-query -||q||^2 / (2 beta^2) offset stays outside the sweep: m
    # moves into the sweep's qn-less base-2 convention and back out
    qn_s = qn * inv2bt2.to(dev)
    m_k = torch.where(m0 <= NEG_INF * 0.5, m0, (m0 + qn_s) * LOG2E)
    dotscale = float(2.0 * at * inv2bt2 * LOG2E)
    m, s1, s2 = sweep(q, bias, bank, values, dotscale, m_k, s10, s20,
                      precision=_route(precision, fast), strategy=strategy,
                      col0=col0, prune_mask=prune_mask, fast_exp=fast)
    m = torch.where(m <= NEG_INF * 0.5, m, m * LN2 - qn_s)
    return m, s1, s2


def _refuse_grad(*tensors) -> None:
    """The kernels read raw pointers and have no backward: an input that
    requires grad (under `torch.func.jacrev`, say) would get a result
    autograd knows nothing of, so a Jacobian through it would be zero.
    Refuse it instead."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the flash-score kernel has no backward: an input requires grad. "
            "Differentiate through the plain version instead (a score module "
            "built with use_pallas=False, or flash_score_update_plain)")


def flash_score_update(
    q: torch.Tensor,  # [M, d]
    qn: torch.Tensor,  # [M]
    bank: torch.Tensor,  # [P, d]
    pn: torch.Tensor,  # [P]
    values,  # [P, c]; None (unread) with v_strategy='inbank'
    w: torch.Tensor,  # [P], or [S, P] per-seed weights (see rows_per_seed)
    at,  # scalar sqrt(1 - beta)
    bt,  # scalar sqrt(beta)
    state: State,  # m [M], s1 [M], s2 [M, c], NEG_INF sentinel convention
    *,
    precision: str = "highest",
    v_strategy: str = "auto",
    fast_exp: bool | None = None,  # default: precision == 'default'
    rows_per_seed: int | None = None,  # with 2-D w: M = S * rows_per_seed
    inbank_cols: Tuple[int, int] | None = None,  # (start, c) for 'inbank'
    prune_mask: torch.Tensor | None = None,  # int32 prune_grid(M, P) (K6)
) -> State:
    """One fused bank sweep; returns the updated (m, s1, s2) with the finite
    NEG_INF sentinel convention. With 2-D weights [S, P], the query rows are
    S seed-major blocks of `rows_per_seed` rows and block s uses weight row
    s. With a prune mask (1-D weights) the masked cells are skipped (K6).
    CUDA tensors run the hand-written kernel of the dots and the
    exponential (`_route`: K1 after fp32 dots, K2 after split dots with
    the fp32 exp2, K3/K4 after split dots with the bf16 exponential; each
    launch counted, see the module docstring), which refuse inputs that
    require grad (`_refuse_grad`); CPU tensors run `sweep_plain`, which
    autograd differentiates; any other device raises."""
    if q.is_cuda:
        _refuse_grad(q, qn, bank, pn, values, w, at, bt, *state)
        sweep = sweep_kernel
    elif q.device.type == "cpu":
        sweep = sweep_plain
    else:
        raise ValueError(f"no flash-score sweep for device {q.device}")
    return _update(sweep, q, qn, bank, pn, values, w, at, bt, state, precision,
                   rows_per_seed, v_strategy, fast_exp, inbank_cols, prune_mask)


flash_score_update.launches = {
    launch_key(prec, strategy, fast, per_seed, prune): 0
    for prec in KERNEL_OF
    for fast in ((False, True) if prec == "highest" else (prec == "default",))
    for strategy in STRATEGY_SUFFIX if fast or strategy != "mxu1"
    for per_seed, prune in ((False, False), (True, False), (False, True))
}


def flash_score_update_plain(q, qn, bank, pn, values, w, at, bt, state, *,
                             precision: str = "highest",
                             v_strategy: str = "auto",
                             fast_exp: bool | None = None,
                             rows_per_seed: int | None = None,
                             inbank_cols: Tuple[int, int] | None = None,
                             prune_mask: torch.Tensor | None = None) -> State:
    """`flash_score_update` through the plain version on any device: the
    yardstick the kernel is held against on the card, and the route of a
    score module built with use_pallas=False, which autograd
    differentiates."""
    return _update(sweep_plain, q, qn, bank, pn, values, w, at, bt, state,
                   precision, rows_per_seed, v_strategy, fast_exp, inbank_cols,
                   prune_mask)


def state_to_kernel(m, s1, s2) -> State:
    """SoftmaxState convention (-inf empties) -> finite sentinel."""
    return (torch.where(torch.isneginf(m), torch.full_like(m, NEG_INF), m), s1, s2)


def state_from_kernel(m, s1, s2) -> State:
    """Finite-sentinel state -> -inf convention."""
    return (
        torch.where(m <= NEG_INF * 0.5, torch.full_like(m, float("-inf")), m),
        s1, s2,
    )
