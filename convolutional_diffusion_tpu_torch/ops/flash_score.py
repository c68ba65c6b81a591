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
shift of m by the per-query ||q||^2 / (2 beta^2) on entry and exit. The
tensor's device picks the sweep: on CUDA a hand-written kernel, on the CPU
`sweep_plain`, the same function in plain PyTorch. The precision picks the
kernel: 'highest' runs the fp32 kernel (`csrc/flash_score.cu`, variant K1),
'high' the bf16x3 tensor-core kernel (`csrc/flash_score_bf16x3.cu`, variant
K2), 'default' the bf16-exp kernel (`csrc/flash_score_fast.cu`, variants K3
and K4 'inbank'). Nothing falls back from one device, or one tier, to
another.

Value strategies, as in the JAX wrapper: 'vpu' sums the c <= 8 value
channels per row; at 'default', 'mxu1' computes s2 and s1 as one bf16
product e @ [V | 1] (a ones column gives s1), and 'inbank' the same product
against the bank's own center columns `inbank_cols = (start, c)`, with no
values operand. 'auto' picks 'mxu1' for a 'default' sweep over P >= 2^18
bank rows in one call and 'vpu' otherwise (c <= 8).

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

Launch counts: each launch adds one to `flash_score_update.launches` under
the kernel's name, then '/inbank' or '/mxu1' for those strategies, then
'/per_seed' for 2-D weights or '/prune' with a mask, so a run shows which
variant every chunk took.

Not ported yet: the 'mxu' strategy (c > 8, K4), 'inbank' at 'highest' and
'high', `fast_exp` apart from the tier; each raises.
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
MAX_CHANNELS = 8  # value channels the kernel accumulates per row
PLAIN_BLOCK = 8192  # bank rows per step of the plain version
FAST_TILE = _build.SPLIT_TILE  # bank rows per online-softmax step of the 'default' kernel
MXU1_MIN_P = 1 << 18  # 'auto' takes 'mxu1' for 'default' sweeps this long
# precision tier -> the kernel that runs it on the card (ops._build.KERNELS)
KERNEL_OF = {"highest": "flash_score", "high": "flash_score_bf16x3",
             "default": "flash_score_fast"}
# value strategy -> its code in the 'default' kernel's C interface and the
# suffix of its launch count
STRATEGY_CODE = {"vpu": 0, "mxu1": 1, "inbank": 2}
STRATEGY_SUFFIX = {"vpu": "", "mxu1": "/mxu1", "inbank": "/inbank"}
# suffix of a kernel's launch count with per-seed weights (variant K5), and
# with a prune mask (variant K6)
PER_SEED = "/per_seed"
PRUNE = "/prune"
PRUNE_ROWS = _build.PRUNE_ROWS  # query rows per prune-mask cell
PRUNE_BLOCK = _build.PRUNE_BLOCK  # bank rows per prune-mask cell

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check_precision(precision: str) -> None:
    if precision not in KERNEL_OF:
        raise ValueError(
            f"precision must be 'highest', 'high' or 'default', got {precision!r}"
        )


def _strategy(precision, v_strategy, fast_exp, values, inbank_cols, d, P):
    """The value strategy that runs and the value channels c, by the JAX
    wrapper's rules (`flash_score.py:380-386, 556-576`)."""
    fast = precision == "default"
    if fast_exp is not None and bool(fast_exp) != fast:
        raise NotImplementedError(
            "fast_exp apart from precision='default' is not ported yet "
            "(ROADMAP.md section 2, K3): the bf16 exp runs exactly at 'default'"
        )
    if v_strategy == "inbank":
        if inbank_cols is None:
            raise ValueError("v_strategy='inbank' requires inbank_cols=(start, c)")
        col0, c = inbank_cols
        if not (0 <= col0 and col0 + c <= d):
            raise ValueError(f"inbank_cols {inbank_cols} out of range for d={d}")
        if not fast:
            raise NotImplementedError(
                f"v_strategy='inbank' at precision={precision!r} (flash-score "
                "variant K4) is not ported yet (ROADMAP.md section 2); it is "
                "ported at 'default'"
            )
        return "inbank", c
    c = values.shape[1] if values is not None and values.ndim == 2 else -1
    if v_strategy == "auto":
        if fast and P >= MXU1_MIN_P:
            v_strategy = "mxu1"
        else:
            v_strategy = "vpu" if c <= MAX_CHANNELS else "mxu"
    if v_strategy == "mxu":
        raise NotImplementedError(
            f"v_strategy='mxu' (e @ V for c > {MAX_CHANNELS} value channels, "
            "flash-score variant K4) is not ported yet (ROADMAP.md section 2)"
        )
    if v_strategy == "mxu1":
        if not fast:
            raise ValueError(
                "v_strategy='mxu1' is a fast-mode path (bf16 e @ [V|1]); "
                "parity mode keeps the fp32 VPU accumulation"
            )
        if c % 128 == 0:
            raise ValueError(f"no spare lane for s1 (c={c}, cp={c})")
    elif v_strategy != "vpu":
        raise ValueError(
            "v_strategy must be 'auto', 'vpu', 'mxu1', 'inbank' or 'mxu', "
            f"got {v_strategy!r}"
        )
    return v_strategy, c


def prune_grid(M: int, P: int) -> Tuple[int, int]:
    """The shape of a prune mask over M query rows and P bank rows."""
    return -(-M // PRUNE_ROWS), -(-P // PRUNE_BLOCK)


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


def _add_bias(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [M, n] + bias: a [n] row for every row of x, or [S, n] with row s
    for the s-th of S equal blocks of rows (one rounding either way)."""
    if bias.ndim == 1:
        return x + bias
    S, n = bias.shape
    return (x.view(S, -1, n) + bias[:, None, :]).view(x.shape)


def _default_tiles(logits, v, m, s1, s2, strategy: str) -> State:
    """One block of the 'default' sweep (logits [M, n], values v [n, c]),
    re-basing m every FAST_TILE bank rows as the kernel does: the bf16
    rounding of x = logits - m depends on the m it is taken against. The
    tiles are folded in closed form, s * 2^(m_before - m_after) + t per
    tile, which differs from the kernel's sequential fold only in fp32
    rounding."""
    M, n = logits.shape
    nt = -(-n // FAST_TILE)
    pad = nt * FAST_TILE - n
    lg = F.pad(logits, (0, pad), value=NEG_INF).view(M, nt, FAST_TILE)
    v = F.pad(_bf16(v), (0, 0, 0, pad)).view(nt, FAST_TILE, -1)
    # m before the first tile and after each one
    m_run = torch.cummax(torch.cat([m[:, None], lg.amax(dim=2)], dim=1), dim=1).values
    empty = m_run <= NEG_INF * 0.5
    m_safe = torch.where(empty, 0.0, m_run)
    x = _bf16(lg - m_safe[:, 1:, None])
    e = _bf16(torch.exp(_bf16(x * LN2_BF16).double()).float())
    if strategy == "vpu":
        t2 = torch.stack([_bf16(e * v[None, :, :, ch]).sum(dim=2)
                          for ch in range(v.shape[2])], dim=2)
    else:
        t2 = torch.einsum("mtk,tkc->mtc", e, v)
    f = torch.where(empty, 0.0, torch.exp2(m_safe - m_safe[:, -1:]))
    s1 = s1 * f[:, 0] + (e.sum(dim=2) * f[:, 1:]).sum(dim=1)
    s2 = s2 * f[:, :1] + (t2 * f[:, 1:, None]).sum(dim=1)
    return m_run[:, -1], s1, s2


def sweep_plain(q, bias, bank, values, dotscale: float, m, s1, s2,
                precision: str = "highest", strategy: str = "vpu",
                col0: int = -1, prune_mask=None) -> State:
    """Plain PyTorch version of the kernels: the same base-2 online softmax
    over the same bias row, PLAIN_BLOCK bank rows at a time, on any device.
    `bias` is [P], or [S, P] with row s for the s-th of S equal blocks of
    query rows (per-seed weights, K5). With strategy 'inbank' the values are
    the bank's columns col0 .. col0 + c (`values` is not read). A prune mask
    (K6, `prune_grid` shape) sets the logits of its skipped cells to NEG_INF:
    there m does not move and every exponential is 0, at every tier, so the
    state is what the kernels' skipping leaves.

    'highest' takes true fp32 dots (`fp32.true_fp32`: TF32 off for the
    call).

    'high' takes the TPU kernel's bf16x3 split, qh.kh + qh.kl + ql.kh, and
    repeats the CUDA kernel's arithmetic: the split dot summed step for
    step as the kernel sums it (`_split_dot`), and the logit
    dot * dotscale + bias rounded once, as the kernel's fused multiply-add.
    The logit scale 1/(2 beta^2) makes the posterior sensitive to the
    dot's last bits: two fp32 summation orders of the same split differ by
    up to ~0.5% on the posterior mean at the sharpest softmax (k = 17,
    t = 0.05), so the kernel sums the hi.hi part exactly (TwoSum), and
    this version repeats the kernel's sum.

    'default' takes the 'high' logits, re-bases m every FAST_TILE bank rows
    as its kernel does (`_default_tiles`), and rounds where the kernel does
    (bf16 round to nearest even; x = logits - m_safe):
      e  = bf16(exp(bf16(bf16(x) * bf16(ln 2))))
      s1 = sum_f32 e
      s2 = sum_f32 bf16(e * bf16(V))      'vpu'
      s2 = sum_f32 e * bf16(V)            'mxu1', 'inbank' (exact products)
    with the rescale exp2(m_old - m_safe) in fp32 as before. Why these
    points: JAX lowers `jnp.exp2` of a bf16 array to exp(bf16(ln 2) * x),
    with the factor 0.69140625 and the product in bf16, so the TPU kernel
    computes 2^(0.9975 x), not 2^x; a true exp2 differs from it by ~2.5e-3
    on the posterior mean. And the Pallas kernel's dtypes make e a bf16
    array and 'vpu's e * v a bf16 product, which this version and the CUDA
    kernel keep; XLA's CPU backend drops some of those roundings, so the
    JAX kernel in interpret mode agrees with this version only to ~1.4e-3
    on s2, while the CUDA kernel and this version share every rounding
    point. The exp is taken in float64 and rounded to fp32 before its bf16
    rounding (the kernel's fp32 `expf` is within 2 ulp of that). Where m
    is re-based is part of the function at this tier: x is rounded against
    the m current at its tile, so a sweep re-based every 8192 rows, or two
    chained calls against one, differ from it by ~1e-3 on the posterior
    mean."""
    high = precision != "highest"
    fast = precision == "default"
    with true_fp32():
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        if high:
            qh, ql = _split_bf16(q)
            qh64, ql64 = qh.double(), ql.double()
        for p0 in range(0, bank.shape[0], PLAIN_BLOCK):
            p1 = p0 + PLAIN_BLOCK
            if high:
                dots = _split_dot(qh64, ql64, *_split_bf16(bank[p0:p1]))
                logits = _add_bias(dots.double() * dotscale,
                                   bias[..., p0:p1].double()).float()
            else:
                logits = _add_bias((q @ bank[p0:p1].T) * dotscale, bias[..., p0:p1])
            if prune_mask is not None:
                logits = logits.masked_fill(
                    _mask_cells(prune_mask, q.shape[0], p0, p0 + logits.shape[1]),
                    NEG_INF)
            v = (bank[p0:p1, col0 : col0 + s2.shape[1]] if strategy == "inbank"
                 else values[p0:p1])
            if fast:
                m, s1, s2 = _default_tiles(logits, v, m, s1, s2, strategy)
                continue
            m_new = torch.maximum(m, logits.amax(dim=1))
            m_safe = torch.where(m_new <= NEG_INF * 0.5, zero, m_new)
            scale = torch.where(m <= NEG_INF * 0.5, zero, torch.exp2(m - m_safe))
            e = torch.exp2(logits - m_safe[:, None])
            s1 = s1 * scale + e.sum(dim=1)
            s2 = s2 * scale[:, None] + e @ v
            m = m_new
    return m, s1, s2


def sweep_kernel(q, bias, bank, values, dotscale: float, m, s1, s2,
                 precision: str = "highest", strategy: str = "vpu",
                 col0: int = -1, prune_mask=None) -> State:
    """Launch the tier's CUDA kernel on the current stream; returns new
    tensors. `bias` is [P], or [S, P] for S equal blocks of query rows
    (K5: the kernel's grid gains a seed axis). With strategy 'inbank'
    `values` is None and the kernel takes the bank's columns col0 ..
    col0 + c. A prune mask (1-D bias only) makes each block walk only its
    live bank tiles (K6). Each launch adds one to its count in
    `flash_score_update.launches` (see the module docstring)."""
    name = KERNEL_OF[precision]
    M, d = q.shape
    P = bank.shape[0]
    c = s2.shape[1]
    rows_per_seed = M // bias.shape[0] if bias.ndim == 2 else M
    if not 1 <= c <= MAX_CHANNELS:
        raise NotImplementedError(
            f"the kernels accumulate 1..{MAX_CHANNELS} value channels, "
            f"got {c} (the matrix value path is flash-score variant K4)"
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
    fast = (STRATEGY_CODE[strategy], col0) if precision == "default" else ()
    err = fn(
        q.data_ptr(), bias.data_ptr(), bank.data_ptr(),
        None if values is None else values.data_ptr(),
        float(dotscale), m.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        m_out.data_ptr(), s1_out.data_ptr(), s2_out.data_ptr(),
        M, rows_per_seed, P, d, c,
        None if prune_mask is None else prune_mask.data_ptr(),
        0 if prune_mask is None else prune_mask.shape[1], *fast,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    key = name + STRATEGY_SUFFIX[strategy] + (
        PER_SEED if bias.ndim == 2 else PRUNE if prune_mask is not None else "")
    flash_score_update.launches[key] += 1
    return m_out, s1_out, s2_out


def _update(sweep, q, qn, bank, pn, values, w, at, bt, state, precision,
            rows_per_seed, v_strategy, fast_exp, inbank_cols,
            prune_mask) -> State:
    _check_precision(precision)
    m0, s10, s20 = state
    M, d = q.shape
    P = bank.shape[0]
    strategy, c = _strategy(precision, v_strategy, fast_exp, values,
                            inbank_cols, d, P)
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
                      precision=precision, strategy=strategy, col0=col0,
                      prune_mask=prune_mask)
    m = torch.where(m <= NEG_INF * 0.5, m, m * LN2 - qn_s)
    return m, s1, s2


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
    CUDA tensors run the tier's hand-written kernel, K1 at 'highest', K2
    at 'high', K3/K4 at 'default' (each launch counted, see the module
    docstring); CPU tensors run `sweep_plain`; any other device raises."""
    if q.is_cuda:
        sweep = sweep_kernel
    elif q.device.type == "cpu":
        sweep = sweep_plain
    else:
        raise ValueError(f"no flash-score sweep for device {q.device}")
    return _update(sweep, q, qn, bank, pn, values, w, at, bt, state, precision,
                   rows_per_seed, v_strategy, fast_exp, inbank_cols, prune_mask)


flash_score_update.launches = {
    name + STRATEGY_SUFFIX[strategy] + variant: 0
    for prec, name in KERNEL_OF.items()
    for strategy in (STRATEGY_SUFFIX if prec == "default" else ("vpu",))
    for variant in ("", PER_SEED, PRUNE)
}


def flash_score_update_plain(q, qn, bank, pn, values, w, at, bt, state, *,
                             precision: str = "highest",
                             v_strategy: str = "auto",
                             fast_exp: bool | None = None,
                             rows_per_seed: int | None = None,
                             inbank_cols: Tuple[int, int] | None = None,
                             prune_mask: torch.Tensor | None = None) -> State:
    """`flash_score_update` through the plain version on any device (the
    yardstick the kernel is held against on the card)."""
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
