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
K2). Nothing falls back from one device, or one tier, to another.

Per-seed weights (variant K5): `w` may be [S, P], one weight row per seed,
with `rows_per_seed` query rows per seed (M = S * rows_per_seed, seed-major),
as in batched conditional generation with one label per seed. Both kernels
take it on a 2-D grid of (query block, seed), so a block never mixes seeds;
each launch with 2-D weights adds one to `launches[name + PER_SEED]`
instead of `launches[name]`.

Ported: the 'highest' (K1) and 'high' (K2) tiers with per-channel value sums,
with 1-D or per-seed (K5) weights. Not yet: 'default' (K3), the 'inbank' and
'mxu' value strategies (K4), prune masks (K6).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

NEG_INF = float(-1e30)  # finite -inf stand-in: keeps exp2()/rescale exact at fp32
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MAX_CHANNELS = 8  # value channels the kernel accumulates per row
PLAIN_BLOCK = 8192  # bank rows per step of the plain version
# precision tier -> the kernel that runs it on the card (ops._build.KERNELS)
KERNEL_OF = {"highest": "flash_score", "high": "flash_score_bf16x3"}
# suffix of a kernel's launch count with per-seed weights (variant K5)
PER_SEED = "/per_seed"

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check_precision(precision: str) -> None:
    if precision in KERNEL_OF:
        return
    if precision == "default":
        raise NotImplementedError(
            "precision='default' (bf16 exp2, fused e @ [V|1]) is flash-score "
            "variant K3, not ported yet; use precision='highest' or 'high'"
        )
    raise ValueError(
        f"precision must be 'highest', 'high' or 'default', got {precision!r}"
    )


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


def _toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    r = x64.float()
    return torch.where(r.double().abs() > x64.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _split_dot(qh64, ql64, kh, kl) -> torch.Tensor:
    """The bf16x3 split dot qh.kh + qh.kl + ql.kh as the kernel computes it,
    in float64: qh.kh as the sum of its MMA_K-feature slices, each the exact
    slice sum rounded toward zero to float32 (what a tensor-core product
    step returns from a zero accumulator, as measured on an H100), plus the
    cross terms; rounded once to float32. Products of bf16 values and their
    slice sums are exact in float64."""
    kh64 = kh.double()
    dots = qh64 @ kl.double().T + ql64 @ kh64.T
    for f0 in range(0, kh.shape[1], MMA_K):
        dots += _toward_zero(qh64[:, f0 : f0 + MMA_K] @ kh64[:, f0 : f0 + MMA_K].T)
    return dots.float()


def _add_bias(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [M, n] + bias: a [n] row for every row of x, or [S, n] with row s
    for the s-th of S equal blocks of rows (one rounding either way)."""
    if bias.ndim == 1:
        return x + bias
    S, n = bias.shape
    return (x.view(S, -1, n) + bias[:, None, :]).view(x.shape)


def sweep_plain(q, bias, bank, values, dotscale: float, m, s1, s2,
                precision: str = "highest") -> State:
    """Plain PyTorch version of the kernels: the same base-2 online softmax
    over the same bias row, PLAIN_BLOCK bank rows at a time, on any device.
    `bias` is [P], or [S, P] with row s for the s-th of S equal blocks of
    query rows (per-seed weights, K5).

    'highest' takes true fp32 dots, with TF32 switched off for the call
    (torch.backends.cuda.matmul.allow_tf32 = False, restored after).

    'high' takes the TPU kernel's bf16x3 split, qh.kh + qh.kl + ql.kh, and
    repeats the kernel's arithmetic: the split dot summed as `_split_dot`
    sums it, and the logit dot * dotscale + bias rounded once, as the
    kernel's fused multiply-add. The logit scale 1/(2 beta^2) makes the
    posterior sensitive to the dot's last bits: two fp32 summation orders
    of the same split differ by up to ~0.5% on the posterior mean at the
    sharpest softmax (k = 17, t = 0.05), so the kernel sums the split
    exactly up to a residual far below an ulp, and so does this version."""
    high = precision == "high"
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
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
            m_new = torch.maximum(m, logits.amax(dim=1))
            m_safe = torch.where(m_new <= NEG_INF * 0.5, zero, m_new)
            e = torch.exp2(logits - m_safe[:, None])
            scale = torch.where(m <= NEG_INF * 0.5, zero, torch.exp2(m - m_safe))
            s1 = s1 * scale + e.sum(dim=1)
            s2 = s2 * scale[:, None] + e @ values[p0:p1]
            m = m_new
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return m, s1, s2


def sweep_kernel(q, bias, bank, values, dotscale: float, m, s1, s2,
                 precision: str = "highest") -> State:
    """Launch the tier's CUDA kernel on the current stream; returns new
    tensors. `bias` is [P], or [S, P] for S equal blocks of query rows
    (K5: the kernel's grid gains a seed axis). Each launch adds one to that
    kernel's count in `flash_score_update.launches`, under `name` with a
    1-D bias and `name + PER_SEED` with a 2-D one."""
    name = KERNEL_OF[precision]
    M, d = q.shape
    P, c = values.shape
    rows_per_seed = M // bias.shape[0] if bias.ndim == 2 else M
    if not 1 <= c <= MAX_CHANNELS:
        raise NotImplementedError(
            f"the kernels accumulate 1..{MAX_CHANNELS} value channels, "
            f"got {c} (the matrix value path is flash-score variant K4)"
        )
    tensors = (q, bias, bank, values, m, s1, s2)
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "flash-score kernel takes contiguous float32 CUDA tensors"
            )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash-score kernel inputs lie on different devices")
    m_out = torch.empty_like(m)
    s1_out = torch.empty_like(s1)
    s2_out = torch.empty_like(s2)
    if M == 0:
        return m_out, s1_out, s2_out
    fn = _build.load(name)
    dev = q.device
    err = fn(
        q.data_ptr(), bias.data_ptr(), bank.data_ptr(), values.data_ptr(),
        float(dotscale), m.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        m_out.data_ptr(), s1_out.data_ptr(), s2_out.data_ptr(),
        M, rows_per_seed, P, d, c,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    flash_score_update.launches[name + (PER_SEED if bias.ndim == 2 else "")] += 1
    return m_out, s1_out, s2_out


def _update(sweep, q, qn, bank, pn, values, w, at, bt, state, precision,
            rows_per_seed) -> State:
    _check_precision(precision)
    m0, s10, s20 = state
    M, d = q.shape
    P = bank.shape[0]
    if w.ndim == 2:
        S = w.shape[0]
        if rows_per_seed is None or M != S * rows_per_seed:
            raise ValueError(
                "2-D weights need rows_per_seed with M == S * rows_per_seed"
            )
    c = values.shape[1] if values.ndim == 2 else -1
    shapes = {
        "qn": (qn.shape, (M,)), "bank": (bank.shape, (P, d)),
        "pn": (pn.shape, (P,)), "values": (values.shape, (P, c)),
        "w": (w.shape, (P,) if w.ndim < 2 else (w.shape[0], P)),
        "m": (m0.shape, (M,)), "s1": (s10.shape, (M,)),
        "s2": (s20.shape, (M, c)),
    }
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
                      precision=precision)
    m = torch.where(m <= NEG_INF * 0.5, m, m * LN2 - qn_s)
    return m, s1, s2


def flash_score_update(
    q: torch.Tensor,  # [M, d]
    qn: torch.Tensor,  # [M]
    bank: torch.Tensor,  # [P, d]
    pn: torch.Tensor,  # [P]
    values: torch.Tensor,  # [P, c]
    w: torch.Tensor,  # [P], or [S, P] per-seed weights (see rows_per_seed)
    at,  # scalar sqrt(1 - beta)
    bt,  # scalar sqrt(beta)
    state: State,  # m [M], s1 [M], s2 [M, c], NEG_INF sentinel convention
    *,
    precision: str = "highest",
    rows_per_seed: int | None = None,  # with 2-D w: M = S * rows_per_seed
) -> State:
    """One fused bank sweep; returns the updated (m, s1, s2) with the finite
    NEG_INF sentinel convention. With 2-D weights [S, P], the query rows are
    S seed-major blocks of `rows_per_seed` rows and block s uses weight row
    s. CUDA tensors run the tier's hand-written kernel, K1 at 'highest' and
    K2 at 'high' (each launch adds one to `flash_score_update.launches`
    under the kernel's name from KERNEL_OF, with PER_SEED appended for 2-D
    weights); CPU tensors run `sweep_plain`; any other device raises."""
    if q.is_cuda:
        sweep = sweep_kernel
    elif q.device.type == "cpu":
        sweep = sweep_plain
    else:
        raise ValueError(f"no flash-score sweep for device {q.device}")
    return _update(sweep, q, qn, bank, pn, values, w, at, bt, state, precision,
                   rows_per_seed)


flash_score_update.launches = {
    name + kind: 0 for name in KERNEL_OF.values() for kind in ("", PER_SEED)
}


def flash_score_update_plain(q, qn, bank, pn, values, w, at, bt, state, *,
                             precision: str = "highest",
                             rows_per_seed: int | None = None) -> State:
    """`flash_score_update` through the plain version on any device (the
    yardstick the kernel is held against on the card)."""
    return _update(sweep_plain, q, qn, bank, pn, values, w, at, bt, state,
                   precision, rows_per_seed)


def state_to_kernel(m, s1, s2) -> State:
    """SoftmaxState convention (-inf empties) -> finite sentinel."""
    return (torch.where(torch.isneginf(m), torch.full_like(m, NEG_INF), m), s1, s2)


def state_from_kernel(m, s1, s2) -> State:
    """Finite-sentinel state -> -inf convention."""
    return (
        torch.where(m <= NEG_INF * 0.5, torch.full_like(m, float("-inf")), m),
        s1, s2,
    )
