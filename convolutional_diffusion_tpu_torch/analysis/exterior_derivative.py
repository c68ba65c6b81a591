"""Exterior derivative (curl) of score and vector fields.

Counterpart of `convolutional_diffusion_tpu/analysis/exterior_derivative.py`.
For a field f: R^n -> R^n, df = J - J^T with J_ij = df_i / dx_j (the
reference's sign convention). A conservative (gradient) field has df = 0;
||df||_F measures how far a learned score is from a true gradient field.

The Jacobians are `torch.func.vmap(torch.func.jacrev(fn))`: one forward per
batch element and its VJPs over the n basis cotangents, `jacobian_chunk`
lanes at a time. The chunk comes from the field's size and the device's
free memory (`jacobian_chunk`): unchunked, a 32x32x3 field's n = 3072 lanes
would need ~90 GB for the flagship CNN. The VJPs' products run in true fp32
(`ops.fp32.true_fp32`): autograd runs them after the forward's own precision
scope has closed, where cuDNN would take TF32 by default.

A score module differentiates only on its plain route: build it with
`use_pallas=False` (the flash-score kernel has no backward and refuses
inputs that require grad).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jacrev, vjp, vmap

from ..ops.fp32 import true_fp32

__all__ = [
    "ExteriorDerivative",
    "compute_exterior_derivative",
    "compute_exterior_derivative_nd",
    "exterior_derivative_magnitude",
    "is_closed",
    "is_exact",
    "conservative_field",
    "rotation_field",
]

MEMORY_SHARE = 0.5  # of the card's free memory, for one Jacobian's lanes
CPU_LANES = 256  # lanes per chunk on the CPU, which has no peak-memory counter
PROBE_LANES = 16  # lanes of the card's second probe VJP (`jacobian_chunk`)


def jacobian_chunk(fn: Callable, xi: torch.Tensor, batch: int = 1) -> Optional[int]:
    """Cotangent lanes per `jacrev` chunk for fn at one flat input xi [n],
    with `batch` elements vmapped together; None means all n at once.

    On the card, the VJP is probed at 1 and at PROBE_LANES lanes: the
    memory the forward keeps for the backward (paid once per element), the
    backward's own (once per chunk) and what each further lane adds, against
    MEMORY_SHARE of the free memory. On the CPU, CPU_LANES."""
    n = xi.numel()
    if xi.device.type != "cuda":
        return None if n <= CPU_LANES else CPU_LANES
    dev = xi.device
    lanes = min(n, PROBE_LANES)
    eye = torch.eye(n, lanes, device=dev, dtype=xi.dtype).T  # [lanes, n]
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    peaks = []
    with true_fp32(), torch.no_grad():
        out, vjp_fn = vjp(fn, xi)
        kept = torch.cuda.memory_allocated(dev) - base
        for cot in (eye[:1], eye):
            torch.cuda.reset_peak_memory_stats(dev)
            vmap(vjp_fn)(cot.reshape(-1, *out.shape))
            torch.cuda.synchronize(dev)
            peaks.append(torch.cuda.max_memory_allocated(dev) - base - kept)
    del out, vjp_fn
    lane = max((peaks[1] - peaks[0]) / max(lanes - 1, 1), peaks[0] / n, 1.0)
    fixed = max(peaks[0] - lane, 0)
    free = torch.cuda.mem_get_info(dev)[0] + (
        torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))
    budget = MEMORY_SHARE * free - batch * (kept + fixed)
    return int(min(n, max(1, budget // (batch * lane))))


def _jacobians(fn: Callable, x: torch.Tensor, antisym: bool = True):
    """vmap over x [b, n] of J = jacrev(fn) at each row, or of J - J^T."""
    chunk_size = jacobian_chunk(fn, x[0], batch=x.shape[0])

    def single(xi):
        J = jacrev(fn, chunk_size=chunk_size)(xi)  # J[i, j] = d f_i / d x_j
        return J - J.T if antisym else J

    # no_grad outside the transforms: jacrev still differentiates with
    # respect to x, but no graph is kept for the result (the weights of a
    # model field require grad)
    with true_fp32(), torch.no_grad():
        return vmap(single)(x)


def _flat(fn: Callable, dims):
    """fn over [1, *dims] as a map [n] -> [n]."""
    n = 1
    for d in dims:
        n *= d
    return lambda xf: fn(xf.reshape((1, *dims))).reshape((n,))


def compute_exterior_derivative(x: torch.Tensor, fn: Callable) -> torch.Tensor:
    """df for a flat field. x: [b, n]; fn maps [n] -> [n] (one element).
    Returns [b, n, n] antisymmetric matrices J - J^T."""
    return _jacobians(fn, x)


def compute_exterior_derivative_nd(x: torch.Tensor, fn: Callable) -> torch.Tensor:
    """df for an arbitrarily shaped field. x: [b, *dims]; fn maps a batch
    [b, *dims] -> [b, *dims] (a model-style score function). Each element
    goes through fn alone as [1, *dims], flattened to n = prod(dims) (the
    reference's `forward_nd`); returns [b, n, n]."""
    return _jacobians(_flat(fn, x.shape[1:]), x.reshape(x.shape[0], -1))


def jacobian_nd(x: torch.Tensor, fn: Callable) -> torch.Tensor:
    """J itself, [b, n, n], for the field of `compute_exterior_derivative_nd`."""
    return _jacobians(_flat(fn, x.shape[1:]), x.reshape(x.shape[0], -1), antisym=False)


def exterior_derivative_magnitude(df: torch.Tensor) -> torch.Tensor:
    """Frobenius norm per batch element (reference `:288-298`)."""
    return torch.sqrt(torch.sum(df**2, dim=tuple(range(1, df.ndim))))


def is_closed(df: torch.Tensor, tol: float = 1e-5) -> torch.Tensor:
    """df == 0 (the field is closed, conservative) per batch element."""
    return exterior_derivative_magnitude(df) < tol


def is_exact(df: torch.Tensor, tol: float = 1e-6) -> bool:
    """All-close-to-zero over the whole batch (on contractible domains exact
    == closed)."""
    return bool(torch.all(torch.abs(df) <= tol))


class ExteriorDerivative:
    """A field fn with its df as a callable, for analysis pipelines (the
    reference's `ExteriorDerivative`). The fn contract follows `flatten` for
    every input rank: flatten=True (default) takes a batched model-style fn
    [b, *dims] -> [b, *dims]; flatten=False a one-element fn [n] -> [n] over
    already flat [b, n] input."""

    def __init__(self, fn: Callable, flatten: bool = True):
        self.fn = fn
        self.flatten = flatten

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.flatten:
            return compute_exterior_derivative_nd(x, self.fn)
        return compute_exterior_derivative(x, self.fn)

    def magnitude(self, x: torch.Tensor) -> torch.Tensor:
        return exterior_derivative_magnitude(self(x))


# --- example fields for tests and demos (reference `:205-285`) -------------


def conservative_field(x: torch.Tensor) -> torch.Tensor:
    """grad of the potential 0.5 ||x||^2: f(x) = x; df vanishes."""
    return x


def rotation_field(x: torch.Tensor) -> torch.Tensor:
    """2-D rotation f(x, y) = (-y, x); df = [[0, -2], [2, 0]], nonzero."""
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1)
