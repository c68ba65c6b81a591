"""The parts the reference's score modules share: the noise schedule, the
products at each precision, the window extraction, the per-image weights of
the reference's DataLoader streaming, and a weighted online softmax.

Plain PyTorch; imports nothing of the port. The logits are
(2 a <q, p> - a^2 |p|^2) / (2 beta) in float64, without the per-query
term -|q|^2 / (2 beta), which the softmax cancels; the dots come in float64
from operands rounded as `mode` says:

- 'fp32': the operands as they are (float32 values), summed in float64:
  the 'highest' tier's fp32 dots without their rounding;
- 'bf16x3': the split hi.hi + hi.lo + lo.hi of both operands in bf16
  (round to nearest even), each product exact, summed in float64: the
  'high' tier's function;
- 'tf32': both operands rounded to TF32 (10 mantissa bits, to nearest,
  ties away from zero, as the tensor cores take float32 operands), each
  product exact, summed in float64: the precision below float32, the
  control of a 'highest' configuration. Its value products are rounded so
  too.

The exponentials and the value sums run in float32 against a float64
running maximum; the sums carry in float64.
"""

from __future__ import annotations

import contextlib
import math

import torch

MODES = ("fp32", "bf16x3", "tf32")
CHUNK_ROWS = 65536  # bank rows per block of the reference's sweep


def schedule(t) -> torch.Tensor:
    """The cosine noise schedule beta(t) = 1 - cos(t / 1.008 * pi / 2)^2,
    in float32 (beta(0) = 0 exactly)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return 1.0 - torch.cos(t / 1.008 * math.pi / 2.0) ** 2


def coefficients(t) -> tuple[float, float]:
    """(a, beta) = (sqrt(1 - beta(t)), beta(t)) at a float32 t, a and the
    square root of beta taken in float32 as the machine takes them."""
    beta = schedule(torch.as_tensor(t, dtype=torch.float32).reshape(-1)[0])
    a, b = torch.sqrt(1.0 - beta), torch.sqrt(beta)
    return float(a), float(b) ** 2


@contextlib.contextmanager
def fp32_products():
    """Float32 matrix products stay float32 (no TF32) within the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), as a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16_split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi.double(), lo.double()


def dots(q: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 <q_i, k_j> of float32 q [..., M, d] and k [..., P, d] (a
    shared leading batch), the operands rounded as `mode` says."""
    kt = k.transpose(-1, -2)
    if mode == "fp32":
        return q.double() @ kt.double()
    if mode == "tf32":
        return to_tf32(q).double() @ to_tf32(kt).double()
    if mode == "bf16x3":
        qh, ql = _bf16_split(q)
        kh, kl = _bf16_split(kt)
        return (qh @ (kh + kl)).add_(ql @ kh)  # kh + kl is exact in float64
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """All k x k windows of NHWC x as [n, h-k+1, w-k+1, k*k*c], features in
    (row offset, column offset, channel) order."""
    v = x.unfold(1, k, 1).unfold(2, k, 1)  # [n, h', w', c, k, k]
    return v.permute(0, 1, 2, 4, 5, 3).reshape(*v.shape[:3], -1)


def center(k: int, c: int) -> slice:
    """The features of a window's center pixel."""
    start = ((k // 2) * k + k // 2) * c
    return slice(start, start + c)


def circular_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    _, h, w, _ = x.shape
    rows = torch.arange(-p, h + p, device=x.device) % h
    cols = torch.arange(-p, w + p, device=x.device) % w
    return x[:, rows][:, :, cols]


def zeros_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, p, p, p, p))


def image_weights(labels: torch.Tensor, label, *, batch_size: int, max_samples,
                  cutoff: str, weighting: str, per_image: int = 1) -> torch.Tensor:
    """float64 weight [N] of each image as the reference's DataLoader
    streaming gives it: images in stored order in batches of `batch_size`;
    a batch is used iff its cutoff holds ('unfiltered': the cumulative count
    of images through it is at most max_samples; 'batch_quota': its index
    times batch_size is); an image counts iff it has `label` (any image
    when None); 'mean' weighs each counted image 1 / (counted images of its
    batch x per_image), 'sum' weighs it 1."""
    n = labels.shape[0]
    batch = torch.arange(n, device=labels.device) // batch_size
    nb = int(batch[-1]) + 1
    kept = (torch.ones(n, dtype=torch.float64, device=labels.device) if label is None
            else (labels == int(label)).double())
    sizes = torch.bincount(batch, minlength=nb).double()
    kept_b = torch.zeros(nb, dtype=torch.float64, device=labels.device).index_add_(
        0, batch, kept)
    if max_samples is None:
        used = torch.ones(nb, dtype=torch.bool, device=labels.device)
    elif cutoff == "unfiltered":
        used = torch.cumsum(sizes, 0) <= max_samples
    elif cutoff == "batch_quota":
        used = torch.arange(nb, device=labels.device) * batch_size <= max_samples
    else:
        raise ValueError(f"unknown cutoff {cutoff!r}")
    if weighting == "mean":
        w_b = torch.where(used, 1.0 / torch.clamp(kept_b * per_image, min=1.0), 0.0)
    elif weighting == "sum":
        w_b = used.double()
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    return kept * w_b[batch]


class Posterior:
    """The weighted softmax mean of streamed values for query rows of shape
    `rows` (e.g. [M], or [G, M] for G groups each with its own keys)."""

    def __init__(self, rows, c: int, device):
        self.m = torch.full(rows, -math.inf, dtype=torch.float64, device=device)
        self.s1 = torch.zeros(rows, dtype=torch.float64, device=device)
        self.s2 = torch.zeros((*rows, c), dtype=torch.float64, device=device)

    def add(self, logits: torch.Tensor, w: torch.Tensor, values: torch.Tensor,
            mode: str) -> None:
        """Fold keys with float64 logits [*rows, P] (consumed), positive
        weights w [P] and values [..., P, c] (sharing the leading group
        dims)."""
        m = torch.maximum(self.m, logits.amax(dim=-1))
        e = logits.sub_(m[..., None]).float().exp_().mul_(w.float())
        scale = torch.exp(self.m - m)  # 0 where the state was empty
        if mode == "tf32":
            e, values = to_tf32(e), to_tf32(values)
        with fp32_products():
            s2 = e @ values
        self.s1 = self.s1 * scale + e.sum(dim=-1).double()
        self.s2 = self.s2 * scale[..., None] + s2.double()
        self.m = m

    def mean(self) -> torch.Tensor:
        return (self.s2 / self.s1[..., None]).float()


def logits(q, keys, a: float, beta: float, mode: str) -> torch.Tensor:
    """float64 (2 a <q, p> - a^2 |p|^2) / (2 beta) of queries q [..., M, d]
    against keys [..., P, d]."""
    pn = (keys.double() ** 2).sum(dim=-1)
    out = dots(q, keys, mode).mul_(a / beta)
    return out.sub_(pn.mul_(a * a / (2.0 * beta))[..., None, :])
