"""Kernel-size (locality scale) calibration.

Counterpart of `convolutional_diffusion_tpu/calibration.py` (the reference's
`scripts/scales_calibration.py`): reverse diffusion driven by the trained
CNN, where at every step each candidate-k analytic score module gives its
estimate and the step's optimal k maximizes the cosine similarity (or
minimizes the L2 distance) to the CNN's implied score -eps / sqrt(beta_t).
All seeds advance together as one batch, so each of the |K| sweeps per step
serves every seed at once.

Conditional calibration draws one label per seed. A module that takes a
label vector (`supports_vector_label`, the ELS module) scores every seed in
one call; the others are called once per label on that label's seeds. Rows
are independent, so the groups are not padded to one shape (the JAX
package pads them to share one compiled shape).

Aggregates: torch.median's LOWER median and torch.mode's smallest most
frequent value, computed in numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .sampling import ddim_step
from .schedules import cosine_noise_schedule
from .scores.base import resolve_device


def lower_median(a: np.ndarray, axis=0) -> np.ndarray:
    """torch.median semantics: the lower of the two middle values."""
    a = np.sort(a, axis=axis)
    return np.take(a, (a.shape[axis] - 1) // 2, axis=axis)


def mode_smallest(a: np.ndarray, axis=0) -> np.ndarray:
    """torch.mode semantics: the most frequent value, the smallest on ties."""
    moved = np.moveaxis(np.asarray(a), axis, 0)
    out = np.empty(moved.shape[1:], moved.dtype)
    for idx in np.ndindex(out.shape):
        vals, counts = np.unique(moved[(slice(None), *idx)], return_counts=True)
        out[idx] = vals[np.argmax(counts)]  # vals ascend: the first max is the smallest
    return out


def _module_estimate(mod, t: float, x, labels, k: int):
    """One candidate module's score for every seed."""
    if labels is None:
        return mod(t, x, k=k)
    if getattr(mod, "supports_vector_label", False):
        return mod(t, x, label=labels, k=k)
    est = torch.empty_like(x)
    for lab in torch.unique(labels).tolist():
        sel = torch.nonzero(labels == lab).reshape(-1)
        est[sel] = mod(t, x[sel], label=lab, k=k).to(x.device)
    return est


@torch.no_grad()
def calibrate(
    model_eps: Callable,  # (t [b], x [b, h, w, c], label [b] or None) -> eps
    score_modules: Dict[int, Callable],  # k -> module(t, x, label=None, k=k)
    *,
    image_size: int,
    in_channels: int,
    nsamps: int = 20,
    nsteps: int = 20,
    conditional: bool = False,
    nlabels: int = 10,
    eval_mode: str = "cos",
    noise_schedule=cosine_noise_schedule,
    generator: Optional[torch.Generator] = None,
    x0=None,
    labels=None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Returns {'k_optimals' [nsamps, nsteps], 'median' [nsteps], 'mode'
    [nsteps]} as int32 numpy arrays, with the reference's index semantics
    (index i - 1 = step i). Runs on `device` (default cuda; without a card
    that is an error), where the CNN and the modules must compute.

    The seeds are N(0, 1) draws from `generator` (a torch.Generator on the
    device; labels uniform in [0, nlabels) when conditional), or `x0`
    [nsamps, h, w, c] (and `labels` [nsamps] when conditional) given."""
    if eval_mode not in ("cos", "l2_dist"):
        raise ValueError(f"eval_mode must be 'cos' or 'l2_dist', got {eval_mode!r}")
    dev = resolve_device(device)
    kernel_sizes = sorted(score_modules)
    if x0 is not None:
        x = torch.as_tensor(x0, dtype=torch.float32).to(dev)
        if x.shape[0] != nsamps:
            raise ValueError(f"x0 batch {x.shape[0]} != nsamps {nsamps}")
        if conditional and labels is None:
            raise ValueError("conditional calibration with x0 needs labels")
        labels = torch.as_tensor(labels).to(dev, torch.long) if conditional else None
    else:
        if generator is None:
            raise ValueError("need a torch.Generator or explicit x0 seeds")
        x = torch.randn((nsamps, image_size, image_size, in_channels),
                        generator=generator, device=generator.device).to(dev)
        labels = (torch.randint(0, nlabels, (nsamps,), generator=generator,
                                device=generator.device).to(dev)
                  if conditional else None)

    k_optimals = np.zeros((nsamps, nsteps), np.int32)
    ks = torch.tensor(kernel_sizes, device=dev)
    for i in range(nsteps, 0, -1):
        t = torch.full((nsamps,), i / nsteps, dtype=torch.float32)
        beta_t = noise_schedule(t).to(dev)
        eps = model_eps(t.to(dev), x, labels)
        flat_c = (-eps / torch.sqrt(beta_t)[:, None, None, None]).reshape(nsamps, -1)
        metrics = []  # [K, nsamps]
        for k in kernel_sizes:
            flat_k = _module_estimate(score_modules[k], float(i / nsteps), x, labels,
                                      k).to(dev).reshape(nsamps, -1)
            if eval_mode == "l2_dist":
                m = -torch.sqrt(torch.sum((flat_c - flat_k) ** 2, dim=1))
            else:
                m = torch.sum(flat_c * flat_k, dim=1) / (
                    torch.linalg.norm(flat_c, dim=1) * torch.linalg.norm(flat_k, dim=1))
            metrics.append(m)
        # argmax takes the first of equal maxima, as jnp.argmax does
        k_optimals[:, i - 1] = ks[torch.argmax(torch.stack(metrics), dim=0)].cpu().numpy()
        # advance x with the CNN's epsilon
        beta_prev = noise_schedule(t - 1.0 / nsteps).to(dev)
        x = ddim_step(x, eps, beta_t, beta_prev)

    return {
        "k_optimals": k_optimals,
        "median": lower_median(k_optimals, axis=0).astype(np.int32),
        "mode": mode_smallest(k_optimals, axis=0).astype(np.int32),
    }
