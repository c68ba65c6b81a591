"""Reverse-diffusion samplers.

Counterpart of `convolutional_diffusion_tpu/sampling.py`, with the same
update rules (the reference's formulas):

 - DDIM, deterministic:
     x <- sqrt(alpha_prev / alpha_t) x
          + (sqrt(beta_prev) - sqrt(alpha_prev / alpha_t) sqrt(beta_t)) eps
 - DDPM, ancestral:
     sigma_t = sqrt(beta_prev / beta_t) sqrt(1 - alpha_t / alpha_prev)
     x <- sqrt(alpha_prev) (x - sqrt(beta_t) eps) / sqrt(alpha_t)
          + sqrt(1 - alpha_prev - sigma_t^2) eps + sigma_t N(0, 1)

`breakstep` is the reference's early exit: step i runs only while
i > breakstep. The JAX package compiles the loop into one `lax.scan`; here
it is a Python loop under `torch.no_grad()` whose per-step betas are
computed once and put on the device before it starts, so no step waits for
the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

EpsFn = Callable[..., torch.Tensor]  # (t [b], x [b, h, w, c], label) -> eps


def _col(v, x):
    return v.to(x.device)[:, None, None, None]


def ddim_step(x, eps, beta_t, beta_prev):
    """Deterministic DDIM update; beta_t and beta_prev are [b] tensors."""
    alpha_t = 1.0 - beta_t
    alpha_prev = 1.0 - beta_prev
    ratio = torch.sqrt(alpha_prev / alpha_t)
    coef = torch.sqrt(beta_prev) - ratio * torch.sqrt(beta_t)
    return _col(ratio, x) * x + _col(coef, x) * eps


def ddpm_step(x, eps, beta_t, beta_prev, noise):
    """Stochastic ancestral DDPM update with the N(0, 1) draw `noise`;
    beta_t and beta_prev are [b] tensors."""
    alpha_t = 1.0 - beta_t
    alpha_prev = 1.0 - beta_prev
    sigma = torch.sqrt(beta_prev / torch.clamp(beta_t, min=1e-20)) * torch.sqrt(
        torch.clamp(1.0 - alpha_t / alpha_prev, min=0.0))
    mean = (_col(torch.sqrt(alpha_prev), x) * (x - _col(torch.sqrt(beta_t), x) * eps)
            / _col(torch.sqrt(alpha_t), x))
    extra = torch.sqrt(torch.clamp(1.0 - alpha_prev - sigma**2, min=0.0))
    return mean + _col(extra, x) * eps + _col(sigma, x) * noise


def step_betas(noise_schedule, nsteps: int, device):
    """(t, beta_t, beta_prev) of steps i = nsteps .. 1 as [nsteps] float32
    tensors on `device`, computed as the JAX scan computes them
    (t = float32(i) / nsteps, beta_prev = schedule(t - 1 / nsteps)) and moved
    in one copy."""
    t = torch.arange(nsteps, 0, -1, dtype=torch.float32) / nsteps
    out = torch.stack([t, noise_schedule(t), noise_schedule(t - 1.0 / nsteps)])
    return tuple(out.to(device))


@torch.no_grad()
def sample_scan(model: EpsFn, noise_schedule, x, *, nsteps: int, label=None,
                generator: Optional[torch.Generator] = None, ddpm: bool = False,
                breakstep: int = -1, seed_rows: Optional[tuple] = None):
    """Run the reverse loop i = nsteps .. 1 from x ([b, h, w, c] NHWC) on
    x's device. DDPM draws its noise from `generator` (on that device).
    seed_rows = (n, rows): x holds seeds `rows` (a slice) of an n-seed
    batch, and each DDPM step draws the noise of all n and takes those
    rows, so every seed gets the noise it gets in one n-seed call."""
    if ddpm and generator is None:
        raise ValueError("ddpm=True requires a torch.Generator")
    if breakstep > nsteps:
        # the reference's loop never meets an i == breakstep above nsteps,
        # so the full reverse pass runs
        breakstep = -1
    b = x.shape[0]
    ts, betas, prevs = step_betas(noise_schedule, nsteps, x.device)
    for s, i in enumerate(range(nsteps, 0, -1)):
        if i <= breakstep:  # the reference returns before step i == breakstep
            break
        beta_t, beta_prev = betas[s].expand(b), prevs[s].expand(b)
        eps = model(ts[s].expand(b), x, label)
        if ddpm:
            shape = x.shape if seed_rows is None else (seed_rows[0], *x.shape[1:])
            noise = torch.randn(shape, generator=generator, device=x.device,
                                dtype=x.dtype)
            if seed_rows is not None:
                noise = noise[seed_rows[1]]
            x = ddpm_step(x, eps, beta_t, beta_prev, noise)
        else:
            x = ddim_step(x, eps, beta_t, beta_prev)
    return x


def make_sampler(model, *, nsteps: int = 20, ddpm: bool = False):
    """A sampler fn(x, label=None, generator=None, breakstep=-1) over
    `model` (a `models.DiffusionModel`)."""

    def fn(x, label=None, generator=None, breakstep=-1):
        return sample_scan(model, model.noise_schedule, x, nsteps=nsteps, label=label,
                           generator=generator, ddpm=ddpm, breakstep=breakstep)

    return fn


def sample(model, *, batch_size: int = 1, x: Optional[torch.Tensor] = None,
           nsteps: int = 20, label=None, generator: Optional[torch.Generator] = None,
           breakstep: int = -1, ddpm: bool = False, device=None):
    """The reference's `DDIM.sample`. Runs on `device` (default cuda;
    without a card that is an error), where `model` must lie. When x is
    None, draws the N(0, 1) seed [batch_size, imsize, imsize, in_channels]
    from `generator` (a torch.Generator on the device), which DDPM then
    draws its noise from too."""
    from .scores.base import resolve_device  # scores imports this module

    dev = resolve_device(device)
    on = model.device
    if on.type != dev.type or dev.index not in (None, on.index):
        raise ValueError(f"the model lies on {on}, not on {dev}: pass "
                         f"device={on.type!r} or move the model")
    if x is None:
        if generator is None:
            raise ValueError("need a torch.Generator to draw the initial noise")
        x = torch.randn(
            (batch_size, model.default_imsize, model.default_imsize, model.in_channels),
            generator=generator, device=dev)
    else:
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if label is not None:
        label = torch.as_tensor(label).to(dev)
    return sample_scan(model, model.noise_schedule, x, nsteps=nsteps, label=label,
                       generator=generator, ddpm=ddpm, breakstep=breakstep)


def sample_sharded(model, mesh, *, batch_size: int, nsteps: int = 20, label=None,
                   generator: Optional[torch.Generator] = None, ddpm: bool = False):
    """`sample` with the seeds sharded over the mesh's 'data' axis (the JAX package's
    `sample_sharded`): every rank draws the WHOLE batch's initial noise from
    `generator` (the same stream on every rank), takes its slice of the
    seeds (and labels), runs the reverse loop with no collective (DDPM draws
    each step's noise for the whole batch, `seed_rows`), and the slices are
    gathered onto every rank. So seed i is the same image however many
    ranks run, to the backbone's batch-size-dependent rounding. `model` lies
    on the rank's device; batch_size must divide over the axis."""
    n, r = mesh.axis_size("data"), mesh.axis_rank("data")
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} does not divide over the {n} ranks "
                         "of mesh axis 'data'")
    if generator is None:
        raise ValueError("need a torch.Generator to draw the initial noise")
    from .parallel.mesh import all_gather

    dev = model.device
    x = torch.randn((batch_size, model.default_imsize, model.default_imsize,
                     model.in_channels), generator=generator, device=dev)
    rows = slice(r * (batch_size // n), (r + 1) * (batch_size // n))
    if label is not None:
        label = torch.as_tensor(label).to(dev)[rows]
    out = sample_scan(model, model.noise_schedule, x[rows], nsteps=nsteps, label=label,
                      generator=generator, ddpm=ddpm, seed_rows=(batch_size, rows))
    return all_gather(out, mesh.group("data"))


def q_sample(x0, eps, beta_t):
    """Forward noising x_t = sqrt(1 - beta) x0 + sqrt(beta) eps, beta_t [b]."""
    return _col(torch.sqrt(1.0 - beta_t), x0) * x0 + _col(torch.sqrt(beta_t), x0) * eps
