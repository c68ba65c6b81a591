"""ScheduledScoreMachine: reverse diffusion driven by an analytic score
module with a calibrated per-timestep kernel-size schedule.

Counterpart of `convolutional_diffusion_tpu/scores/machine.py`, with the
same semantics:
 - the loop runs i = nsteps-1 .. 1 (nsteps-1 updates);
 - per step k = scales[i]; with scales given, nsteps defaults to len(scales);
 - a score backbone (`score_backbone=True`, the analytic modules) returns
   the score, which becomes epsilon as eps = -sqrt(beta_t) * score; with
   `score_backbone=False` the backbone's output is epsilon as it is;
 - `visualize_fn(i, imputed_x0)` is called at each step with the denoised
   estimate (x - sqrt(beta_t) eps) / sqrt(1 - beta_t);
 - the update is the deterministic DDIM step;
 - each step's score call is the named range `machine_step_k{k}`
   (`utils.profiling.annotate`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..sampling import ddim_step
from ..schedules import cosine_noise_schedule
from ..utils.profiling import annotate


class ScheduledScoreMachine:
    def __init__(
        self,
        backbone,
        *,
        in_channels: int = 3,
        imsize: int = 32,
        default_time_steps: int = 20,
        noise_schedule: Callable = cosine_noise_schedule,
        score_backbone: bool = True,
        scales: Optional[Sequence[int]] = None,
        **_unused,
    ):
        self.backbone = backbone
        self.in_channels = in_channels
        self.imsize = imsize
        self.default_time_steps = default_time_steps
        self.noise_schedule = noise_schedule
        self.score_backbone = score_backbone
        self.scales = list(scales) if scales is not None else None

    @property
    def device(self) -> torch.device:
        return self.backbone.device

    @torch.no_grad()
    def __call__(self, x, nsteps=None, label=None, collect_trajectory=False,
                 visualize_fn=None):
        """Run the reverse loop from x (NHWC [b, h, w, c]) on the backbone's
        device; returns the sample (and, with collect_trajectory, the list of
        states after each update). visualize_fn, if given, receives
        (step i, imputed x0) at each step."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if nsteps is None:
            nsteps = (
                self.default_time_steps if self.scales is None else len(self.scales)
            )
        b = x.shape[0]
        trajectory = []
        for i in range(nsteps - 1, 0, -1):
            t = torch.tensor(i, dtype=torch.float32) / nsteps
            beta_t = self.noise_schedule(t)
            k = None if self.scales is None else self.scales[i]
            with annotate(f"machine_step_k{k}"):
                out = self.backbone(t, x, label=label, k=k)
            eps = out * (-torch.sqrt(beta_t)) if self.score_backbone else out
            if visualize_fn is not None:
                visualize_fn(i, (x - eps * torch.sqrt(beta_t)) / torch.sqrt(1.0 - beta_t))
            beta_prev = self.noise_schedule(t - 1.0 / nsteps)
            x = ddim_step(x, eps, beta_t.expand(b), beta_prev.expand(b))
            if collect_trajectory:
                trajectory.append(x)
        if collect_trajectory:
            return x, trajectory
        return x

    def sample(self, nsteps=None, label=None, generator=None, batch_size: int = 1):
        """Draw N(0, 1) seeds with `generator` (required) and run the
        machine."""
        if generator is None:
            raise ValueError("need a torch.Generator to draw the seeds")
        x = torch.randn(
            (batch_size, self.imsize, self.imsize, self.in_channels),
            generator=generator, device=generator.device,
        )
        return self(x, nsteps=nsteps, label=label)
