"""Epsilon-prediction DDPM training.

Counterpart of `convolutional_diffusion_tpu/training.py`, with the same
optimisation semantics (the reference's `src/utils/train.py`):
 - AdamW(lr, betas (0.9, 0.999), eps 1e-8, weight_decay) with an
   exponential LR decay stepped once per batch (optax's
   `exponential_decay(transition_steps=1)` there, `ExponentialLR` here);
 - per-sample t = randint(0, max_t) / max_t, x_t = sqrt(1 - beta) x +
   sqrt(beta) eps, loss = mean((eps_hat - eps)^2).

Here the `DiffusionModel` holds its weights and is trained in place, so the
JAX package's `params` argument goes away. A step runs its forward AND its
backward inside the backbone's precision scope (`models.layers
.precision_scope`): cuDNN reads the TF32 flags when autograd runs the
backward, after the forward's own scope has closed, so at 'highest' the
gradient convolutions would otherwise run in TF32. The dataset lives on the
model's device; each epoch's batch order is JAX's,
`np.random.RandomState(seed).permutation(n)`, uploaded once per epoch; t and
eps are drawn from a `torch.Generator` on the device (not JAX's PRNG
stream), and nothing is read back to the host between log steps.

Data-parallel training (`train_diffusion(mesh=...)`, one process per
device, `parallel.mesh`): the parameters start as rank 0's (broadcast), and
every rank draws the GLOBAL batch's permutation, t and eps from the same
streams, then takes its slice of the batch; BatchNorm takes the global
batch's statistics (`models.layers.batch_statistics_over`), and the
gradients are averaged over the 'data' axis with one all-reduce over a flat
buffer before each rank's identical AdamW step. A ragged tail batch
(`drop_last=False`) runs whole on every rank, as JAX replicates it. So a DP
step equals a one-process step over the whole batch, to the reduction
order. Only rank 0 writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .models.ddim import DiffusionModel
from .models.layers import batch_statistics_over, precision_scope
from .parallel.mesh import all_reduce, barrier, is_writer, replicate, shard_batch
from .sampling import q_sample


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 128
    lr: float = 1e-4
    weight_decay: float = 0.0
    gamma: float = 0.99995  # per-batch LR decay (reference train.py:15)
    max_t: int = 1000
    save_interval: int = 10
    seed: int = 0
    log_every: int = 50
    drop_last: bool = True  # as the JAX package; the reference keeps ragged tails


def make_optimizer(params, config: TrainConfig):
    """(AdamW, ExponentialLR) over `params`: the reference's optimizer and
    its per-batch schedule, the JAX package's optax `adamw` with an
    `exponential_decay(transition_steps=1)` learning rate. AdamW runs
    PyTorch's fused implementation (one multi-tensor kernel per step on
    the card, the same formula on the CPU)."""
    optimizer = torch.optim.AdamW(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=config.weight_decay, fused=True)
    return optimizer, torch.optim.lr_scheduler.ExponentialLR(optimizer, gamma=config.gamma)


def _numpy_rng_state(rng: np.random.RandomState) -> dict:
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "gauss": float(gauss)}


def _set_numpy_rng_state(rng: np.random.RandomState, s: dict) -> None:
    rng.set_state(("MT19937", s["keys"].numpy().astype(np.uint32), s["pos"],
                   s["has_gauss"], s["gauss"]))


class TrainState:
    """What training updates: the model (its parameters and BatchNorm
    statistics, in place), its AdamW optimizer and ExponentialLR schedule,
    the step count, and the two random streams (the batch order's
    RandomState and the noise's torch.Generator). Counterpart of the JAX
    (params, opt_state, step)."""

    def __init__(self, model: DiffusionModel, config: TrainConfig, step: int = 0):
        self.model = model
        self.optimizer, self.scheduler = make_optimizer(model.backbone.parameters(), config)
        self.step = step
        self.rng = np.random.RandomState(config.seed)
        self.generator = torch.Generator(device=model.device).manual_seed(config.seed)

    def payload(self) -> dict:
        """The keywords of `utils.checkpoint.save_checkpoint` that hold it."""
        return dict(params=self.model.backbone.state_dict(),
                    opt_state=self.optimizer.state_dict(),
                    sched=self.scheduler.state_dict(),
                    rng={"numpy": _numpy_rng_state(self.rng),
                         "torch": self.generator.get_state()})

    def load(self, blob: dict) -> None:
        """Restore from a `restore_checkpoint` blob: weights, AdamW moments,
        the schedule's position, the step and, where the checkpoint holds
        them, the random streams (so a resumed run continues an unbroken
        one; the JAX package restarts its streams from the seed)."""
        state = blob["state"]
        self.model.backbone.load_state_dict(state["params"])
        if "opt_state" in state:
            self.optimizer.load_state_dict(state["opt_state"])
        if "sched" in state:
            self.scheduler.load_state_dict(state["sched"])
        if "rng" in state:
            _set_numpy_rng_state(self.rng, state["rng"]["numpy"])
            self.generator.set_state(state["rng"]["torch"])
        self.step = int(blob.get("meta", {}).get("step", 0))


def draw_noise(images: torch.Tensor, generator: torch.Generator, max_t: int):
    """(t [b], eps like images) as the JAX step draws them: t =
    randint(0, max_t) / max_t, eps ~ N(0, 1); from `generator`, on the
    images' device."""
    b = images.shape[0]
    t = torch.randint(0, max_t, (b,), generator=generator,
                      device=images.device).to(torch.float32) / max_t
    eps = torch.randn(images.shape, generator=generator, device=images.device,
                      dtype=images.dtype)
    return t, eps


def average_gradients(params, mesh) -> None:
    """Average the parameters' gradients over the mesh's 'data' axis in place: one
    all-reduce over a flat buffer of every gradient (parameters without
    one, the same on every rank, are left out)."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), "sum", mesh.group("data"))
    flat /= mesh.axis_size("data")
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def step_with_noise(state: TrainState, images, labels, t, eps, *,
                    conditional: bool = False, mesh=None) -> torch.Tensor:
    """One train step from given t and eps: the loss's forward and backward
    in the backbone's precision scope, then AdamW and the schedule's step.
    The model runs in train() mode for the step (BatchNorm updates its
    running statistics from the batch) and is put back in the mode it was
    in. Returns the loss as a 0-d tensor on the device (not read back);
    the gradients stay in the parameters' `.grad`.

    With `mesh`, images, labels, t and eps are the global batch's: a batch
    that divides over the 'data' axis is cut to this rank's slice, with
    BatchNorm statistics over the axis's group (a ragged one runs whole),
    and the gradients are averaged over the axis before AdamW. The loss returned is
    this rank's (`global_loss` averages it)."""
    model, optimizer = state.model, state.optimizer
    group = None
    if mesh is not None and images.shape[0] % mesh.axis_size("data") == 0:
        images, labels, t, eps = shard_batch((images, labels, t, eps), mesh)
        group = mesh.group("data")
    was_training = model.training
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with precision_scope(model.backbone.precision), \
            batch_statistics_over(model.backbone, group):
        x_noised = q_sample(images, eps, model.noise_schedule(t))
        pred = model(t, x_noised, labels if conditional else None)
        loss = torch.mean((pred - eps) ** 2)
        loss.backward()
    if mesh is not None:
        average_gradients(model.backbone.parameters(), mesh)
    optimizer.step()
    state.scheduler.step()
    model.train(was_training)
    state.step += 1
    return loss.detach()


def global_loss(loss: torch.Tensor, mesh=None) -> torch.Tensor:
    """A step's loss over the whole batch: the ranks' slice losses
    averaged over the mesh's 'data' axis (their slices are equal; a ragged tail's
    loss is the same on every rank); the loss itself without a mesh."""
    if mesh is None:
        return loss
    return all_reduce(loss.clone(), "sum", mesh.group("data")) / mesh.axis_size("data")


def make_train_step(state: TrainState, *, max_t: int = 1000, conditional: bool = False,
                    mesh=None):
    """The train step: (images, labels) -> loss (a 0-d device tensor), t and
    eps drawn from `state.generator`. With BatchNorm in the backbone its
    running statistics update (the unbiased batch variance at momentum
    0.1, which the JAX package's `TorchBatchNorm` reproduces). With `mesh`
    the step is data-parallel (`step_with_noise`): t and eps are drawn for
    the whole batch on every rank, the same draws as one process's."""

    def train_step(images, labels):
        t, eps = draw_noise(images, state.generator, max_t)
        return step_with_noise(state, images, labels, t, eps, conditional=conditional,
                               mesh=mesh)

    return train_step


def _not_ported(use_native_loader, native_loader):
    if use_native_loader or native_loader is not None:
        raise NotImplementedError(
            "the native C++ loader is not ported yet (ROADMAP §1 item 3, "
            "utils/native_loader.py); pass the dataset as arrays")


def train_diffusion(
    model: DiffusionModel,
    dataset,  # (images [N, h, w, c], labels [N]) numpy or tensors
    config: TrainConfig = TrainConfig(),
    *,
    conditional: bool = False,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_extra: Optional[dict] = None,
    use_native_loader: bool = False,
    native_loader=None,
    resume_from: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
):
    """Full training loop on the model's device; trains `model` in place.
    Returns (TrainState, history): history holds each epoch's mean of the
    losses read at log steps (the last loss where an epoch has none). A
    checkpoint goes to `checkpoint_dir` every `save_interval` epochs;
    `resume_from` restores weights, AdamW moments, the schedule's position,
    the step and the random streams (on every rank), and runs
    `config.epochs` more epochs. `mesh` (a `parallel.make_mesh` mesh with a
    'data' axis, the model on the mesh's device) trains data-parallel: the
    batch size must divide over the axis, every rank holds the dataset, and
    only rank 0 writes checkpoints while the others wait.
    `use_native_loader` and `native_loader` are not ported yet and raise."""
    _not_ported(use_native_loader, native_loader)
    if mesh is not None:
        if config.batch_size % mesh.axis_size("data"):
            raise ValueError(
                f"batch_size={config.batch_size} must divide over the "
                f"{mesh.axis_size('data')} ranks of the mesh's 'data' axis")
        replicate(model.backbone, mesh)
    dev = model.device
    images = torch.as_tensor(dataset[0], dtype=torch.float32, device=dev)
    labels = torch.as_tensor(dataset[1], device=dev).long()
    n = images.shape[0]
    bs = config.batch_size
    steps_per_epoch = n // bs if config.drop_last else -(-n // bs)
    if steps_per_epoch == 0:
        raise ValueError(
            f"dataset of {n} samples is smaller than batch_size={bs} with "
            "drop_last=True — lower batch_size or pass drop_last=False"
        )
    state = TrainState(model, config)
    if resume_from is not None:
        from .utils.checkpoint import restore_checkpoint

        state.load(restore_checkpoint(resume_from))
        log_fn(f"resumed from {resume_from} at step {state.step}")
    train_step = make_train_step(state, max_t=config.max_t, conditional=conditional,
                                 mesh=mesh)
    history = []
    for epoch in range(config.epochs):
        perm = torch.from_numpy(state.rng.permutation(n))
        # one upload per epoch; from pinned memory it does not wait for the card
        perm = perm.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else perm
        epoch_losses = []
        t0 = time.time()
        for i in range(steps_per_epoch):
            idx = perm[i * bs: (i + 1) * bs]
            loss = train_step(images[idx], labels[idx])
            if state.step % config.log_every == 0:
                epoch_losses.append(float(global_loss(loss, mesh)))
        mean_loss = (float(np.mean(epoch_losses)) if epoch_losses
                     else float(global_loss(loss, mesh)))
        dt = time.time() - t0
        history.append(mean_loss)
        log_fn(
            f"epoch {epoch + 1}/{config.epochs} loss={mean_loss:.5f} "
            f"({steps_per_epoch / max(dt, 1e-9):.1f} steps/s)"
        )
        if checkpoint_dir and (epoch + 1) % config.save_interval == 0:
            from .utils.checkpoint import save_checkpoint

            if is_writer():
                save_checkpoint(checkpoint_dir, **state.payload(), step=state.step,
                                epoch=epoch + 1, extra=checkpoint_extra)
            barrier()
    return state, history
