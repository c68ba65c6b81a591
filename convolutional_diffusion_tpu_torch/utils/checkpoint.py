"""Resumable checkpoints: weights, optimizer state, schedule and step.

Counterpart of `convolutional_diffusion_tpu/utils/checkpoint.py`. A
checkpoint is one `torch.save` file, `directory/step_{N}/checkpoint.pt`,
holding

    {"state": {"params": the backbone's state_dict (the reference's layout),
               "opt_state": AdamW's state_dict, "sched": ExponentialLR's,
               "rng": the random streams},
     "meta": {"step": N, "epoch": ..., "model_config": ..., ...}}

(each part of "state" but "params" optional). A save writes a temporary
`step_{N}.tmp-<pid>` directory and moves it into place with `os.replace`,
so an interrupted save leaves no `step_{N}` behind. The JAX package's Orbax
directories are not read: Orbax is a JAX library, absent where the port
runs; `convert.adamw_state_from_jax` carries a JAX run's optimizer state
across instead. Filenames keep the reference's `backbone_{DS}_{Model}_{mode}
[_conditional]` convention (`reference_checkpoint_name`).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "reference_checkpoint_name",
           "CHECKPOINT_FILE"]

CHECKPOINT_FILE = "checkpoint.pt"


def save_checkpoint(directory: str, *, params, opt_state=None, sched=None, rng=None,
                    step: int = 0, epoch: Optional[int] = None,
                    extra: Optional[Dict] = None) -> str:
    """Save a checkpoint under `directory/step_{step}` (replacing one of the
    same step) and return that path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}")
    state = {"params": params}
    for name, part in (("opt_state", opt_state), ("sched", sched), ("rng", rng)):
        if part is not None:
            state[name] = part
    meta = {"step": step}
    if epoch is not None:
        meta["epoch"] = epoch
    if extra:
        meta.update(extra)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"state": state, "meta": meta}, os.path.join(tmp, CHECKPOINT_FILE))
    if os.path.isdir(path):  # os.replace cannot replace a non-empty directory
        old = f"{path}.old-{os.getpid()}"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    return path


def _step_num(name: str) -> Optional[int]:
    """N of `step_N`; None for anything else (temporary and old entries)."""
    head, _, num = name.partition("_")
    return int(num) if head == "step" and num.isdigit() else None


def restore_checkpoint(path: str) -> dict:
    """{"state": {...}, "meta": {...}} from `path`: a `step_N` directory, or
    a directory holding `step_*` ones (the latest numeric step is taken;
    other entries are skipped). Tensors load on the CPU."""
    path = os.path.abspath(path)
    if _step_num(os.path.basename(path)) is None and os.path.isdir(path):
        steps = [d for d in os.listdir(path) if _step_num(d) is not None]
        if steps:
            path = os.path.join(path, max(steps, key=_step_num))
    file = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.isfile(file):
        raise ValueError(
            f"{path} holds no {CHECKPOINT_FILE} (this package's checkpoint); the JAX "
            "package's Orbax directories are not read"
        )
    return torch.load(file, map_location="cpu", weights_only=True)


def reference_checkpoint_name(
    dataset: str, model: str, mode: str, *, conditional: bool = False,
    suffix: str = "",
) -> str:
    """`backbone_{DS}_{Model}_{mode}[_conditional]{suffix}`: the reference's
    artifact naming convention (training_script.py:47-61)."""
    name = f"backbone_{dataset}_{model}_{mode}"
    if conditional:
        name += "_conditional"
    return name + suffix
