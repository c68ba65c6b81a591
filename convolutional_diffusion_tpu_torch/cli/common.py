"""Shared CLI helpers. Counterpart of `convolutional_diffusion_tpu/cli/common.py`:
the score-module factory, backbone construction from the training flags,
checkpoint names and architecture metadata, model loading from reference
`.pt` pickles and from this package's checkpoint directories, and the torch
state_dict export."""

from __future__ import annotations

import importlib
import json
import os
import sys
from typing import Optional

import numpy as np
import torch


def build_backbone_from_flags(metadata, *, resnet: bool, mode: str, mult: int,
                              layers: int, conditional: bool, nonorm: bool,
                              precision="highest"):
    """The reference training script's construction: a ResNet of emb_dim
    128 * mult and lastksize 3, or a UNet of fsizes [mult * 32 * 2^i for i
    in range(layers)] and lastksize 3; GroupNorm unless nonorm."""
    from ..models import MinimalResNet, MinimalUNet

    normal = None if nonorm else "GroupNorm"
    common = dict(channels=metadata["num_channels"], mode=mode, conditional=conditional,
                  num_classes=metadata["num_classes"], normalization=normal,
                  lastksize=3, precision=precision)
    if resnet:
        return MinimalResNet(emb_dim=128 * mult, kernel_size=3, num_layers=layers, **common)
    return MinimalUNet(fsizes=tuple(mult * 32 * (2**i) for i in range(layers)), **common)


def checkpoint_name_from_flags(metadata, args, subset_flag: bool) -> str:
    """The reference's auto-generated checkpoint filename
    (scripts/training_script.py:46-61)."""
    fname = "MinimalResNet_" if args.resnet else "MinimalUNet_"
    fname += (
        metadata["name"]
        + f"_{args.mode}_lr_{args.lr}_batchsize_{args.batchsize}_wd_{args.wd}"
    )
    if subset_flag:
        fname += f"_maxsamps_{args.maxsamps}"
    if args.conditional:
        fname += "_conditional"
    if args.nonorm:
        fname += "_nonorm"
    if args.mult != 1:
        fname += f"_mult_{args.mult}"
    return fname


def load_model(path: str, device=None):
    """A trained `models.DiffusionModel` on `device` (default cuda; without
    a card that is an error), in eval() mode, from a reference `.pt` whole
    pickle or from one of this package's checkpoint directories (a
    `step_N` directory or the directory holding them: the latest step),
    which store the architecture in their metadata. The JAX package's Orbax
    directories are not read."""
    from ..convert import diffusion_model_from_torch_pickle
    from ..models import DiffusionModel, MinimalResNet, MinimalUNet
    from ..schedules import cosine_noise_schedule
    from ..scores.base import resolve_device
    from ..utils.checkpoint import restore_checkpoint

    dev = resolve_device(device)
    if not os.path.isdir(path):
        if not path.endswith(".pt"):
            raise ValueError(f"{path}: expected a reference .pt whole pickle or a "
                             "checkpoint directory")
        return diffusion_model_from_torch_pickle(path, device=dev)
    blob = restore_checkpoint(path)
    cfg = blob.get("meta", {}).get("model_config")
    if cfg is None:
        raise ValueError(f"{path} has no model_config metadata; re-save with cli.train or "
                         "pass a reference .pt file")
    cfg = json.loads(cfg) if isinstance(cfg, str) else dict(cfg)
    kind = cfg.pop("kind")
    in_channels = cfg.pop("in_channels")
    imsize = cfg.pop("default_imsize")
    net = MinimalResNet(**cfg) if kind == "MinimalResNet" else MinimalUNet(**cfg)
    model = DiffusionModel(net, noise_schedule=cosine_noise_schedule,
                           in_channels=in_channels, default_imsize=imsize, device=dev)
    model.backbone.load_state_dict(blob["state"]["params"], strict=True)
    return model


def model_config_meta(backbone, in_channels: int, imsize: int) -> str:
    """The architecture as checkpoint metadata (JSON), as the JAX package
    writes it."""
    from ..models import MinimalResNet

    if isinstance(backbone, MinimalResNet):
        cfg = dict(
            kind="MinimalResNet",
            channels=backbone.channels,
            emb_dim=backbone.emb_dim,
            mode=backbone.mode,
            normalization=backbone.normalization,
            conditional=backbone.conditional,
            num_classes=backbone.num_classes,
            kernel_size=backbone.kernel_size,
            num_layers=backbone.num_layers,
            lastksize=backbone.lastksize,
            add_one=backbone.add_one,
        )
    else:
        cfg = dict(
            kind="MinimalUNet",
            channels=backbone.channels,
            fsizes=list(backbone.fsizes) if backbone.fsizes else None,
            mode=backbone.mode,
            conditional=backbone.conditional,
            num_classes=backbone.num_classes,
            emb_dim=backbone.emb_dim,
            normalization=backbone.normalization,
            last_norm=backbone.last_norm,
            kernel_size=backbone.kernel_size,
            lastksize=backbone.lastksize,
        )
    cfg["in_channels"] = in_channels
    cfg["default_imsize"] = imsize
    return json.dumps(cfg)


def export_torch_state_dict(backbone, *, path: str, log=print):
    """Save the trained backbone's weights as a reference-loadable torch
    state_dict (`backbone.load_state_dict(torch.load(path))` in the
    reference). The port's backbones keep the reference's layout, so this
    is their own state_dict, on the CPU."""
    torch.save({k: v.detach().cpu() for k, v in backbone.state_dict().items()}, path)
    log(f"exported torch state_dict to {path}")


def build_score_module(kind: str, dataset_tuple, *, batch_size: int,
                       image_size: int, channels: int, schedule,
                       max_samples: Optional[int] = None, kernel_size: int = 3,
                       precision: str = "highest", shuffle: bool = False,
                       bank_ledger=None, target_block: Optional[int] = None,
                       device=None, mesh=None):
    """Score-module factory matching the reference els_script (and its
    calibration script): kind 'ELS', 'bbELS', 'LS' or 'IS'. `shuffle`
    reaches only the ELS module, as the reference passes --shuffle to it
    alone (LS always shuffles, bbELS and IS do not); max_samples reaches
    only ELS and bbELS, and LS and IS run with batch_size = len(dataset),
    as there. `image_size` and `channels` (the JAX factory's arguments)
    are not needed: the modules read both from the images. `device`
    defaults to cuda (to the mesh's device with `mesh`).

    mesh: a `parallel.make_mesh` mesh with a 'data' axis shards the training
    set over its ranks (every kind; `parallel.sharded_score`); each rank
    holds its shard, and `bank_ledger` is that rank's."""
    from ..scores import (
        IdealScoreModule,
        LocalEquivBordersScoreModule,
        LocalEquivScoreModule,
        LocalScoreModule,
    )

    classes = {"ELS": LocalEquivScoreModule, "bbELS": LocalEquivBordersScoreModule,
               "LS": LocalScoreModule, "IS": IdealScoreModule}
    common = dict(schedule=schedule, precision=precision)
    if device is not None:
        common["device"] = device
    if mesh is not None:
        from ..parallel.sharded_score import (
            ShardedIdealScoreModule,
            ShardedLocalEquivBordersScoreModule,
            ShardedLocalEquivScoreModule,
            ShardedLocalScoreModule,
        )

        classes = {"ELS": ShardedLocalEquivScoreModule,
                   "bbELS": ShardedLocalEquivBordersScoreModule,
                   "LS": ShardedLocalScoreModule, "IS": ShardedIdealScoreModule}
        common["mesh"] = mesh
    del image_size, channels
    n = len(dataset_tuple[0])
    blk = {} if target_block is None else {"target_block": target_block}
    if kind == "ELS":
        return classes["ELS"](
            dataset_tuple, kernel_size=kernel_size, batch_size=batch_size,
            max_samples=max_samples, shuffle=shuffle, bank_ledger=bank_ledger,
            **blk, **common,
        )
    if kind == "bbELS":
        return classes["bbELS"](
            dataset_tuple, kernel_size=kernel_size, batch_size=batch_size,
            max_samples=max_samples, bank_ledger=bank_ledger, **blk, **common,
        )
    # max_samples below n would FILTER-exclude the single batch of LS/IS
    # (all-zero weights, NaN scores), so the reference never passes it
    if kind == "LS":
        return classes["LS"](
            dataset_tuple, kernel_size=kernel_size, batch_size=n, **common,
        )
    if kind == "IS":
        return classes["IS"](dataset_tuple, batch_size=n, **common)
    raise ValueError(f"Unknown scoremoduletype: {kind}")


def spawn_ranks(module: str, argv, ndevices: int, *, cpu: bool, zero_is_all: bool,
                batch: Optional[int] = None) -> tuple:
    """(True, rank 0's result) after running the CLI `module` (`main(argv)`)
    on the ranks `--ndevices` asks this run to start itself, or (False,
    None) where the run stays in this process. Under a launcher
    (`torchrun`) the run joins its group (gloo with `cpu`), whose size
    `--ndevices` must match (0 matches where `zero_is_all`). Outside any
    group `--ndevices N > 1` starts N ranks, one per card over NCCL or gloo
    ranks on the CPU with `cpu` (0: every visible card where `zero_is_all`,
    one CPU rank with `cpu`), unless `batch` does not divide over them
    (`cli.sample`'s fallback to one process). Rank 0's result comes back
    where it is a number or an array (None otherwise)."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, spawn

    world = init_distributed("gloo" if cpu else None)
    if dist.is_initialized():
        if not (ndevices == world or (ndevices == 0 and zero_is_all)
                or (world == 1 and ndevices <= 1)):
            raise ValueError(f"--ndevices {ndevices} does not match the launcher's group "
                             f"of {world} ranks")
        return False, None
    n = ndevices or ((1 if cpu else torch.cuda.device_count()) if zero_is_all else 1)
    if n <= 1 or (batch is not None and batch % n):
        return False, None
    argv = list(sys.argv[1:] if argv is None else argv)
    return True, spawn(_run_main, n, module, argv, cpu=cpu)


def cli_mesh(cpu: bool):
    """The 'data' mesh over the joined group (None for one process)."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return make_mesh(device="cpu" if cpu else None)


def _run_main(module: str, argv):
    """`<module>.main(argv)` in a rank `spawn_ranks` started."""
    out = importlib.import_module(module).main(argv)
    return out if isinstance(out, (int, float, np.ndarray)) else None
