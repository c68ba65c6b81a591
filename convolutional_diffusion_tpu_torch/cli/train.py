"""DDPM training CLI. Counterpart of `convolutional_diffusion_tpu/cli/train.py`
(the reference's `scripts/training_script.py`), with the same flags,
defaults and recipe. Runs on cuda; --cpu runs on the CPU instead.
--ndevices N (0, the default: every visible card) trains data-parallel over
N ranks (`training.train_diffusion(mesh=...)`): under `torchrun
--nproc_per_node N` the run joins that group; outside one it starts N ranks
itself (one per card, or gloo ranks on the CPU with --cpu). Checkpoints go
to `<homedir>/<name>/step_N/checkpoint.pt` (`utils.checkpoint`), written by
rank 0.

Example (the README's CIFAR10 recipe):
    python -m convolutional_diffusion_tpu_torch.cli.train --epochs 300 \\
        --dataset cifar10 --conditional --mode zeros --layers 8 --resnet
"""

import argparse
import os


def parse_train_args(argv, *, description: str, batchsize: int, dataset, mode: str,
                     layers: int, homedir: str):
    """The flags both train CLIs share, parsed; the defaults that differ are
    arguments."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--batchsize", type=int, default=batchsize)
    parser.add_argument("--dataset", type=str, default=dataset)
    parser.add_argument("--lr", type=float, default=0.0001)
    parser.add_argument("--conditional", action="store_true", default=False)
    parser.add_argument("--mode", type=str, default=mode)
    parser.add_argument("--wd", type=float, default=0)
    parser.add_argument("--mult", type=int, default=2)
    parser.add_argument("--nonorm", action="store_true", default=True)
    parser.add_argument("--saveinterval", type=int, default=5)
    parser.add_argument("--layers", type=int, default=layers)
    parser.add_argument("--resnet", action="store_true", default=False)
    parser.add_argument("--homedir", type=str, default=homedir)
    parser.add_argument("--suppress", action="store_true", default=False)
    parser.add_argument("--gamma", type=float, default=0.999965)
    parser.add_argument("--maxsamps", type=int, default=100000)
    parser.add_argument("--dataroot", type=str, default="./data")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ndevices", type=int, default=0,
                        help="ranks to train data-parallel over (0: every visible "
                             "card; gloo ranks with --cpu)")
    parser.add_argument("--export_torch", type=str, default=None,
                        help="also export the trained weights as a torch state_dict "
                             ".pt, loadable by the reference via "
                             "backbone.load_state_dict(torch.load(path))")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU instead of cuda")
    return parser.parse_args(argv)


def subset(ds, maxsamps: int):
    """--maxsamps: (dataset, subset_flag, factor). A subset multiplies the
    epochs and the save interval by num_samples // maxsamps (reference
    training_script.py:38-42, 96, 102)."""
    if maxsamps >= ds.num_samples:
        return ds, False, 1
    factor = ds.num_samples // maxsamps
    return type(ds)(ds.images[:maxsamps], ds.labels[:maxsamps]), True, factor


def run(args, backbone, ds, factor: int, ckpt_dir: str, imsize: int):
    """Train `backbone` on `ds` with the recipe of `args` (data-parallel over
    the joined group's ranks), save the final checkpoint (step epochs * (N //
    batch)) and, with --export_torch, the state_dict (rank 0). Returns the
    TrainState."""
    from ..models import DiffusionModel
    from ..parallel.mesh import barrier, is_writer
    from ..schedules import cosine_noise_schedule
    from ..scores.base import resolve_device
    from ..training import TrainConfig, train_diffusion
    from ..utils.checkpoint import save_checkpoint
    from .common import cli_mesh, export_torch_state_dict, model_config_meta

    mesh = cli_mesh(args.cpu)
    dev = mesh.device if mesh is not None else resolve_device("cpu" if args.cpu else None)
    channels = ds.images.shape[-1]
    model = DiffusionModel(backbone, noise_schedule=cosine_noise_schedule,
                           in_channels=channels, default_imsize=imsize, seed=args.seed,
                           device=dev)
    config = TrainConfig(
        epochs=args.epochs * factor, batch_size=args.batchsize, lr=args.lr,
        weight_decay=args.wd, gamma=args.gamma, max_t=1000,
        save_interval=args.saveinterval * factor, seed=args.seed,
    )
    log = (lambda s: None) if args.suppress or not is_writer() else print
    meta_cfg = {"model_config": model_config_meta(backbone, channels, imsize)}
    state, _ = train_diffusion(
        model, (ds.images, ds.labels), config, conditional=args.conditional, mesh=mesh,
        checkpoint_dir=ckpt_dir, checkpoint_extra=meta_cfg, log_fn=log,
    )
    if is_writer():
        save_checkpoint(ckpt_dir, **state.payload(),
                        step=config.epochs * (ds.num_samples // config.batch_size),
                        extra=meta_cfg)
        log(f"saved final checkpoint under {ckpt_dir}")
        if args.export_torch:
            export_torch_state_dict(model.backbone, path=args.export_torch, log=log)
    barrier()
    return state


def main(argv=None):
    args = parse_train_args(argv, description="DDIM training", batchsize=128,
                            dataset=None, mode="circular", layers=3,
                            homedir="./model_checkpoints")
    from .common import spawn_ranks

    spawned, result = spawn_ranks(__spec__.name, argv, args.ndevices, cpu=args.cpu,
                                  zero_is_all=True)
    if spawned:
        return result

    from ..data import get_dataset
    from .common import build_backbone_from_flags, checkpoint_name_from_flags

    ds, metadata = get_dataset(args.dataset, root=args.dataroot)
    ds, subset_flag, factor = subset(ds, args.maxsamps)
    backbone = build_backbone_from_flags(
        metadata, resnet=args.resnet, mode=args.mode, mult=args.mult,
        layers=args.layers, conditional=args.conditional, nonorm=args.nonorm,
    )
    fname = checkpoint_name_from_flags(metadata, args, subset_flag)
    return run(args, backbone, ds, factor, os.path.join(args.homedir, fname),
               metadata["image_size"])


if __name__ == "__main__":
    main()
