"""ELS machine sample generation CLI. Counterpart of
`convolutional_diffusion_tpu/cli/els.py` (the reference's `els_script.py`):
the same flags and defaults, the same <results>/<expname>/{seeds,
<idealname>,labels}/%04d layout, resume and --fill. Runs on cuda; --cpu runs
the plain PyTorch path on the CPU instead. --ndevices N > 1 shards the
training set over N ranks (`parallel.sharded_score`): under `torchrun
--nproc_per_node N` the run joins that group; outside one it starts N ranks
itself (one per card, or gloo ranks on the CPU with --cpu). Rank 0 writes.

Example:
    python -m convolutional_diffusion_tpu_torch.cli.els --dataset cifar10 \\
        --conditional --scoremoduletype ELS --batch 8 --numiters 100
    torchrun --nproc_per_node 4 -m convolutional_diffusion_tpu_torch.cli.els \\
        --dataset cifar10 --scoremoduletype ELS --ndevices 4
"""

import argparse
import os

from ..convert import load_scales


load_scales_any = load_scales  # the JAX CLI's name: .pt, .npy or .json scales


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate_Data")
    parser.add_argument("--expname", type=str, default=None)
    parser.add_argument("--idealname", type=str, default="els_outputs")
    parser.add_argument("--dataset", type=str, default="mnist")
    parser.add_argument("--scoremoduletype", type=str, default="bbELS")
    parser.add_argument("--conditional", action="store_true", default=False)
    parser.add_argument("--scalesfile", type=str, default=None)
    parser.add_argument("--scorebatchsize", type=int, default=256)
    parser.add_argument("--fill", action="store_true", default=False)
    parser.add_argument("--numiters", type=int, default=100)
    parser.add_argument("--nsteps", type=int, default=20)
    parser.add_argument("--nlabels", type=int, default=10)
    parser.add_argument("--force_overwrite", action="store_true", default=False)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU (the kernels' plain PyTorch "
                             "versions) instead of cuda")
    parser.add_argument("--max_samples", type=int, default=100000)
    parser.add_argument("--shuffle", action="store_true", default=False)
    parser.add_argument("--dataroot", type=str, default="./data")
    parser.add_argument("--checkpoints", type=str, default="./checkpoints")
    parser.add_argument("--results", type=str, default="./results")
    parser.add_argument("--batch", type=int, default=1,
                        help="seeds per machine invocation")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fmt", type=str, default="npy", choices=["npy", "pt"])
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["highest", "high", "default"],
                        help="'highest' = fp32 dots (kernel K1); 'high' = "
                             "bf16x3 split dots on the tensor cores (K2); "
                             "'default' = the same dots with a bf16 exp "
                             "(K3/K4)")
    parser.add_argument("--target_block", type=int, default=None,
                        help="patches per sweep chunk (default 65536)")
    parser.add_argument("--ndevices", type=int, default=1,
                        help=">1 shards the training set over that many ranks "
                             "(one per card; gloo ranks with --cpu)")
    args = parser.parse_args(argv)

    from ..parallel.mesh import is_writer
    from .common import cli_mesh, spawn_ranks

    spawned, result = spawn_ranks(__spec__.name, argv, args.ndevices, cpu=args.cpu,
                                  zero_is_all=False)
    if spawned:
        return result
    mesh = cli_mesh(args.cpu)
    log = print if is_writer() else (lambda *a: None)

    from ..data import get_dataset
    from ..pipeline import auto_detect_scales, generate_els_samples
    from ..schedules import cosine_noise_schedule
    from ..scores import ScheduledScoreMachine
    from .common import build_score_module

    ds, metadata = get_dataset(args.dataset, root=args.dataroot)
    in_channels = metadata["num_channels"]
    image_size = metadata["image_size"]

    if args.expname is None:
        expname = f"dataset_{metadata['name']}_option_{args.scoremoduletype}"
        if args.conditional:
            expname += "_conditional"
    else:
        expname = args.expname

    mod = build_score_module(
        args.scoremoduletype,
        (ds.images, ds.labels),
        batch_size=args.scorebatchsize,
        image_size=image_size,
        channels=in_channels,
        schedule=cosine_noise_schedule,
        max_samples=args.max_samples,
        precision=args.precision,
        shuffle=args.shuffle,
        target_block=args.target_block,
        device="cpu" if args.cpu else None,
        mesh=mesh,
    )

    scalesfile = args.scalesfile or auto_detect_scales(
        args.checkpoints, metadata["name"]
    )
    scales = load_scales_any(scalesfile)
    log(f"scales ({scalesfile}): {scales}")

    machine = ScheduledScoreMachine(
        mod,
        in_channels=in_channels,
        imsize=image_size,
        noise_schedule=cosine_noise_schedule,
        scales=scales,
    )

    out_dir = os.path.join(args.results, expname)
    n = generate_els_samples(
        machine,
        out_dir,
        numiters=args.numiters,
        in_channels=in_channels,
        image_size=image_size,
        conditional=args.conditional,
        nlabels=args.nlabels,
        idealname=args.idealname,
        fill=args.fill,
        force_overwrite=args.force_overwrite,
        batch=args.batch,
        fmt=args.fmt,
        seed=args.seed,
        log_fn=log,
        writer=is_writer(),
    )
    log(f"generated {n} samples under {out_dir}")
    return n


if __name__ == "__main__":
    main()
