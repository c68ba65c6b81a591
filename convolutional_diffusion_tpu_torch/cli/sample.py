"""Neural sample generation CLI. Counterpart of
`convolutional_diffusion_tpu/cli/sample.py`, with the same flags: draw
samples from a trained model, save an image grid (PNG) and, with
--save_arrays, one [1, h, w, c] .npy per sample. Runs on cuda; --cpu runs
on the CPU instead. --ndevices N (0, the default: every visible card)
shards the seeds over N ranks (`sampling.sample_sharded`) where N divides
--nsamples, else samples on one: under `torchrun --nproc_per_node N` the
run joins that group; outside one it starts N ranks itself (one per card,
or gloo ranks on the CPU with --cpu). Rank 0 writes. The seeds are draws of
a torch.Generator seeded with --seed, not the JAX CLI's PRNG stream; they
are the same however many ranks run.

Example:
    python -m convolutional_diffusion_tpu_torch.cli.sample \\
        --modelfile backbone_CIFAR10_ResNet_zeros_conditional.pt --conditional
"""

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="Sample from a trained model")
    parser.add_argument("--modelfile", type=str, required=True)
    parser.add_argument("--nsamples", type=int, default=16)
    parser.add_argument("--nsteps", type=int, default=20)
    parser.add_argument("--ddpm", action="store_true", default=False)
    parser.add_argument("--conditional", action="store_true", default=False)
    parser.add_argument("--label", type=int, default=None)
    parser.add_argument("--nlabels", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="samples.png")
    parser.add_argument("--save_arrays", type=str, default=None)
    parser.add_argument("--clip", action=argparse.BooleanOptionalAction, default=True,
                        help="clip samples to [-1, 1] (--no-clip disables)")
    parser.add_argument("--ndevices", type=int, default=0,
                        help="ranks to shard the seeds over (0: every visible card; "
                             "gloo ranks with --cpu)")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU instead of cuda")
    args = parser.parse_args(argv)

    from ..parallel.mesh import is_writer
    from .common import cli_mesh, spawn_ranks

    spawned, result = spawn_ranks(__spec__.name, argv, args.ndevices, cpu=args.cpu,
                                  zero_is_all=True, batch=args.nsamples)
    if spawned:
        return result
    mesh = cli_mesh(args.cpu)

    from ..sampling import sample, sample_sharded
    from ..scores.base import resolve_device
    from ..utils.visualize import save_image_grid
    from .common import load_model

    dev = mesh.device if mesh is not None else resolve_device("cpu" if args.cpu else None)
    model = load_model(args.modelfile, device=dev)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    label = None
    if args.conditional:
        if args.label is not None:
            label = torch.full((args.nsamples,), args.label, dtype=torch.long, device=dev)
        else:
            label = torch.randint(0, args.nlabels, (args.nsamples,), generator=generator,
                                  device=dev)
    if mesh is not None and args.nsamples % mesh.size == 0:
        out = sample_sharded(model, mesh, batch_size=args.nsamples, nsteps=args.nsteps,
                             label=label, generator=generator, ddpm=args.ddpm)
    else:
        out = sample(model, batch_size=args.nsamples, nsteps=args.nsteps, label=label,
                     generator=generator, ddpm=args.ddpm, device=dev)
    out = out.cpu().numpy()
    if args.clip:
        out = np.clip(out, -1, 1)
    if not is_writer():
        return out
    save_image_grid(out, args.out)
    print(f"wrote {args.out} ({args.nsamples} samples, {args.nsteps} steps)")
    if args.save_arrays:
        os.makedirs(args.save_arrays, exist_ok=True)
        for i in range(out.shape[0]):
            np.save(os.path.join(args.save_arrays, f"{i:04d}.npy"), out[i : i + 1])
        print(f"arrays under {args.save_arrays}")
    return out


if __name__ == "__main__":
    main()
