"""Scales calibration CLI. Counterpart of
`convolutional_diffusion_tpu/cli/calibrate.py` (the reference's
`scripts/scales_calibration.py`), with the same flags and artifacts:
{kfilename}_{k_optimals,median,mode}.{npy,pt} under --tld, and the median
as a JSON scales list ({kfilename}_median.json) that `cli.els` reads. Runs
on cuda; --cpu runs on the CPU (the kernels' plain versions) instead.
The score modules run at the factory's default tier, 'highest'. The seeds
are draws of a torch.Generator seeded with --seed, not the JAX CLI's PRNG
stream.

Example:
    python -m convolutional_diffusion_tpu_torch.cli.calibrate \\
        --modelfile backbone_MNIST_ResNet_zeros.pt --dataset mnist \\
        --kernelsizes 3 5 7 9 11 13 15 17 --nsteps 20 --nsamps 10
"""

import argparse
import json
import os

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="Calibrate")
    parser.add_argument("--kfilename", type=str, default="scales")
    parser.add_argument("--tld", type=str, default="./checkpoints/")
    parser.add_argument("--modelfile", type=str, default=None)
    parser.add_argument("--dataset", type=str, default="mnist")
    parser.add_argument("--scoremoduletype", type=str, default="bbELS")
    parser.add_argument("--conditional", action="store_true", default=False)
    parser.add_argument("--kernelsizes", type=int, nargs="*")
    parser.add_argument("--scorebatchsize", type=int, default=16)
    parser.add_argument("--nsamps", type=int, default=20)
    parser.add_argument("--nsteps", type=int, default=20)
    parser.add_argument("--nlabels", type=int, default=10)
    parser.add_argument("--eval_mode", type=str, default="cos")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU instead of cuda")
    parser.add_argument("--maxsamps", type=int, default=5000)
    parser.add_argument("--dataroot", type=str, default="./data")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fmt", type=str, default="npy", choices=["npy", "pt"])
    args = parser.parse_args(argv)

    if args.modelfile is None:
        raise ValueError("modelfile must be provided")
    if not args.kernelsizes:
        raise ValueError("kernelsizes must be provided")

    from ..calibration import calibrate
    from ..data import get_dataset
    from ..pipeline import save_array
    from ..schedules import cosine_noise_schedule
    from ..scores.bank import BankLedger
    from ..scores.base import resolve_device
    from ..scores.els import DEFAULT_BANK_BUDGET
    from .common import build_score_module, load_model

    dev = resolve_device("cpu" if args.cpu else None)
    ds, metadata = get_dataset(args.dataset, root=args.dataroot)
    if args.maxsamps < ds.num_samples:
        ds = type(ds)(ds.images[: args.maxsamps], ds.labels[: args.maxsamps])

    modelpath = args.modelfile
    if not os.path.exists(modelpath):
        modelpath = os.path.join(args.tld, args.modelfile)
    model = load_model(modelpath, device=dev)

    # one bank ledger across the per-k modules, at the port's card budget:
    # per-module budgets would each cache a bank (eight ELS banks at
    # maxsamps = 5000 sum to ~23 GB)
    ledger = BankLedger(DEFAULT_BANK_BUDGET)
    images = torch.from_numpy(ds.images).to(dev)  # one copy for every module
    labels = torch.from_numpy(ds.labels.astype("int64")).to(dev)
    mods = {
        k: build_score_module(
            args.scoremoduletype, (images, labels), batch_size=args.scorebatchsize,
            image_size=metadata["image_size"], channels=metadata["num_channels"],
            schedule=cosine_noise_schedule, kernel_size=k,
            bank_ledger=ledger, device=dev,
        )
        for k in args.kernelsizes
    }

    def eps_fn(t, x, label):
        return model(t, x, label if args.conditional else None)

    results = calibrate(
        eps_fn, mods, image_size=metadata["image_size"],
        in_channels=metadata["num_channels"], nsamps=args.nsamps, nsteps=args.nsteps,
        conditional=args.conditional, nlabels=args.nlabels, eval_mode=args.eval_mode,
        generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev,
    )

    os.makedirs(args.tld, exist_ok=True)
    for name in ("k_optimals", "median", "mode"):
        save_array(os.path.join(args.tld, f"{args.kfilename}_{name}"), results[name],
                   args.fmt)
    with open(os.path.join(args.tld, f"{args.kfilename}_median.json"), "w") as f:
        json.dump([int(v) for v in results["median"]], f)
    print(f"Results saved to {args.tld}")
    for name in ("k_optimals", "median", "mode"):
        print(f"  - {args.kfilename}_{name}.{args.fmt}")
    return results


if __name__ == "__main__":
    main()
