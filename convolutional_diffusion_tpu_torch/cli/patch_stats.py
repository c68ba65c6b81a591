"""Patch-distance distribution analysis CLI. Counterpart of
`convolutional_diffusion_tpu/cli/patch_stats.py` (the reference's
`run_distribution_analysis.py`), with its flags: sweeps datasets x patch
sizes, fits Weibull / Gumbel / GEV, prints the best-AIC fit of each, and
writes the figures and JSON under --results. Runs on cuda; --cpu runs on
the CPU. The patches are drawn with a torch.Generator seeded with --seed.

Example:
    python -m convolutional_diffusion_tpu_torch.cli.patch_stats \\
        --datasets mnist cifar10 --patch_sizes 3 6 10
"""

import argparse


def to_grayscale(images):
    """[N, h, w, c] images in [-1, 1] -> [N, h, w, 1] luminance
    0.299 R + 0.587 G + 0.114 B, renormalised to [-1, 1] (the reference's
    PIL grayscale wrapper, run_distribution_analysis_grayscale.py:13-60)."""
    import numpy as np

    u = (images + 1.0) / 2.0
    lum = 0.299 * u[..., 0] + 0.587 * u[..., 1] + 0.114 * u[..., 2]
    return (lum * 2.0 - 1.0)[..., None].astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Patch distribution analysis")
    parser.add_argument(
        "--datasets", type=str, nargs="*",
        default=["mnist", "fashion_mnist", "cifar10", "celeba"],
    )
    parser.add_argument("--patch_sizes", type=int, nargs="*", default=[3, 6, 10])
    parser.add_argument("--num_samples", type=int, default=200)
    parser.add_argument("--dataroot", type=str, default="./data")
    parser.add_argument("--results", type=str, default="./results/patch_statistics")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grayscale", action="store_true", default=False)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU instead of cuda")
    args = parser.parse_args(argv)

    import torch

    from ..analysis.patch_statistics import analyze_multiple_datasets
    from ..data import get_dataset
    from ..scores.base import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    loaded = {}
    for name in args.datasets:
        try:
            ds, _ = get_dataset(name, root=args.dataroot)
            images = ds.images
            if args.grayscale and images.shape[-1] > 1:
                images = to_grayscale(images)
                name = f"grayscale_{name}"
            loaded[name] = images
        except (FileNotFoundError, ValueError) as e:
            print(f"skipping {name}: {e}")
    if not loaded:
        raise SystemExit("no datasets available (use --datasets synthetic ...)")

    results = analyze_multiple_datasets(
        loaded,
        patch_sizes=args.patch_sizes,
        num_samples=args.num_samples,
        save_dir=args.results,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev,
    )
    print("\n=== best-fit summary ===")
    for name, per_ds in results.items():
        for ps, res in sorted(per_ds.items()):
            print(f"{name} k={ps}: {res['fits'].get('best_fit')}")
    return results


if __name__ == "__main__":
    main()
