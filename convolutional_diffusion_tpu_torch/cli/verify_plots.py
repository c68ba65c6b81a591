"""Plot verification CLI. Counterpart of
`convolutional_diffusion_tpu/cli/verify_plots.py` (the reference's
`verify_plots.py`): checks that the `<ds>_distribution_comparison.png`
figures of `patch_stats` exist and prints their sizes; exits with 1 when one
is missing."""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Verify analysis plots")
    parser.add_argument(
        "--datasets", type=str, nargs="*",
        default=["mnist", "fashion_mnist", "cifar10", "celeba"],
    )
    parser.add_argument("--results", type=str, default="./results/patch_statistics")
    args = parser.parse_args(argv)

    missing = []
    for ds in args.datasets:
        path = os.path.join(args.results, f"{ds}_distribution_comparison.png")
        if os.path.exists(path):
            print(f"OK {path} ({os.path.getsize(path)} bytes)")
        else:
            print(f"MISSING {path}")
            missing.append(path)
    if missing:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
