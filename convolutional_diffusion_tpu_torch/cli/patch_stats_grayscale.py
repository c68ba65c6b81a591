"""Grayscale patch-distance analysis CLI. Counterpart of
`convolutional_diffusion_tpu/cli/patch_stats_grayscale.py` (the reference's
`run_distribution_analysis_grayscale.py`): the `patch_stats` sweep with
each colour set converted to luminance (`patch_stats.to_grayscale`), its
results prefixed `grayscale_`."""

from .patch_stats import main as _main


def main(argv=None):
    import sys

    argv = list(argv if argv is not None else sys.argv[1:])
    if "--grayscale" not in argv:
        argv.append("--grayscale")
    return _main(argv)


if __name__ == "__main__":
    main()
