"""Evaluation CLI. Counterpart of `convolutional_diffusion_tpu/cli/evaluate.py`
(the reference's `eval_script.py`), with its flags: runs the trained model
from the saved seeds of an `els` experiment (`pipeline.evaluate_correlations`
over `sampling.sample_scan`, DDIM), compares its samples with the ELS and
IS machines' outputs by normalised correlation, prints the median r against
the IS outputs, the median r against the ELS outputs and the fraction of
seeds where the ELS machine is the closer, in that order, and writes the
scatter figure `scatter_<figname>` in the working directory. Runs on cuda;
--cpu runs on the CPU.

Example:
    python -m convolutional_diffusion_tpu_torch.cli.evaluate \\
        --exp_fname results/exp --model_fname checkpoints/model.pt --conditional
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation Script")
    parser.add_argument("--exp_fname", type=str, default="./")
    parser.add_argument("--model_fname", type=str, default="./model_checkpoints/test.pt")
    parser.add_argument("--outputname", type=str, default="els_outputs")
    parser.add_argument("--dsname", type=str, default="cifar10")
    parser.add_argument("--conditional", action="store_true", default=False)
    parser.add_argument("--title", type=str, default="")
    parser.add_argument("--figname", type=str, default="corrs.png")
    parser.add_argument("--nsteps", type=int, default=20)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU instead of cuda")
    args = parser.parse_args(argv)

    import torch

    from ..data import get_metadata
    from ..pipeline import evaluate_correlations
    from ..sampling import sample_scan
    from ..scores.base import resolve_device
    from .common import load_model

    dev = resolve_device("cpu" if args.cpu else None)
    metadata = get_metadata(args.dsname)
    model = load_model(args.model_fname, device=dev)
    if model.conditional and not args.conditional:
        raise SystemExit(
            "model is conditional but --conditional not given (and the "
            "experiment has no labels/ directory to read labels from)"
        )

    def sample_fn(x, labels):
        x = torch.as_tensor(x, device=dev)
        labels = None if labels is None else torch.as_tensor(labels, device=dev).long()
        return sample_scan(model, model.noise_schedule, x, nsteps=args.nsteps,
                           label=labels).cpu().numpy()

    res = evaluate_correlations(
        args.exp_fname,
        sample_fn,
        outputname=args.outputname,
        conditional=args.conditional,
        channels=metadata["num_channels"],
    )
    print(res["median_ideal"])
    print(res["median_target"])
    print(res["frac_els_beats_is"])

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_xlabel(r"$r^2$, IS Machine")
    ax.set_ylabel(r"$r^2$, ELS Machine")
    ax.scatter(res["ideal_corrs"], res["target_corrs"])
    ax.plot([0, 1], [0, 1], color="orange")
    ax.set_title(args.title)
    figname = "scatter_" + args.figname
    fig.savefig(figname, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    print(f"wrote {figname}")
    return res


if __name__ == "__main__":
    main()
