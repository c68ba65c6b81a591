"""Exterior-derivative (curl) analysis CLI. Counterpart of
`convolutional_diffusion_tpu/cli/analyze_ed.py` (the reference's
`analyze_exterior_derivative.py`), with its flags and artifacts: along a
reverse DDIM trajectory, how far each model's field is from a gradient
(conservative) field, ||J - J^T||_F at every step, for the trained CNNs and
the bbELS machine; aggregated over realizations; written under
<results>/<dataset>/ as ed_analysis_single.{png,npz},
ed_analysis_aggregated.{png,npz} (with --multiple > 1) and
summary_stats.json. Runs on cuda; --cpu runs on the CPU.

The Jacobians are `analysis.exterior_derivative`'s (vmap of jacrev). bbELS
is built with use_pallas=False: the flash-score kernel has no backward, so
its sweeps take the plain version, which autograd differentiates. Its
images are those of the batch quota: with --max_samples, batch i of
--scorebatchsize images enters iff i * batch <= max_samples, so the images
past the last such batch weigh 0 in every region and the module gets only
the quota's (`quota_images`; the same field, the sweeps no longer walk
zero-weight images). The realization loop (`realizations`) needs no
matplotlib; only the figures import it.

Example:
    python -m convolutional_diffusion_tpu_torch.cli.analyze_ed \\
        --dataset cifar10 --image_size 16 --multiple 5
"""

import argparse
import glob
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F


def _find_checkpoints(checkpoints_dir, dataset_name):
    """The reference's auto-detection glob (analyze_exterior_derivative.py:56-77):
    tag -> the first `backbone_<DATASET>_<tag>*` pickle or `*<tag>*<dataset>*`
    checkpoint."""
    up = dataset_name.upper()
    out = {}
    for tag in ("UNet", "ResNet"):
        hits = sorted(
            glob.glob(os.path.join(checkpoints_dir, f"backbone_{up}_{tag}*"))
        ) + sorted(glob.glob(os.path.join(checkpoints_dir, f"*{tag}*{dataset_name}*")))
        if hits:
            out[tag.lower()] = hits[0]
    return out


def resize_images(images, image_size: int) -> np.ndarray:
    """NHWC images downscaled to image_size x image_size: bilinear with
    antialiasing (`F.interpolate(..., antialias=True)`), which is what
    `jax.image.resize(..., 'bilinear')` computes when it shrinks."""
    x = torch.as_tensor(np.asarray(images, np.float32)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(image_size, image_size), mode="bilinear",
                      antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous().numpy()


def quota_images(n: int, batch_size: int, max_samples) -> int:
    """The images bbELS's batch-quota cutoff can weigh: batch i enters iff
    i * batch_size <= max_samples."""
    if max_samples is None:
        return n
    return min(n, (max_samples // batch_size + 1) * batch_size)


def bbels_field(images, labels, *, kernel_size: int, batch_size: int, max_samples,
                device):
    """The bbELS score field t, x -> score at kernel_size, differentiable
    (use_pallas=False), over the images of the batch quota."""
    from ..schedules import cosine_noise_schedule
    from ..scores import LocalEquivBordersScoreModule

    n = quota_images(len(images), batch_size, max_samples)
    module = LocalEquivBordersScoreModule(
        (images[:n], labels[:n]), kernel_size=kernel_size, batch_size=batch_size,
        schedule=cosine_noise_schedule, max_samples=max_samples, use_pallas=False,
        device=device,
    )
    return lambda t, x: module(t, x, k=kernel_size)


def model_field(model):
    """A DiffusionModel's epsilon field t, x -> model(t, x) (unconditional)."""
    return lambda t, x: model(t, x, None)


def ed_step(fn, x, t: float, nsteps: int, is_score: bool):
    """One step of the analysis: ||J - J^T||_F of fn(t, .) at x [1, h, w, c],
    then the DDIM step from x (a score field's output turned into epsilon,
    eps = -sqrt(beta_t) score). Returns (magnitude, next x)."""
    from ..analysis.exterior_derivative import (
        compute_exterior_derivative_nd,
        exterior_derivative_magnitude,
    )
    from ..sampling import ddim_step
    from ..schedules import cosine_noise_schedule

    beta_t = cosine_noise_schedule(torch.tensor(t, dtype=torch.float32))
    beta_prev = cosine_noise_schedule(torch.tensor(t, dtype=torch.float32) - 1.0 / nsteps)
    df = compute_exterior_derivative_nd(x, lambda xb: fn(t, xb))
    mag = exterior_derivative_magnitude(df)[0]
    del df
    with torch.no_grad():
        eps = fn(t, x)
        if is_score:
            eps = eps * (-torch.sqrt(beta_t))
        x_next = ddim_step(x, eps, beta_t.expand(1), beta_prev.expand(1))
    return mag, x_next


def warm(fields, shape, device, log=print):
    """Call each field once, eagerly, before any transform, so its caches
    (bbELS's bank) hold plain tensors; drops the fields whose call fails
    (a conditional checkpoint, say)."""
    x = torch.zeros(shape, device=device)
    for name in list(fields):
        try:
            with torch.no_grad():
                fields[name][0](1.0, x)
        except Exception as e:
            log(f"skipping {name}: warm-up failed ({e!r})")
            del fields[name]
    return fields


def realizations(fields, *, image_size: int, channels: int, nsteps: int, n_real: int,
                 seed: int, device, log=print):
    """The analysis loop: `n_real` trajectories of `nsteps` DDIM steps from
    N(0, 1) seeds drawn with a torch.Generator seeded with `seed` on the
    device, one per realization and shared by the fields; fields maps name
    -> (fn(t, x), is_score). Returns (results name -> [n_real, nsteps] ED
    magnitudes, finals name -> the last realization's final image [h, w, c],
    seconds name -> mean wall seconds per step)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {name: np.zeros((n_real, nsteps)) for name in fields}
    finals, seconds = {}, {name: 0.0 for name in fields}
    for r in range(n_real):
        x0 = torch.randn((1, image_size, image_size, channels), generator=gen, device=dev)
        for name, (fn, is_score) in fields.items():
            x = x0
            t0 = time.perf_counter()
            for j, i in enumerate(range(nsteps, 0, -1)):
                mag, x = ed_step(fn, x, i / nsteps, nsteps, is_score)
                results[name][r, j] = float(mag)
            seconds[name] += (time.perf_counter() - t0) / (nsteps * n_real)
            finals[name] = x[0].cpu().numpy()
            log(f"realization {r}: {name} done")
    return results, finals, seconds


def main(argv=None):
    parser = argparse.ArgumentParser(description="Exterior derivative analysis")
    parser.add_argument("--dataset", type=str, default="cifar10")
    parser.add_argument("--checkpoints", type=str, default="./checkpoints")
    parser.add_argument("--results", type=str, default="./results/exterior_derivative")
    parser.add_argument("--nsteps", type=int, default=20)
    parser.add_argument("--single", action="store_true", default=False)
    parser.add_argument("--multiple", type=int, default=0,
                        help="number of realizations (0 = --single)")
    parser.add_argument("--max_samples", type=int, default=1000)
    parser.add_argument("--scorebatchsize", type=int, default=64)
    parser.add_argument("--kernel_size", type=int, default=5)
    parser.add_argument("--image_size", type=int, default=0,
                        help="override (downscale) for Jacobian tractability")
    parser.add_argument("--dataroot", type=str, default="./data")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--modelfile", type=str, default=None,
                        help="explicit checkpoint (else auto-detected)")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU instead of cuda")
    args = parser.parse_args(argv)

    from ..data import get_dataset
    from ..scores.base import resolve_device
    from .common import load_model

    dev = resolve_device("cpu" if args.cpu else None)
    ds, metadata = get_dataset(args.dataset, root=args.dataroot)
    image_size = args.image_size or metadata["image_size"]
    channels = metadata["num_channels"]
    images = ds.images
    if image_size != metadata["image_size"]:
        images = resize_images(images, image_size)

    fields = {}
    paths = ({os.path.basename(args.modelfile): args.modelfile} if args.modelfile
             else _find_checkpoints(args.checkpoints, metadata["name"]))
    for tag, path in paths.items():
        try:
            fields[tag] = (model_field(load_model(path, device=dev)), False)
            print(f"loaded {tag}: {path}")
        except Exception as e:
            if args.modelfile:
                raise
            print(f"skipping {tag} ({path}): {e!r}")
    fields["bbels"] = (bbels_field(images, ds.labels, kernel_size=args.kernel_size,
                                   batch_size=args.scorebatchsize,
                                   max_samples=args.max_samples, device=dev), True)
    warm(fields, (1, image_size, image_size, channels), dev)

    n_real = max(1, args.multiple)
    nsteps = args.nsteps
    results, finals, _ = realizations(fields, image_size=image_size, channels=channels,
                                      nsteps=nsteps, n_real=n_real, seed=args.seed,
                                      device=dev)

    # per-dataset subdirectory, as the reference's output_dir / dataset
    out_dir = os.path.join(args.results, args.dataset)
    os.makedirs(out_dir, exist_ok=True)
    steps = np.arange(nsteps, 0, -1)
    _plot_single(results, finals, steps, out_dir)
    np.savez(
        os.path.join(out_dir, "ed_analysis_single.npz"),
        timesteps=steps,
        **{f"{n}/ed_magnitudes": results[n][0] for n in results},
        **{f"{n}/final_image": finals[n] for n in finals},
    )
    if n_real > 1:
        _plot_aggregated(results, steps, n_real, out_dir)
        np.savez(
            os.path.join(out_dir, "ed_analysis_aggregated.npz"),
            timesteps=steps,
            **{f"{n}/all": results[n] for n in results},
        )
    summary = {
        name: {
            "mean": vals.mean(0).tolist(),
            "std": vals.std(0).tolist(),
            "cv": (vals.std(0) / np.maximum(vals.mean(0), 1e-12)).tolist(),
            "mean_ed_magnitude": float(vals.mean()),
            "max_ed_magnitude": float(vals.mean(0).max()),
            "num_realizations": n_real,
        }
        for name, vals in results.items()
    }
    with open(os.path.join(out_dir, "summary_stats.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("wrote ed_analysis_single.png/.npz"
          + (", ed_analysis_aggregated.png/.npz" if n_real > 1 else "")
          + f", summary_stats.json under {out_dir}")
    return results


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _show_img(ax, img, title):
    img = np.clip(img * 0.5 + 0.5, 0, 1)
    if img.shape[-1] == 1:
        ax.imshow(img[..., 0], cmap="gray")
    else:
        ax.imshow(img)
    ax.set_title(title)
    ax.axis("off")


def _plot_single(results, finals, steps, out_dir):
    """The single-realization figure suite (reference :342-400)."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    ax = axes[0, 0]
    for name, vals in results.items():
        ax.plot(steps, vals[0], marker="o", label=name)
    ax.set_xlabel("reverse step i")
    ax.set_ylabel(r"$\|df\|_F$")
    ax.invert_xaxis()
    ax.set_title("Exterior derivative during reverse process")
    ax.legend()
    ax.grid(alpha=0.3)
    ax = axes[0, 1]
    for name, vals in results.items():
        pos = vals[0] > 0
        ax.semilogy(steps[pos], vals[0][pos], marker="o", label=name)
    ax.set_xlabel("reverse step i")
    ax.set_ylabel(r"$\|df\|_F$ (log)")
    ax.invert_xaxis()
    ax.set_title("Exterior derivative (log scale)")
    ax.legend()
    ax.grid(alpha=0.3)
    first = next(iter(finals))
    _show_img(axes[1, 0], finals[first], f"generated image ({first})")
    ax = axes[1, 1]
    names = list(results)
    means = [results[n][0].mean() for n in names]
    bars = ax.bar(names, means, alpha=0.7)
    for bar, m in zip(bars, means):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                f"{m:.4f}", ha="center", va="bottom")
    ax.set_ylabel("mean ED magnitude")
    ax.set_title("Mean ED magnitude comparison")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "ed_analysis_single.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)


def _plot_aggregated(results, steps, n_real, out_dir):
    """The aggregated figure suite (reference :403-472)."""
    plt = _pyplot()
    names = list(results)
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    ax = axes[0, 0]
    for name, vals in results.items():
        ax.errorbar(steps, vals.mean(0), yerr=vals.std(0), marker="o",
                    capsize=5, label=f"{name} (n={n_real})")
    ax.set_xlabel("reverse step i")
    ax.set_ylabel(r"$\|df\|_F$")
    ax.invert_xaxis()
    ax.set_title("Mean exterior derivative during reverse process")
    ax.legend()
    ax.grid(alpha=0.3)
    ax = axes[0, 1]
    for name, vals in results.items():
        ax.plot(steps, vals.std(0) / (vals.mean(0) + 1e-8), marker="o", label=name)
    ax.set_xlabel("reverse step i")
    ax.set_ylabel("coefficient of variation")
    ax.invert_xaxis()
    ax.set_title("Variability of exterior derivative")
    ax.legend()
    ax.grid(alpha=0.3)
    ax = axes[1, 0]
    im = ax.imshow(results[names[0]], aspect="auto", cmap="viridis")
    ax.set_xlabel("step index")
    ax.set_ylabel("realization")
    ax.set_title(f"ED magnitudes across realizations ({names[0]})")
    fig.colorbar(im, ax=ax)
    ax = axes[1, 1]
    xpos = np.arange(len(names))
    ax.bar(xpos - 0.175, [results[n].mean() for n in names], 0.35,
           label="mean ED", alpha=0.7)
    ax.bar(xpos + 0.175, [results[n].std(0).mean() for n in names], 0.35,
           label="mean std", alpha=0.7)
    ax.set_xticks(xpos)
    ax.set_xticklabels(names)
    ax.set_title("Summary statistics comparison")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "ed_analysis_aggregated.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
