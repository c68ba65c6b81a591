"""Patch-distance statistics: extreme-value fits and radial power spectra.

Counterpart of `convolutional_diffusion_tpu/analysis/patch_statistics.py`
(the reference's `src/utils/patch_statistics.py`): sample random k x k
patches of an image set, compute all pairwise L2 distances, fit Weibull,
Gumbel and GEV distributions (AIC and Kolmogorov-Smirnov), and compute the
radial power spectrum of the mean patch; figures, JSON, and a driver over
several sets with per-item error containment.

The patches and the distance matrix are computed on the device (cuda unless
the caller passes device='cpu'): ||a||^2 - 2 ab + ||b||^2 with the gram
product in true fp32 (`ops.fp32.true_fp32`, TF32 off; not `torch.cdist`,
whose product rounds differently). The fits run on the host with scipy,
which, like matplotlib for the figures, is imported inside the functions
that use it.
"""

from __future__ import annotations

import json
import os
import traceback
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.fp32 import true_fp32
from ..scores.base import resolve_device

__all__ = [
    "random_patches",
    "pairwise_distances",
    "fit_distributions",
    "radial_power_spectrum",
    "analyze_patch_distances",
    "analyze_multiple_datasets",
    "plot_distribution_comparison",
]


def random_patches(images, patch_size: int, num_samples: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """num_samples random k x k crops, each of a randomly chosen image,
    drawn with `generator` (on the images' device; default seeded with 0).

    Takes [N, h, w, c], [N, h, w] (no channel axis) or a single [h, w(, c)]
    image (a trailing axis of 1-4 reads as the channels of one image), as
    the reference's RandomCrop does -> [num_samples, k, k, c]."""
    images = torch.as_tensor(images)
    if images.ndim == 2:  # one gray image
        images = images[None, :, :, None]
    elif images.ndim == 3:
        images = images[None] if images.shape[-1] <= 4 else images[..., None]
    n, h, w, c = images.shape
    k = patch_size
    if k > h or k > w:
        raise ValueError(f"patch_size {k} exceeds image size {h}x{w}")
    dev = images.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(high):
        return torch.randint(0, high, (num_samples,), generator=generator, device=dev)

    idx, rows, cols = draw(n), draw(h - k + 1), draw(w - k + 1)
    ar = torch.arange(k, device=dev)
    return images[idx[:, None, None], (rows[:, None] + ar)[:, :, None],
                  (cols[:, None] + ar)[:, None, :]]


def pairwise_distances(patches: torch.Tensor) -> torch.Tensor:
    """Upper-triangular pairwise L2 distances between flattened patches,
    the condensed [m (m - 1) / 2] vector, as ||a - b||^2 = ||a||^2 - 2 ab +
    ||b||^2 with the gram product in true fp32, clamped at 0."""
    m = patches.shape[0]
    flat = patches.reshape(m, -1)
    sq = torch.sum(flat**2, dim=1)
    with true_fp32():
        gram = flat @ flat.T
    d2 = torch.clamp(sq[:, None] - 2 * gram + sq[None, :], min=0.0)
    iu = torch.triu_indices(m, m, offset=1, device=patches.device)
    return torch.sqrt(d2[iu[0], iu[1]])


def fit_distributions(data: np.ndarray) -> Dict[str, Dict]:
    """Fit Weibull, Gumbel and GEV; rank by AIC; Kolmogorov-Smirnov
    goodness of fit. The reference's candidates and criterion
    (`patch_statistics.py:65-123`): per-distribution dicts plus 'best_fit'
    (lowest AIC)."""
    from scipy import stats

    data = np.asarray(data, np.float64)
    data = data[np.isfinite(data)]
    if data.size < 10:
        raise ValueError(f"need >= 10 samples to fit, got {data.size}")

    candidates = {
        "weibull": stats.weibull_min,
        "gumbel": stats.gumbel_r,
        "gev": stats.genextreme,
    }
    results: Dict[str, Dict] = {}
    for name, dist in candidates.items():
        try:
            params = dist.fit(data)
            loglik = float(np.sum(dist.logpdf(data, *params)))
            aic = 2 * len(params) - 2 * loglik
            ks_stat, ks_p = stats.kstest(data, dist.cdf, args=params)
            results[name] = {
                "params": [float(p) for p in params],
                "loglik": loglik,
                "aic": float(aic),
                "ks_statistic": float(ks_stat),
                "ks_pvalue": float(ks_p),
            }
        except Exception as e:  # keep the other fits (the reference's style)
            results[name] = {"error": repr(e)}
    fitted = {k: v for k, v in results.items() if "aic" in v}
    if fitted:
        results["best_fit"] = min(fitted, key=lambda k: fitted[k]["aic"])
    return results


def radial_power_spectrum(patch: torch.Tensor):
    """Radially binned power spectrum of a 2-D patch (the mean over
    channels of an [h, w, c] one): |fftshift(fft2)|^2 averaged over the
    pixels at each rounded radius from the centre. Returns (radii [r] numpy,
    power [r] on the patch's device)."""
    patch = torch.as_tensor(patch)
    if patch.ndim == 3:
        patch = torch.mean(patch, dim=-1)
    h, w = patch.shape
    f = torch.fft.fftshift(torch.fft.fft2(patch))
    power = (torch.abs(f) ** 2).reshape(-1)
    cy, cx = h // 2, w // 2
    yy, xx = torch.meshgrid(torch.arange(h, device=patch.device),
                            torch.arange(w, device=patch.device), indexing="ij")
    r = torch.sqrt(((yy - cy) ** 2 + (xx - cx) ** 2).to(torch.float32))
    rbin = torch.round(r).to(torch.long).reshape(-1)
    nbins = int(np.ceil(np.sqrt(cy**2 + cx**2))) + 1
    sums = torch.zeros(nbins, dtype=power.dtype, device=patch.device).index_add_(
        0, rbin, power)
    counts = torch.bincount(rbin, minlength=nbins).to(power.dtype)
    return np.arange(nbins), sums / torch.clamp(counts, min=1)


def analyze_patch_distances(
    images,
    *,
    patch_size: int = 3,
    num_samples: int = 200,
    generator: Optional[torch.Generator] = None,
    dataset_name: str = "dataset",
    save_dir: Optional[str] = None,
    make_plots: bool = True,
    device=None,
) -> Dict:
    """One configuration: sample patches on `device` (cuda unless told
    otherwise) with `generator` (default: seeded with 0 there), fit the
    distance distributions, and compute the mean patch's radial power
    spectrum; with save_dir, write `<name>_patch<k>_analysis.json` (and,
    with make_plots, the 6-panel `.png`; reference `:370-579`). The
    distances stay in the result as `_distances` (not serialised)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if not isinstance(images, torch.Tensor):
        images = np.asarray(images, np.float32)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    patches = random_patches(images, patch_size, num_samples, generator)
    dists = pairwise_distances(patches).cpu().numpy()
    fits = fit_distributions(dists)
    mean_patch = torch.mean(patches, dim=0)
    radii, power = radial_power_spectrum(mean_patch)
    power = power.cpu().numpy()
    results = {
        "dataset": dataset_name,
        "patch_size": patch_size,
        "num_samples": int(num_samples),
        "num_distances": int(dists.size),
        "distance_stats": {
            "mean": float(dists.mean()),
            "std": float(dists.std()),
            "min": float(dists.min()),
            "max": float(dists.max()),
        },
        "fits": fits,
        "power_spectrum": {"radii": radii.tolist(), "power": power.tolist()},
    }
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        base = os.path.join(save_dir, f"{dataset_name}_patch{patch_size}")
        with open(base + "_analysis.json", "w") as f:
            json.dump(results, f, indent=2)
        if make_plots:
            _plot_analysis(dists, fits, mean_patch.cpu().numpy(), radii, power, base)
    results["_distances"] = dists  # in memory only
    return results


def _plot_analysis(dists, fits, mean_patch, radii, power, base):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy import stats

    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    ax = axes[0, 0]
    ax.hist(dists, bins=50, density=True, alpha=0.6)
    xs = np.linspace(dists.min(), dists.max(), 200)
    for name, dist in (
        ("weibull", stats.weibull_min),
        ("gumbel", stats.gumbel_r),
        ("gev", stats.genextreme),
    ):
        if "params" in fits.get(name, {}):
            ax.plot(xs, dist.pdf(xs, *fits[name]["params"]), label=name)
    ax.legend()
    ax.set_title("patch distance distribution")

    axes[0, 1].imshow(np.mean(mean_patch, -1), cmap="gray")
    axes[0, 1].set_title("mean patch")
    axes[0, 2].semilogy(radii[1:], np.maximum(power[1:], 1e-20))
    axes[0, 2].set_title("radial power spectrum")

    axes[1, 0].hist(dists, bins=50, cumulative=True, density=True, alpha=0.6)
    axes[1, 0].set_title("empirical CDF")
    best = fits.get("best_fit")
    axes[1, 1].axis("off")
    lines = [f"best fit: {best}"]
    for name in ("weibull", "gumbel", "gev"):
        r = fits.get(name, {})
        if "aic" in r:
            lines.append(f"{name}: AIC={r['aic']:.1f} KS p={r['ks_pvalue']:.3f}")
    axes[1, 1].text(0.05, 0.5, "\n".join(lines), fontsize=11, va="center")
    axes[1, 2].boxplot(dists, vert=True)
    axes[1, 2].set_title("distance spread")
    fig.tight_layout()
    fig.savefig(base + "_analysis.png", dpi=100)
    plt.close(fig)


def plot_distribution_comparison(results_by_patch: Dict[int, Dict], dataset_name: str,
                                 save_dir: str):
    """Histogram against the best fit for each patch size (reference
    `:582-686`); writes and returns `<name>_distribution_comparison.png`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy import stats

    dmap = {"weibull": stats.weibull_min, "gumbel": stats.gumbel_r,
            "gev": stats.genextreme}
    n = len(results_by_patch)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 4), squeeze=False)
    for ax, (ps, res) in zip(axes[0], sorted(results_by_patch.items())):
        d = res.get("_distances")
        if d is None:
            continue
        ax.hist(d, bins=50, density=True, alpha=0.6)
        best = res["fits"].get("best_fit")
        if best and "params" in res["fits"][best]:
            xs = np.linspace(d.min(), d.max(), 200)
            ax.plot(xs, dmap[best].pdf(xs, *res["fits"][best]["params"]),
                    label=f"{best} (best)")
            ax.legend()
        ax.set_title(f"{dataset_name} k={ps}")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{dataset_name}_distribution_comparison.png")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def analyze_multiple_datasets(
    datasets: Dict[str, object],  # name -> images [N, h, w, c]
    *,
    patch_sizes: Sequence[int] = (3, 6, 10),
    num_samples: int = 200,
    save_dir: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    make_plots: bool = True,
    device=None,
    log_fn=print,
) -> Dict[str, Dict[int, Dict]]:
    """`analyze_patch_distances` over datasets x patch sizes, one draw of
    `generator` after another, with per-item error containment (the
    reference's `analyze_multiple_datasets`, `:689-767`): a failed item is
    logged and skipped."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    all_results: Dict[str, Dict[int, Dict]] = {}
    for name, images in datasets.items():
        per_ds: Dict[int, Dict] = {}
        for ps in patch_sizes:
            try:
                per_ds[ps] = analyze_patch_distances(
                    images, patch_size=ps, num_samples=num_samples, generator=generator,
                    dataset_name=name, save_dir=save_dir, make_plots=make_plots,
                    device=dev,
                )
                log_fn(f"{name} k={ps}: best={per_ds[ps]['fits'].get('best_fit')}")
            except Exception as e:
                log_fn(f"{name} k={ps} FAILED: {e!r}")
                traceback.print_exc()
        if per_ds and save_dir and make_plots:
            try:
                plot_distribution_comparison(per_ds, name, save_dir)
            except Exception as e:
                log_fn(f"{name} comparison plot FAILED: {e!r}")
        all_results[name] = per_ds
    return all_results
