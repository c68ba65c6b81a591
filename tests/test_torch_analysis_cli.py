"""The port's analysis CLIs on the CPU, mirroring the JAX package's CLI tests
(`tests/test_cli.py`): `cli.analyze_ed` (artifacts and summary_stats.json,
with a tiny trained ResNet found by auto-detection beside bbELS),
`cli.patch_stats` + `cli.verify_plots` (and its SystemExit on a missing
set), `cli.patch_stats_grayscale`, and `cli.evaluate` over `cli.els`
outputs with that checkpoint. Also: the --image_size resize against
`jax.image.resize` (1e-6), and the batch-quota cut of bbELS's images
against the module over every image (1e-6 of scale)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu_torch.cli import analyze_ed, patch_stats, verify_plots
from convolutional_diffusion_tpu_torch.data import synthetic_dataset


@pytest.fixture(scope="module")
def tiny_checkpoints(tmp_path_factory):
    """A checkpoint directory holding one tiny unconditional ResNet trained
    by the port's cli.train on the synthetic set."""
    from convolutional_diffusion_tpu_torch.cli import train

    home = tmp_path_factory.mktemp("ckpts")
    train.main(["--cpu", "--dataset", "synthetic", "--epochs", "1", "--batchsize", "8",
                "--layers", "1", "--mult", "1", "--resnet", "--mode", "zeros",
                "--homedir", str(home), "--saveinterval", "1", "--suppress",
                "--maxsamps", "32"])
    return home


def test_analyze_ed_end_to_end(tmp_path, tiny_checkpoints):
    results = str(tmp_path / "ed")
    out = analyze_ed.main([
        "--dataset", "synthetic", "--results", results, "--nsteps", "3",
        "--image_size", "8", "--max_samples", "16", "--kernel_size", "3",
        "--scorebatchsize", "16", "--multiple", "2",
        "--checkpoints", str(tiny_checkpoints), "--cpu",
    ])
    d = os.path.join(results, "synthetic")  # the reference's output_dir / dataset
    for name in ("ed_analysis_single.png", "ed_analysis_single.npz",
                 "ed_analysis_aggregated.png", "ed_analysis_aggregated.npz",
                 "summary_stats.json"):
        assert os.path.exists(os.path.join(d, name)), name
    with open(os.path.join(d, "summary_stats.json")) as f:
        summary = json.load(f)
    assert sorted(summary) == ["bbels", "resnet"]
    for stats in summary.values():
        assert stats["num_realizations"] == 2 and len(stats["mean"]) == 3
        assert np.isfinite(stats["mean_ed_magnitude"]) and stats["max_ed_magnitude"] > 0
    single = np.load(os.path.join(d, "ed_analysis_single.npz"))
    np.testing.assert_array_equal(single["timesteps"], [3, 2, 1])
    np.testing.assert_array_equal(single["bbels/ed_magnitudes"], out["bbels"][0])
    assert single["resnet/final_image"].shape == (8, 8, 3)
    agg = np.load(os.path.join(d, "ed_analysis_aggregated.npz"))
    assert agg["bbels/all"].shape == (2, 3)


def test_analyze_ed_single_bbels_only(tmp_path):
    results = str(tmp_path / "ed")
    analyze_ed.main([
        "--dataset", "synthetic", "--results", results, "--nsteps", "3",
        "--image_size", "8", "--max_samples", "16", "--kernel_size", "3",
        "--scorebatchsize", "16", "--single", "--checkpoints", str(tmp_path), "--cpu",
    ])
    d = os.path.join(results, "synthetic")
    with open(os.path.join(d, "summary_stats.json")) as f:
        assert list(json.load(f)) == ["bbels"]
    assert not os.path.exists(os.path.join(d, "ed_analysis_aggregated.npz"))


@pytest.mark.parametrize("size", [16, 8, 12])
def test_resize_matches_jax_image_resize(size):
    images = synthetic_dataset(num_samples=4, image_size=32, num_channels=3).images
    want = np.asarray(jax.image.resize(jnp.asarray(images), (4, size, size, 3), "bilinear"))
    got = analyze_ed.resize_images(images, size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_bbels_quota_cut_is_the_same_field():
    """bbELS's batch quota (batch i enters iff i * batch <= max_samples):
    the module over the quota's images is the module over all of them."""
    from convolutional_diffusion_tpu_torch.scores import LocalEquivBordersScoreModule

    ds = synthetic_dataset(num_samples=100, image_size=8, num_channels=3)
    assert analyze_ed.quota_images(100, 8, 20) == 24
    assert analyze_ed.quota_images(100, 8, None) == 100
    field = analyze_ed.bbels_field(ds.images, ds.labels, kernel_size=3, batch_size=8,
                                   max_samples=20, device="cpu")
    whole = LocalEquivBordersScoreModule((ds.images, ds.labels), kernel_size=3, batch_size=8,
                                         max_samples=20, device="cpu")
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    for t in (0.2, 0.7):
        a, b = field(t, x), whole(t, x, k=3)
        assert (a - b).abs().max() <= 1e-6 * max(b.abs().max().item(), 1.0)


def test_patch_stats_and_verify_plots(tmp_path, capsys):
    results = str(tmp_path / "ps")
    out = patch_stats.main(["--datasets", "synthetic", "--patch_sizes", "3",
                            "--num_samples", "40", "--results", results, "--cpu"])
    assert 3 in out["synthetic"]
    assert os.path.exists(os.path.join(results, "synthetic_distribution_comparison.png"))
    assert os.path.exists(os.path.join(results, "synthetic_patch3_analysis.json"))
    assert "synthetic k=3:" in capsys.readouterr().out
    verify_plots.main(["--datasets", "synthetic", "--results", results])
    with pytest.raises(SystemExit):
        verify_plots.main(["--datasets", "missing_ds", "--results", results])
    with pytest.raises(SystemExit, match="no datasets"):
        patch_stats.main(["--datasets", "missing_ds", "--results", results, "--cpu"])


def test_patch_stats_grayscale(tmp_path):
    from convolutional_diffusion_tpu_torch.cli import patch_stats_grayscale

    results = str(tmp_path / "ps")
    out = patch_stats_grayscale.main(["--datasets", "synthetic", "--patch_sizes", "3",
                                      "--num_samples", "30", "--results", results, "--cpu"])
    assert list(out) == ["grayscale_synthetic"]
    assert os.path.exists(os.path.join(results,
                                       "grayscale_synthetic_distribution_comparison.png"))
    images = synthetic_dataset(num_samples=4, image_size=8, num_channels=3).images
    gray = patch_stats.to_grayscale(images)
    u = (images + 1.0) / 2.0
    want = (0.299 * u[..., 0] + 0.587 * u[..., 1] + 0.114 * u[..., 2]) * 2.0 - 1.0
    assert gray.shape == (4, 8, 8, 1) and gray.dtype == np.float32
    np.testing.assert_allclose(gray[..., 0], want, atol=1e-6)


def test_evaluate_over_els_outputs(tmp_path, tiny_checkpoints, monkeypatch, capsys):
    from convolutional_diffusion_tpu_torch.cli import els, evaluate

    ck = tmp_path / "checkpoints"
    ck.mkdir()
    with open(ck / "scales_SYNTHETIC_ResNet_zeros.json", "w") as f:
        json.dump([3, 3, 3], f)
    common = ["--dataset", "synthetic", "--numiters", "3", "--cpu", "--checkpoints", str(ck),
              "--results", str(tmp_path / "results"), "--expname", "exp",
              "--scorebatchsize", "64", "--scoremoduletype", "IS", "--nsteps", "3"]
    els.main(common)  # seeds and els_outputs
    els.main(common + ["--idealname", "ideal", "--fill"])
    exp = tmp_path / "results" / "exp"
    model_dir = tiny_checkpoints / os.listdir(tiny_checkpoints)[0]
    monkeypatch.chdir(tmp_path)
    res = evaluate.main(["--exp_fname", str(exp), "--model_fname", str(model_dir),
                         "--dsname", "synthetic", "--nsteps", "5", "--cpu"])
    assert res["n"] == 3 and np.isfinite(res["ideal_corrs"]).all()
    lines = capsys.readouterr().out.splitlines()
    i = lines.index(str(res["median_ideal"]))
    assert lines[i + 1:i + 3] == [str(res["median_target"]), str(res["frac_els_beats_is"])]
    assert os.path.exists(tmp_path / "scatter_corrs.png")


@pytest.mark.parametrize("name,flag", [
    ("analyze_ed", "--image_size"), ("evaluate", "--exp_fname"),
    ("patch_stats", "--patch_sizes"), ("patch_stats_grayscale", "--grayscale"),
    ("verify_plots", "--results")])
def test_cli_help_exits_zero(name, flag, capsys):
    import importlib

    mod = importlib.import_module(f"convolutional_diffusion_tpu_torch.cli.{name}")
    with pytest.raises(SystemExit) as exit_:
        mod.main(["--help"])
    assert exit_.value.code == 0 and flag in capsys.readouterr().out
