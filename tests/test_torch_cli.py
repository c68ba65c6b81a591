"""The port's CLI (`convolutional_diffusion_tpu_torch.cli`): importable,
--help exits 0, and tiny --cpu runs on the synthetic dataset that mirror
the JAX package's CLI test (bbELS generation, then IS --fill), plus a
conditional ELS run (one per-seed sweep per batch)."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

CLI_MODULES = ["els"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", CLI_MODULES)
def test_importable(name):
    mod = importlib.import_module(f"convolutional_diffusion_tpu_torch.cli.{name}")
    assert callable(mod.main)


@pytest.mark.parametrize("name", CLI_MODULES)
def test_help_exits_zero(name):
    r = subprocess.run(
        [sys.executable, "-m", f"convolutional_diffusion_tpu_torch.cli.{name}", "--help"],
        capture_output=True, env=dict(os.environ, PYTHONPATH=ROOT), timeout=240,
    )
    assert r.returncode == 0, r.stderr.decode()[-500:]
    assert b"--scoremoduletype" in r.stdout and b"--cpu" in r.stdout


def _common(tmp_path, scales=(3, 3, 3, 3, 3)):
    ck = tmp_path / "checkpoints"
    ck.mkdir(exist_ok=True)
    with open(ck / "scales_SYNTHETIC_ResNet_zeros.json", "w") as f:
        json.dump(list(scales), f)
    return [
        "--dataset", "synthetic", "--numiters", "3", "--cpu",
        "--checkpoints", str(ck), "--results", str(tmp_path / "results"),
        "--expname", "exp", "--scorebatchsize", "64",
    ]


def test_els_cli_generation_and_ideal_fill(tmp_path):
    from convolutional_diffusion_tpu_torch.cli import els

    common = _common(tmp_path)  # scales found by auto-detection
    assert els.main(common + ["--scoremoduletype", "bbELS", "--batch", "3"]) == 3
    assert els.main(common + ["--scoremoduletype", "IS", "--idealname", "ideal",
                              "--fill"]) == 3
    exp = tmp_path / "results" / "exp"
    for sub in ("seeds", "els_outputs", "ideal"):
        assert sorted(os.listdir(exp / sub)) == [f"{i:04d}.npy" for i in range(3)]
    out = np.load(exp / "ideal" / "0000.npy")
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()


def test_els_cli_conditional(tmp_path):
    from convolutional_diffusion_tpu_torch.cli import els

    common = _common(tmp_path, scales=(3, 3, 5))
    assert els.main(common + ["--scoremoduletype", "ELS", "--conditional", "--batch", "3",
                              "--expname", "cond", "--fmt", "pt"]) == 3
    exp = tmp_path / "results" / "cond"
    for sub in ("seeds", "els_outputs", "labels"):
        assert sorted(os.listdir(exp / sub)) == [f"{i:04d}.pt" for i in range(3)]
    assert els.main(common + ["--scoremoduletype", "ELS", "--conditional",
                              "--expname", "cond"]) == 0  # resume: all done


@pytest.mark.parametrize("kind", ["ELS", "bbELS"])
def test_els_cli_default_precision(tmp_path, kind):
    """--precision default (the bf16-exp tier, K3/K4 on the card) runs the
    plain version under --cpu: conditional ELS (one per-seed sweep per
    batch) and bbELS, with the layout and finite outputs."""
    from convolutional_diffusion_tpu_torch.cli import els

    common = _common(tmp_path, scales=(3, 3))  # one machine call
    common[common.index("--numiters") + 1] = "1"
    assert els.main(common + ["--scoremoduletype", kind, "--conditional",
                              "--precision", "default"]) == 1
    exp = tmp_path / "results" / "exp"
    for sub in ("seeds", "els_outputs", "labels"):
        assert os.listdir(exp / sub) == ["0000.npy"]
    out = np.load(exp / "els_outputs" / "0000.npy")
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()


def test_els_cli_refuses_what_is_not_ported(tmp_path):
    from convolutional_diffusion_tpu_torch.cli import els

    # --ndevices 2 outside a group starts one rank per card: more than the
    # visible cards (none here) is refused before anything runs
    no_cpu = [a for a in _common(tmp_path) if a != "--cpu"]
    with pytest.raises(ValueError, match="2 ranks need 2 CUDA devices"):
        els.main(no_cpu + ["--ndevices", "2"])
    with pytest.raises(ValueError, match="scoremoduletype"):
        els.main(_common(tmp_path) + ["--scoremoduletype", "XYZ"])


@pytest.mark.parametrize("kind", ["ELS", "bbELS", "LS", "IS"])
def test_build_score_module_matches_jax(tiny_dataset, kind):
    """The factory gives the same module class and settings as the JAX
    package's: max_samples and batch size per kind, shuffle only for ELS."""
    from convolutional_diffusion_tpu.cli.common import build_score_module as jbuild
    from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
    from convolutional_diffusion_tpu_torch.cli.common import build_score_module
    from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule

    kw = dict(batch_size=5, image_size=8, channels=1, max_samples=9, shuffle=True,
              precision="high", target_block=100)
    ours = build_score_module(kind, tiny_dataset, schedule=cosine_noise_schedule,
                              device="cpu", **kw)
    want = jbuild(kind, tiny_dataset, schedule=jcos, **kw)
    assert type(ours).__name__ == type(want).__name__
    for attr in ("batch_size", "max_samples", "shuffle", "precision", "kernel_size"):
        assert getattr(ours, attr) == getattr(want, attr), attr
    assert getattr(ours, "target_block", None) == getattr(want, "target_block", None)
