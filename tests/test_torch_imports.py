"""The port stands alone: importing every module of
`convolutional_diffusion_tpu_torch` loads neither `jax` nor the JAX package,
and entry points run on `cuda` unless told otherwise — without a card they
raise instead of running on the CPU."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu_torch import convert
from convolutional_diffusion_tpu_torch.cli.common import build_score_module
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import (
    IdealScoreModule,
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    LocalScoreModule,
)
from convolutional_diffusion_tpu_torch.scores.bank import bank_geometry
from convolutional_diffusion_tpu_torch.scores.base import resolve_device

_PROBE = r"""
import importlib, json, pkgutil, sys
import convolutional_diffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
def hit(mod, root):
    return mod == root or mod.startswith(root + ".")
print(json.dumps({
    "imported": names,
    "forbidden": sorted(m for m in sys.modules
                        if hit(m, "jax") or hit(m, "jaxlib")
                        or hit(m, "convolutional_diffusion_tpu")),
}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        check=True, timeout=120,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("scores.els", "scores.bbels", "scores.local", "scores.ideal", "data",
                "pipeline", "convert", "cli.common", "cli.els", "models", "models.ddim",
                "models.embedding", "models.layers", "models.resnet", "models.unet",
                "sampling", "calibration", "cli.sample", "cli.calibrate",
                "utils.visualize", "training", "utils.checkpoint", "cli.train",
                "cli.train_64x64", "parallel", "parallel.mesh", "parallel.sharded_score"):
        assert f"convolutional_diffusion_tpu_torch.{mod}" in res["imported"]
    for mod in ("ops.flash_score", "ops.prune"):
        assert f"convolutional_diffusion_tpu_torch.{mod}" in res["imported"]
    assert res["forbidden"] == []


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(monkeypatch, tiny_dataset):
    _no_cuda(monkeypatch)
    for cls in (LocalEquivScoreModule, LocalEquivBordersScoreModule, LocalScoreModule,
                IdealScoreModule):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(tiny_dataset)
    for kind in ("ELS", "bbELS", "LS", "IS"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_score_module(kind, tiny_dataset, batch_size=4, image_size=8, channels=1,
                               schedule=cosine_noise_schedule)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    g = bank_geometry(1, 4, 4, 1, 3, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.bank_from_jax_numpy(np.zeros((1, g.block * g.d)), np.zeros((1, g.block)),
                                    np.zeros((1, g.block)), g)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.clustered_bank_from_jax_numpy(
            np.zeros((1, g.block * g.d)), np.zeros((1, g.block)), np.zeros((1, g.block)),
            np.zeros((1, g.block), np.int32), np.zeros((1, g.d)), np.zeros(1),
            np.ones(1, bool), g)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_explicit_cpu_runs_on_cpu(tiny_dataset):
    mod = LocalEquivScoreModule(tiny_dataset, device="cpu")
    assert mod.images.device.type == "cpu"
    out = mod(0.5, np.zeros((1, 8, 8, 1), np.float32))
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    for kind in ("ELS", "bbELS", "LS", "IS"):
        mod = build_score_module(kind, tiny_dataset, batch_size=4, image_size=8, channels=1,
                                 schedule=cosine_noise_schedule, device="cpu")
        assert mod.images.device.type == "cpu"


def test_neural_entry_points_need_a_card_unless_told(monkeypatch, tiny_dataset):
    """load_model, DiffusionModel, sample and calibrate run on cuda by
    default: without a card they raise; with device="cpu" they run."""
    from convolutional_diffusion_tpu_torch.calibration import calibrate
    from convolutional_diffusion_tpu_torch.cli.common import load_model
    from convolutional_diffusion_tpu_torch.models import DiffusionModel, MinimalResNet
    from convolutional_diffusion_tpu_torch.sampling import sample

    pickle_path = "tests/goldens/pickles/backbone_resnet_cond.pt"
    model = load_model(pickle_path, device="cpu")
    gen = torch.Generator().manual_seed(0)
    label = torch.zeros(2, dtype=torch.long)
    assert sample(model, batch_size=2, nsteps=2, label=label, generator=gen,
                  device="cpu").device.type == "cpu"
    mods = {3: LocalEquivScoreModule(tiny_dataset, device="cpu")}
    net = MinimalResNet(channels=1, emb_dim=16, num_layers=1)
    cnn = DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu")
    kw = dict(image_size=8, in_channels=1, nsamps=2, nsteps=2)
    assert calibrate(cnn, mods, generator=gen, device="cpu", **kw)["median"].shape == (2,)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(pickle_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionModel(MinimalResNet(channels=1, emb_dim=16, num_layers=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        sample(model, batch_size=2, label=label, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate(cnn, mods, generator=gen, **kw)
