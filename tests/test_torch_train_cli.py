"""The port's train CLIs and the training half of `cli/common.py` on the CPU:
`cli.train --cpu` end to end on a tiny synthetic set, then `load_model` and
`cli.sample` on its checkpoint directory; checkpoint names, architecture
metadata and the torch export against the JAX package's for the same
flags and weights (exactly); `cli.train_64x64`'s name and layer cap."""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu import models as jmodels
from convolutional_diffusion_tpu.cli import common as jcommon
from convolutional_diffusion_tpu_torch import convert as tconvert
from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch.cli import common as tcommon
from convolutional_diffusion_tpu_torch.cli import sample as sample_cli
from convolutional_diffusion_tpu_torch.cli import train as train_cli
from convolutional_diffusion_tpu_torch.cli import train_64x64 as train64_cli
from convolutional_diffusion_tpu_torch.utils.checkpoint import restore_checkpoint

TRAIN_ARGS = ["--cpu", "--dataset", "synthetic", "--epochs", "1", "--layers", "2",
              "--mult", "1", "--batchsize", "32", "--maxsamps", "64", "--mode", "zeros",
              "--conditional", "--saveinterval", "1", "--suppress"]


def test_train_cli_end_to_end(tmp_path):
    """The checkpoint directory carries the JAX CLI's name, the final step
    epochs * (N // batch) with the architecture in its metadata; it loads
    through `load_model` and samples through `cli.sample`; --export_torch
    writes the backbone's state_dict."""
    export = tmp_path / "export.pt"
    state = train_cli.main(TRAIN_ARGS + ["--homedir", str(tmp_path), "--export_torch",
                                         str(export)])
    name = "MinimalUNet_synthetic_zeros_lr_0.0001_batchsize_32_wd_0_maxsamps_64_conditional_nonorm"
    ckpt = tmp_path / name
    # 256 images cut to 64: 4x the epochs and the save interval, 2 steps each
    assert sorted(os.listdir(ckpt)) == ["step_8"] and state.step == 8
    blob = restore_checkpoint(str(ckpt))
    cfg = json.loads(blob["meta"]["model_config"])
    assert cfg["kind"] == "MinimalUNet" and cfg["fsizes"] == [32, 64]
    model = tcommon.load_model(str(ckpt), device="cpu")
    assert not model.training and model.conditional and model.default_imsize == 32
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, state.model.backbone.state_dict()[k]), k
    exported = torch.load(export, weights_only=True)
    assert exported.keys() == model.backbone.state_dict().keys()
    out = sample_cli.main(["--cpu", "--modelfile", str(ckpt), "--conditional", "--nsamples",
                           "4", "--nsteps", "3", "--out", str(tmp_path / "s.png")])
    assert out.shape == (4, 32, 32, 3) and np.isfinite(out).all()


def test_train_cli_needs_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in TRAIN_ARGS if a != "--cpu"] + ["--homedir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(args)


@pytest.mark.parametrize("cli", [train_cli, train64_cli], ids=["train", "train_64x64"])
def test_ndevices_above_one_raises(cli):
    """Outside a group --ndevices 2 starts one rank per card: more ranks
    than the visible cards (none here) raises before anything runs (with
    --cpu it trains over two gloo ranks, tests/test_torch_multihost.py)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible: --ndevices 2 trains")
    with pytest.raises(ValueError, match="2 ranks need 2 CUDA devices"):
        cli.main(["--dataset", "synthetic", "--ndevices", "2"])


def test_train_64x64_name_and_layer_cap(monkeypatch, tmp_path):
    seen = {}

    def fake_run(args, backbone, ds, factor, ckpt_dir, imsize):
        seen.update(backbone=backbone, ckpt_dir=ckpt_dir, imsize=imsize, shape=ds.images.shape)

    monkeypatch.setattr(train64_cli, "run", fake_run)
    train64_cli.main(["--cpu", "--dataset", "synthetic", "--layers", "6", "--conditional",
                      "--homedir", str(tmp_path)])
    assert seen["backbone"].fsizes == (64, 128, 256, 512)
    assert seen["ckpt_dir"] == str(tmp_path / "backbone_synthetic_UNet_zeros_64x64_conditional")
    assert seen["imsize"] == 64 and seen["shape"][1:] == (64, 64, 3)
    train64_cli.main(["--cpu", "--dataset", "synthetic", "--layers", "2", "--resnet",
                      "--homedir", str(tmp_path)])
    assert isinstance(seen["backbone"], tmodels.MinimalResNet)
    assert seen["backbone"].num_layers == 2 and seen["backbone"].emb_dim == 256
    assert seen["ckpt_dir"].endswith("backbone_synthetic_ResNet_zeros_64x64")


@pytest.mark.parametrize("flags", [
    dict(resnet=True, mode="zeros", lr=0.0001, batchsize=128, wd=0, maxsamps=100000,
         conditional=True, nonorm=True, mult=2),
    dict(resnet=False, mode="circular", lr=0.001, batchsize=64, wd=0.01, maxsamps=5000,
         conditional=False, nonorm=False, mult=1),
])
@pytest.mark.parametrize("subset_flag", [False, True])
def test_checkpoint_name_matches_jax(flags, subset_flag):
    args = argparse.Namespace(**flags)
    meta = {"name": "cifar10"}
    assert (tcommon.checkpoint_name_from_flags(meta, args, subset_flag)
            == jcommon.checkpoint_name_from_flags(meta, args, subset_flag))


ARCHS = {
    "resnet": dict(channels=3, emb_dim=32, mode="zeros", normalization="GroupNorm",
                   conditional=True, num_classes=10, kernel_size=3, num_layers=2,
                   lastksize=3),
    "resnet_plain": dict(channels=1, emb_dim=16, num_layers=1),
    "unet": dict(channels=3, fsizes=(8, 16, 32), mode="circular", conditional=True,
                 num_classes=10, emb_dim=16, normalization="GroupNorm", last_norm=True,
                 lastksize=3),
    "unet_bn": dict(channels=3, fsizes=(8, 16), emb_dim=16, mode="zeros",
                    normalization="BatchNorm", last_norm=True),
    "unet_cli": dict(channels=3, fsizes=(8, 16), mode="zeros", conditional=True,
                     num_classes=10, emb_dim=16, lastksize=3),
}


def _nets(kind):
    cls = "MinimalResNet" if kind.startswith("resnet") else "MinimalUNet"
    return getattr(jmodels, cls)(**ARCHS[kind]), getattr(tmodels, cls)(**ARCHS[kind])


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_model_config_meta_matches_jax(kind):
    jnet, tnet = _nets(kind)
    assert tcommon.model_config_meta(tnet, 3, 32) == jcommon.model_config_meta(jnet, 3, 32)


@pytest.mark.parametrize("kind", ["resnet", "resnet_plain", "unet_cli", "unet_bn"])
def test_export_matches_jax_export(kind, tmp_path):
    """JAX params carried into the port's backbone and exported equal the
    JAX package's export of the same params, key by key (BatchNorm's
    num_batches_tracked, which JAX writes as 0, included)."""
    arch = ARCHS[kind]
    jnet, tnet = _nets(kind)
    jmodel = jmodels.DiffusionModel(jnet, in_channels=arch["channels"], default_imsize=16)
    variables = jax.tree_util.tree_map(np.asarray,
                                       jmodel.init_variables(jax.random.PRNGKey(2)))
    resnet = kind.startswith("resnet")
    norm = arch.get("normalization")
    if resnet:
        layers = arch["num_layers"]
        sd = tconvert.resnet_state_dict_from_jax_params(
            variables["params"], num_layers=layers, normalization=norm,
            conditional=arch.get("conditional", False))
        jparams = variables["params"]
    else:
        layers = len(arch["fsizes"])
        sd = tconvert.unet_state_dict_from_jax_params(
            variables, n_feature_blocks=layers - 1, normalization=norm,
            conditional=arch.get("conditional", False),
            last_norm=arch.get("last_norm", False))
        jparams = variables
    tnet.load_state_dict(sd, strict=True)
    tcommon.export_torch_state_dict(tnet, path=str(tmp_path / "port.pt"), log=lambda s: None)
    if norm == "BatchNorm":
        # the JAX CLI export knows GroupNorm or none (its flags); a
        # BatchNorm UNet goes through the exporter it calls
        from convolutional_diffusion_tpu import convert as jconvert

        jconvert.save_torch_state_dict(
            jconvert.unet_state_dict_from_params(
                jparams, n_feature_blocks=layers - 1, normalization=norm, last_norm=True),
            str(tmp_path / "jax.pt"))
    else:
        jcommon.export_torch_state_dict(
            jparams, resnet, layers=layers, nonorm=norm is None,
            conditional=arch.get("conditional", False), path=str(tmp_path / "jax.pt"),
            log=lambda s: None)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
