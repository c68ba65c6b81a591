"""The port's resumable checkpoints (`convolutional_diffusion_tpu_torch
.utils.checkpoint`) and resume through `training.train_diffusion`, on the
CPU. A resumed run equals an unbroken one bit for bit here: the CPU's
float32 kernels are deterministic, and the checkpoint holds the random
streams."""

import os

import pytest
import torch

from convolutional_diffusion_tpu.utils.checkpoint import (
    reference_checkpoint_name as jax_reference_checkpoint_name,
)
from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch import training as ttraining
from convolutional_diffusion_tpu_torch.utils.checkpoint import (
    CHECKPOINT_FILE,
    reference_checkpoint_name,
    restore_checkpoint,
    save_checkpoint,
)


def _model(seed=0, normalization=None):
    net = tmodels.MinimalUNet(channels=1, fsizes=(8, 16), emb_dim=16, mode="zeros",
                              normalization=normalization)
    return tmodels.DiffusionModel(net, in_channels=1, default_imsize=8, seed=seed,
                                  device="cpu")


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_round_trip(tmp_path, tiny_dataset):
    """Weights, AdamW moments, the schedule, the random streams and the
    metadata come back as they were saved."""
    state, _ = ttraining.train_diffusion(
        _model(), tiny_dataset, ttraining.TrainConfig(epochs=1, batch_size=8),
        log_fn=lambda s: None)
    path = save_checkpoint(str(tmp_path / "ck"), **state.payload(), step=state.step, epoch=1,
                           extra={"model_config": "{}", "note": "x"})
    assert path == str(tmp_path / "ck" / f"step_{state.step}")
    blob = restore_checkpoint(path)
    assert blob["meta"] == {"step": 2, "epoch": 1, "model_config": "{}", "note": "x"}
    _assert_state_equal(blob["state"]["params"], state.model.backbone.state_dict())
    saved, live = blob["state"]["opt_state"], state.optimizer.state_dict()
    assert saved["param_groups"] == live["param_groups"]
    for i, entry in live["state"].items():
        _assert_state_equal(saved["state"][i], entry)
    assert blob["state"]["sched"] == state.scheduler.state_dict()
    assert torch.equal(blob["state"]["rng"]["torch"], state.generator.get_state())
    fresh = ttraining.TrainState(_model(seed=1), ttraining.TrainConfig())
    fresh.load(blob)
    assert fresh.step == 2 and fresh.rng.randint(1 << 30) == state.rng.randint(1 << 30)
    _assert_state_equal(fresh.model.backbone.state_dict(), state.model.backbone.state_dict())


def test_latest_step_is_picked_and_other_entries_skipped(tmp_path):
    params = _model().backbone.state_dict()
    root = tmp_path / "ck"
    for step in (3, 11, 7):
        save_checkpoint(str(root), params=params, step=step)
    (root / "step_99.tmp-123").mkdir()  # an interrupted save
    (root / "step_final").mkdir()
    (root / "notes.txt").write_text("")
    assert restore_checkpoint(str(root))["meta"]["step"] == 11
    assert restore_checkpoint(str(root / "step_3"))["meta"]["step"] == 3
    assert sorted(os.listdir(root / "step_11")) == [CHECKPOINT_FILE]


def test_save_replaces_a_step_and_leaves_no_temporaries(tmp_path):
    root = tmp_path / "ck"
    a, b = _model(seed=0).backbone.state_dict(), _model(seed=1).backbone.state_dict()
    save_checkpoint(str(root), params=a, step=5)
    save_checkpoint(str(root), params=b, step=5, epoch=2)
    assert sorted(os.listdir(root)) == ["step_5"]
    blob = restore_checkpoint(str(root))
    assert blob["meta"] == {"step": 5, "epoch": 2}
    _assert_state_equal(blob["state"]["params"], b)


def test_directory_without_a_checkpoint_is_refused(tmp_path):
    (tmp_path / "orbax_like" / "step_4").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        restore_checkpoint(str(tmp_path / "orbax_like"))
    with pytest.raises(ValueError, match=CHECKPOINT_FILE):
        restore_checkpoint(str(tmp_path))


@pytest.mark.parametrize("normalization", [None, "BatchNorm"])
def test_resume_equals_an_unbroken_run(tmp_path, tiny_dataset, normalization):
    """Two epochs straight against one epoch, a checkpoint, a restore into
    a fresh model (other initial weights) and one more epoch: the same
    weights, BatchNorm statistics, AdamW state, schedule and loss, bit for
    bit."""
    config = ttraining.TrainConfig(epochs=2, batch_size=4, lr=3e-3, gamma=0.9, log_every=1,
                                   save_interval=1, seed=3)
    whole, hist = ttraining.train_diffusion(_model(normalization=normalization), tiny_dataset,
                                            config, log_fn=lambda s: None)
    half = ttraining.TrainConfig(**{**config.__dict__, "epochs": 1})
    ttraining.train_diffusion(_model(normalization=normalization), tiny_dataset, half,
                              checkpoint_dir=str(tmp_path / "ck"), log_fn=lambda s: None)
    resumed, hist2 = ttraining.train_diffusion(
        _model(seed=9, normalization=normalization), tiny_dataset, half,
        resume_from=str(tmp_path / "ck"), log_fn=lambda s: None)
    assert resumed.step == whole.step == 8 and hist2 == hist[1:]
    _assert_state_equal(resumed.model.backbone.state_dict(), whole.model.backbone.state_dict())
    a, b = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i in a["state"]:
        _assert_state_equal(a["state"][i], b["state"][i])
    assert resumed.scheduler.state_dict() == whole.scheduler.state_dict()


@pytest.mark.parametrize("args,kw", [
    (("CIFAR10", "ResNet", "zeros"), {"conditional": True}),
    (("mnist", "UNet", "circular"), {}),
    (("celeba", "UNet", "zeros"), {"conditional": True, "suffix": "_64x64"}),
])
def test_reference_checkpoint_name_matches_jax(args, kw):
    assert reference_checkpoint_name(*args, **kw) == jax_reference_checkpoint_name(*args, **kw)
