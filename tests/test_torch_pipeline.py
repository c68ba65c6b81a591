"""The port's artifact pipeline (`pipeline.py`) against the JAX package's:
layout, resume, --fill, conditional generation, .pt interop and the
correlation evaluation, on the CPU at 8x8 with 5-step machines.

Tolerances: outputs of the two packages' machines over the same seeds at
1e-3 relative to scale (fp32 on both sides, other summation orders, five
steps); evaluate_correlations on the same artifacts at 1e-6 (the same numpy
arithmetic)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.scores as jscores
from convolutional_diffusion_tpu import pipeline as jpipeline
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
from convolutional_diffusion_tpu_torch import convert, pipeline
from convolutional_diffusion_tpu_torch.cli.els import load_scales_any
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import (
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)

SCALES = [3, 3, 3, 3, 3]
QUIET = dict(log_fn=lambda s: None)


@pytest.fixture(scope="module")
def dataset():
    imgs = np.random.RandomState(3).uniform(-1, 1, (24, 8, 8, 1)).astype(np.float32)
    labs = np.random.RandomState(4).randint(0, 3, (24,)).astype(np.int32)
    return imgs, labs


def _machine(dataset, cls=LocalEquivBordersScoreModule, batch_size=24):
    mod = cls(dataset, kernel_size=3, batch_size=batch_size, device="cpu")
    return ScheduledScoreMachine(mod, in_channels=1, imsize=8, scales=SCALES)


def _gen(machine, out, **kw):
    return pipeline.generate_els_samples(machine, out, in_channels=1, image_size=8,
                                         **QUIET, **kw)


def _load(out, sub, i):
    return np.load(os.path.join(out, sub, f"{i:04d}.npy"))


def _close(a, b, rel=1e-3):
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def test_generate_layout_and_resume(dataset, tmp_path):
    machine = _machine(dataset)
    out = str(tmp_path / "exp")
    assert _gen(machine, out, numiters=4, batch=2) == 4
    for i in range(4):
        for sub in ("seeds", "els_outputs"):
            assert os.path.exists(os.path.join(out, sub, f"{i:04d}.npy"))
    assert _load(out, "seeds", 0).shape == (1, 8, 8, 1)
    o3 = _load(out, "els_outputs", 3)
    # resume: delete one output, regenerate only the tail, with the same seeds
    os.remove(os.path.join(out, "els_outputs", "0002.npy"))
    s3 = _load(out, "seeds", 3)
    assert _gen(machine, out, numiters=4, batch=2) == 2
    np.testing.assert_array_equal(_load(out, "seeds", 3), s3)
    np.testing.assert_array_equal(_load(out, "els_outputs", 3), o3)
    assert _gen(machine, out, numiters=4, batch=2) == 0  # complete: nothing to do
    # force_overwrite regenerates everything, seeds unchanged (one per index)
    assert _gen(machine, out, numiters=4, force_overwrite=True) == 4
    np.testing.assert_array_equal(_load(out, "seeds", 3), s3)
    assert _gen(machine, str(tmp_path / "other"), numiters=1, seed=1) == 1
    assert not np.array_equal(_load(str(tmp_path / "other"), "seeds", 0), _load(out, "seeds", 0))


@pytest.mark.parametrize("cls", [LocalEquivScoreModule, LocalEquivBordersScoreModule],
                         ids=["ELS-one-sweep", "bbELS-grouped"])
def test_conditional_batched_generation(dataset, tmp_path, cls):
    """batch 1 against batch 6, index for index: with ELS, one per-seed
    sweep of six labels against one-seed calls; with bbELS, seeds grouped
    by label against one-seed calls. The same seeds and labels either way."""
    machine = _machine(dataset, cls=cls, batch_size=10)
    outs = [str(tmp_path / "a"), str(tmp_path / "b")]
    for out, bs in zip(outs, (1, 6)):
        _gen(machine, out, numiters=6, conditional=True, nlabels=3, batch=bs)
    labels = [int(_load(outs[1], "labels", i)[0]) for i in range(6)]
    assert len(set(labels)) > 1  # a real label vector
    for i in range(6):
        np.testing.assert_array_equal(_load(outs[0], "labels", i), _load(outs[1], "labels", i))
        np.testing.assert_array_equal(_load(outs[0], "seeds", i), _load(outs[1], "seeds", i))
        np.testing.assert_allclose(_load(outs[0], "els_outputs", i),
                                   _load(outs[1], "els_outputs", i), rtol=2e-4, atol=1e-5)


def test_fill_mode(dataset, tmp_path):
    machine = _machine(dataset)
    out = str(tmp_path / "exp")
    _gen(machine, out, numiters=3)
    assert _gen(machine, out, numiters=3, idealname="ideal", fill=True, batch=2) == 3
    for i in range(3):  # the same machine over the same seeds
        _close(_load(out, "ideal", i), _load(out, "els_outputs", i), rel=1e-6)
    assert _gen(machine, out, numiters=3, idealname="ideal", fill=True) == 0
    with pytest.raises(FileNotFoundError):
        _gen(machine, str(tmp_path / "none"), numiters=1, fill=True)
    with pytest.raises(FileNotFoundError, match="labels"):
        _gen(machine, out, numiters=3, idealname="cond", fill=True, conditional=True)


def test_pt_interop_roundtrip(tmp_path):
    """.pt artifacts read back, whichever package wrote them; an NCHW
    reference artifact turns NHWC on load."""
    arr = np.random.RandomState(0).normal(size=(1, 1, 8, 8)).astype(np.float32)
    pipeline.save_array(str(tmp_path / "x"), arr, fmt="pt")
    back = pipeline.load_array(str(tmp_path / "x"))
    np.testing.assert_array_equal(arr, back)
    np.testing.assert_array_equal(jpipeline.load_array(str(tmp_path / "x")), arr)
    jpipeline.save_array(str(tmp_path / "y"), arr, fmt="pt")
    np.testing.assert_array_equal(pipeline.load_array(str(tmp_path / "y")), arr)
    pipeline.save_array(str(tmp_path / "z"), torch.from_numpy(arr))
    np.testing.assert_array_equal(pipeline.load_array(str(tmp_path / "z")), arr)
    assert pipeline.load_array(str(tmp_path / "missing")) is None
    assert pipeline._nchw_to_nhwc_if_needed(back, channels=1).shape == (1, 8, 8, 1)
    nhwc = np.zeros((1, 8, 8, 3), np.float32)
    assert pipeline._nchw_to_nhwc_if_needed(nhwc, channels=3) is nhwc


def test_pt_scales(tmp_path):
    scales = [3, 5, 7, 9]
    torch.save(scales, tmp_path / "list.pt")
    torch.save(torch.tensor(scales), tmp_path / "tensor.pt")
    torch.save([torch.tensor(s) for s in scales], tmp_path / "tensors.pt")
    np.save(tmp_path / "s.npy", np.asarray(scales))
    with open(tmp_path / "s.json", "w") as f:
        json.dump(scales, f)
    from convolutional_diffusion_tpu.convert import load_scales as jload

    for name in ("list.pt", "tensor.pt", "tensors.pt", "s.npy", "s.json"):
        path = str(tmp_path / name)
        assert convert.load_scales(path) == scales == load_scales_any(path)
        if name.endswith(".pt"):
            assert jload(path) == scales


def test_auto_detect_scales(tmp_path):
    ck = tmp_path / "checkpoints"
    ck.mkdir()
    (ck / "scales_MNIST_ResNet_zeros.pt").write_bytes(b"x")
    (ck / "scales_CIFAR10_UNet_zeros_conditional.json").write_text("[3]")
    for name in ("mnist", "cifar10"):
        assert pipeline.auto_detect_scales(str(ck), name) == \
            jpipeline.auto_detect_scales(str(ck), name)
    with pytest.raises(FileNotFoundError):
        pipeline.auto_detect_scales(str(ck), "celeba")


@pytest.mark.parametrize("kind", ["ELS", "bbELS", "IS"])
def test_fill_over_jax_written_seeds(dataset, tmp_path, kind):
    """Conditional seeds and labels written by the JAX pipeline (its own
    machine's outputs beside them); the port's --fill over them, built by
    each package's `build_score_module` (ELS: one per-seed sweep per batch;
    bbELS and IS: seeds grouped by label), matches the JAX machine's
    outputs."""
    from convolutional_diffusion_tpu.cli.common import build_score_module as jbuild
    from convolutional_diffusion_tpu_torch.cli.common import build_score_module

    out = str(tmp_path / "exp")
    kw = dict(batch_size=10, image_size=8, channels=1, max_samples=100)
    jm = jscores.ScheduledScoreMachine(jbuild(kind, dataset, schedule=jcos, **kw),
                                       in_channels=1, imsize=8, scales=SCALES)
    jpipeline.generate_els_samples(jm, out, numiters=5, in_channels=1, image_size=8,
                                   conditional=True, nlabels=3, batch=5, **QUIET)
    tm = ScheduledScoreMachine(
        build_score_module(kind, dataset, schedule=cosine_noise_schedule, device="cpu",
                           **kw), in_channels=1, imsize=8, scales=SCALES)
    assert pipeline.generate_els_samples(
        tm, out, numiters=5, in_channels=1, image_size=8, conditional=True,
        idealname="port", fill=True, batch=5, **QUIET) == 5
    for i in range(5):
        _close(_load(out, "port", i), _load(out, "els_outputs", i))


def test_evaluate_correlations_matches_jax(dataset, tmp_path):
    machine = _machine(dataset)
    out = str(tmp_path / "exp")
    _gen(machine, out, numiters=3, conditional=True, nlabels=3, batch=3)
    ideal = ScheduledScoreMachine(
        LocalEquivScoreModule(dataset, kernel_size=3, batch_size=24, device="cpu"),
        in_channels=1, imsize=8, scales=SCALES)
    _gen(ideal, out, numiters=3, idealname="ideal", fill=True, conditional=True)
    w = np.random.RandomState(9).normal(size=(8, 8, 1)).astype(np.float32)

    def sample_fn(x, labels):
        return np.tanh(np.asarray(x) * w) + np.asarray(labels, np.float32)[:, None, None, None]

    kw = dict(conditional=True, channels=1)
    ours = pipeline.evaluate_correlations(out, sample_fn, **kw)
    want = jpipeline.evaluate_correlations(out, sample_fn, **kw)
    assert ours["n"] == want["n"] == 3
    for key in ("ideal_corrs", "target_corrs", "median_ideal", "median_target",
                "frac_els_beats_is"):
        np.testing.assert_allclose(ours[key], want[key], rtol=0, atol=1e-6)
    os.remove(os.path.join(out, "ideal", "0001.npy"))  # the complete prefix only
    assert pipeline.evaluate_correlations(out, sample_fn, **kw)["n"] == 1
