"""Port vs the torch-reference goldens and vs JAX: the IS module (the exact
score of the empirical distribution), on the CPU.

Tolerances: the goldens at the JAX tests' own atol 2e-4 relative to scale
(`tests/test_scores.py`, `tests/test_cutoffs.py`); the port against the
JAX module at 2e-4 relative to scale (both fp32, summed in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.scores as jscores
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
from convolutional_diffusion_tpu_torch.scores import IdealScoreModule, ScheduledScoreMachine


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


@pytest.fixture(scope="module")
def z():
    return np.load("tests/goldens/scores.npz")


@pytest.fixture(scope="module")
def zc():
    return np.load("tests/goldens/cutoffs.npz")


def _check(ours, expect, atol=2e-4):
    scale = max(np.nanmax(np.abs(expect)), 1.0)
    np.testing.assert_allclose(np.asarray(ours), expect, atol=atol * scale)


def _data(z, prefix=""):
    key = (lambda s: f"{prefix}{s}16") if prefix else (lambda s: s)
    return (_nhwc(z[key("imgs")]), z[key("labs")].astype(np.int32), _nhwc(z[key("x")]),
            float(z["t"][0]))


@pytest.mark.parametrize("key,kw,call", [
    ("is/b5", dict(batch_size=5), {}),
    ("is/b12", dict(batch_size=12), {}),
    ("is/label1", dict(batch_size=5), dict(label=1)),
    ("is/max8", dict(batch_size=5, max_samples=8), {}),
    ("gray/is", dict(batch_size=4), {}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_scores_goldens(z, key, kw, call):
    imgs, labs, x, t = _data(z, "gray/" if key.startswith("gray") else "")
    mod = IdealScoreModule((imgs, labs), device="cpu", **kw)
    _check(mod(t, x, **call), _nhwc(z[f"{key}/out"]))


@pytest.mark.parametrize("key,max_samples,label", [
    ("is/max11", 11, None), ("is/label1max6", 6, 1),
])
def test_cutoff_goldens(zc, key, max_samples, label):
    imgs, labs, x, t = _data(zc)
    mod = IdealScoreModule((imgs, labs), batch_size=5, max_samples=max_samples,
                           device="cpu")
    _check(mod(t, x, label=label), _nhwc(zc[f"{key}/out"]))


CASES = {
    "plain": (dict(), dict()),
    "label": (dict(), dict(label=2)),
    "max_samples": (dict(max_samples=9), dict(label=1)),
    "order": (dict(max_samples=10), dict(order=np.random.RandomState(3).permutation(16))),
    "chunk": (dict(chunk_size=3), dict()),
}


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_module(tiny_dataset, case):
    imgs, labs = tiny_dataset
    ctor, call = CASES[case]
    x = np.random.RandomState(5).normal(size=(3, 8, 8, 1)).astype(np.float32)
    jmod = jscores.IdealScoreModule((imgs, labs), batch_size=5, schedule=jcos, **ctor)
    ours = IdealScoreModule((imgs, labs), batch_size=5, device="cpu", **ctor)
    for t in (0.05, 0.5, 0.95):
        _check(ours(t, x, **call), np.asarray(jmod(t, jnp.asarray(x), **call)))


def test_any_kernel_size_and_scalar_labels_only(tiny_dataset):
    imgs, labs = tiny_dataset
    mod = IdealScoreModule((imgs, labs), batch_size=5, device="cpu")
    x = np.random.RandomState(6).normal(size=(2, 8, 8, 1)).astype(np.float32)
    torch.testing.assert_close(mod(0.4, x, k=4), mod(0.4, x, k=17), rtol=0, atol=0)
    with pytest.raises(ValueError, match="scalar label"):
        mod(0.4, x, label=np.array([0, 1]))


def test_machine_matches_jax_machine(tiny_dataset):
    """A 6-step IS machine: the port's trajectory against the JAX one."""
    imgs, labs = tiny_dataset
    x = np.random.RandomState(7).normal(size=(2, 8, 8, 1)).astype(np.float32)
    scales = [3, 5, 7, 3, 5, 7]
    jm = jscores.ScheduledScoreMachine(
        jscores.IdealScoreModule((imgs, labs), batch_size=16, schedule=jcos),
        in_channels=1, imsize=8, scales=scales)
    tm = ScheduledScoreMachine(IdealScoreModule((imgs, labs), batch_size=16, device="cpu"),
                               in_channels=1, imsize=8, scales=scales)
    _check(tm(x), np.asarray(jm(jnp.asarray(x))), atol=5e-4)
