"""Port vs JAX and vs the torch-reference goldens: the LS score module (the
bbELS fallback for k >= image size), on the CPU.

Tolerances: goldens at the JAX tests' own atol 2e-4 relative to scale
(`tests/test_scores.py`, `tests/test_cutoffs.py`); the port vs the JAX
module at 2e-4 relative to scale (both fp32, summed in other orders); the
box sum against `lax.reduce_window` at fp32 rounding (rtol 1e-6).

LS shuffles by default and a torch generator cannot reproduce
`jax.random`: every comparison either has one reference batch (batch_size
>= N, where order is irrelevant), passes an explicit `order`, or sets
shuffle=False."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.scores as jscores
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
from convolutional_diffusion_tpu_torch.schedules import (
    cosine_noise_schedule,
    exponential_schedule,
)
from convolutional_diffusion_tpu_torch.scores import LocalScoreModule
from convolutional_diffusion_tpu_torch.scores.local import box_sum


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


@pytest.fixture(scope="module")
def z():
    return np.load("tests/goldens/scores.npz")


@pytest.fixture(scope="module")
def zc():
    return np.load("tests/goldens/cutoffs.npz")


def _data(z):
    return _nhwc(z["imgs"]), z["labs"].astype(np.int32), _nhwc(z["x"]), float(z["t"][0])


def _check(ours, expect, atol=2e-4):
    scale = max(np.nanmax(np.abs(expect)), 1.0)
    np.testing.assert_allclose(ours.numpy(), expect, atol=atol * scale)


def _port(imgs, labs, **kw):
    return LocalScoreModule((imgs, labs), device="cpu", **kw)


@pytest.mark.parametrize("k", [3, 5])
def test_kernel_size_goldens(z, k):
    imgs, labs, x, t = _data(z)
    mod = _port(imgs, labs, kernel_size=k, batch_size=12, schedule=cosine_noise_schedule)
    _check(mod(t, x), _nhwc(z[f"ls/k{k}/out"]))


def test_exponential_default_schedule_golden(z):
    imgs, labs, x, t = _data(z)
    mod = _port(imgs, labs, kernel_size=3, batch_size=12)
    assert mod.schedule is exponential_schedule and mod.shuffle
    _check(mod(t, x), _nhwc(z["ls/k3exp/out"]))


def test_gray_golden(z):
    imgs, labs = _nhwc(z["gray/imgs16"]), z["gray/labs16"].astype(np.int32)
    mod = _port(imgs, labs, kernel_size=3, batch_size=10, schedule=cosine_noise_schedule)
    _check(mod(float(z["t"][0]), _nhwc(z["gray/x16"])), _nhwc(z["gray/ls_k3/out"]))


@pytest.mark.parametrize("max_samples,label,tag", [
    (8, None, "max8shuf"), (4, 0, "label0max4shuf"),
])
def test_shuffled_cutoff_goldens(zc, max_samples, label, tag):
    """The reference's shuffled stream, replayed through `order`."""
    imgs, labs, x, t = _data(zc)
    mod = _port(imgs, labs, kernel_size=3, batch_size=5,
                schedule=cosine_noise_schedule, max_samples=max_samples)
    _check(mod(t, x, label=label, order=zc[f"ls/{tag}/perm"]), _nhwc(zc[f"ls/{tag}/out"]))


def _x(b, seed=5):
    return np.random.RandomState(seed).normal(size=(b, 8, 8, 1)).astype(np.float32)


JAX_CASES = {
    "plain": (dict(), dict()),
    "label": (dict(), dict(label=2)),
    "max_samples": (dict(max_samples=9), dict()),
    "order": (dict(max_samples=10), dict(order=np.random.RandomState(3).permutation(16))),
    "k5": (dict(), dict(k=5)),
    "k9_wider_than_image": (dict(), dict(k=9)),
    "chunk3": (dict(chunk_size=3), dict()),
    "high": (dict(precision="high"), dict(label=1)),
}


@pytest.mark.parametrize("case", JAX_CASES)
def test_matches_jax_module(tiny_dataset, case):
    imgs, labs = tiny_dataset
    ctor, call = JAX_CASES[case]
    x = _x(3)
    kw = dict(kernel_size=3, batch_size=5, shuffle=False, **ctor)
    jmod = jscores.LocalScoreModule((imgs, labs), schedule=jcos, **kw)
    ours = _port(imgs, labs, schedule=cosine_noise_schedule, **kw)
    for t in (0.05, 0.5, 0.95):
        _check(ours(t, x, **call), np.asarray(jmod(t, jnp.asarray(x), **call)))


@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_box_sum_matches_reduce_window(k):
    a = np.random.RandomState(k).normal(size=(2, 3, 8, 6)).astype(np.float32)
    want = jax.lax.reduce_window(
        jnp.asarray(a), 0.0, jax.lax.add, (1, 1, k, k), (1, 1, 1, 1),
        ((0, 0), (0, 0), (k // 2, k // 2), (k // 2, k // 2)),
    )
    np.testing.assert_allclose(box_sum(torch.from_numpy(a), k).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-5)


def test_chunk_size_does_not_change_the_score(tiny_dataset):
    imgs, labs = tiny_dataset
    kw = dict(kernel_size=3, batch_size=5, max_samples=10, shuffle=False)
    x = _x(2)
    a = _port(imgs, labs, **kw)(0.4, x, label=1)
    b = _port(imgs, labs, chunk_size=3, **kw)(0.4, x, label=1)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert _port(imgs, labs, chunk_size=500, **kw).chunk_size == 500


def test_shuffle_generator_deterministic_and_fresh(tiny_dataset):
    imgs, labs = tiny_dataset
    kw = dict(kernel_size=3, batch_size=5, max_samples=8)
    a = _port(imgs, labs, generator=torch.Generator().manual_seed(4), **kw)
    b = _port(imgs, labs, generator=torch.Generator().manual_seed(4), **kw)
    x = _x(1)
    o1, o2, r1 = a(0.4, x), a(0.4, x), b(0.4, x)
    torch.testing.assert_close(o1, r1, rtol=0, atol=0)
    assert not torch.allclose(o1, o2)


def test_argument_errors(tiny_dataset):
    imgs, labs = tiny_dataset
    mod = _port(imgs, labs)
    with pytest.raises(ValueError, match="odd"):
        mod(0.5, _x(1), k=2)
    with pytest.raises(ValueError, match="scalar label"):
        mod(0.5, _x(2), label=np.array([0, 1]))
