"""Port vs JAX and vs the torch-reference goldens: the bbELS score module, in
bank mode and in streaming mode (bank_budget_bytes=0), on the CPU, at
'highest' and at 'high'.

Tolerances: goldens at the JAX tests' own atol 2e-4 relative to scale
(`tests/test_scores.py`, `tests/test_cutoffs.py`); the port vs the JAX
module at 2e-4 relative to scale (both fp32 and summed in other orders; at
'high' both take the same bf16x3 split in the center region, the JAX module
through its Pallas kernel in interpret mode); batched seeds against single
seeds at the JAX test's rtol 2e-4, atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.scores as jscores
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import (
    LocalEquivBordersScoreModule,
    LocalScoreModule,
)

MODES = {"bank": {}, "stream": {"bank_budget_bytes": 0}}


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


def _port(imgs, labs, mode="bank", **kw):
    kw.setdefault("schedule", cosine_noise_schedule)
    return LocalEquivBordersScoreModule((imgs, labs), device="cpu", **MODES[mode], **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("bs", [5, 12])
def test_kernel_and_batch_goldens(z, mode, k, bs):
    imgs, labs, x, t = _data(z)
    _check(_port(imgs, labs, mode, kernel_size=k, batch_size=bs)(t, x),
           _nhwc(z[f"bbels/k{k}b{bs}/out"]))


@pytest.mark.parametrize("mode", MODES)
def test_k7_on_12x12_golden(z, mode):
    """3-pixel border bands, c = 2."""
    imgs, labs = _nhwc(z["big/imgs"]), z["big/labs"].astype(np.int32)
    mod = _port(imgs, labs, mode, kernel_size=7, batch_size=4)
    _check(mod(float(z["t"][0]), _nhwc(z["big/x"])), _nhwc(z["big/bbels_k7/out"]))


@pytest.mark.parametrize("mode", MODES)
def test_gray_k5_golden(z, mode):
    imgs, labs = _nhwc(z["gray/imgs16"]), z["gray/labs16"].astype(np.int32)
    mod = _port(imgs, labs, mode, kernel_size=5, batch_size=4)
    _check(mod(float(z["t"][0]), _nhwc(z["gray/x16"])), _nhwc(z["gray/bbels_k5/out"]))


@pytest.mark.parametrize("mode", MODES)
def test_k13_on_24x24_golden(z, mode):
    imgs, labs = _nhwc(z["bigk/imgs24"]), z["bigk/labs24"].astype(np.int32)
    mod = _port(imgs, labs, mode, kernel_size=13, batch_size=5)
    _check(mod(float(z["t"][0]), _nhwc(z["bigk/x24"])[:1]), _nhwc(z["bigk/bbels_k13/out"]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("max_samples,tag", [(4, "max4"), (5, "max5"), (11, "max11")])
def test_batch_quota_cutoff_goldens(zc, mode, max_samples, tag):
    imgs, labs, x, t = _data(zc)
    mod = _port(imgs, labs, mode, kernel_size=3, batch_size=5, max_samples=max_samples)
    _check(mod(t, x), _nhwc(zc[f"bbels/{tag}/out"]))


def test_batched_matches_single(z):
    imgs, labs, x, t = _data(z)
    mod = _port(imgs, labs, kernel_size=3, batch_size=12)
    x2 = np.concatenate([x, x[::-1] * 0.5], axis=0)
    batched = mod(t, x2).numpy()
    for i in range(2):
        single = mod(t, x2[i : i + 1]).numpy()
        np.testing.assert_allclose(batched[i : i + 1], single, rtol=2e-4, atol=1e-4)


def test_fallback_when_k_geq_h_is_lazy_and_shared(z):
    imgs, labs, x, t = _data(z)
    mod = _port(imgs, labs, kernel_size=9, batch_size=12)
    assert mod._local_fallback_cache is None
    out = mod(t, x)
    ls = LocalScoreModule((imgs, labs), kernel_size=9, batch_size=12,
                          schedule=cosine_noise_schedule, device="cpu")
    torch.testing.assert_close(out, ls(t, x), rtol=1e-6, atol=1e-6)
    fb = mod._local_fallback
    assert fb.images is mod.images and fb.labels is mod.labels
    assert fb._generator is mod._generator


def _x(b, seed=5):
    return np.random.RandomState(seed).normal(size=(b, 8, 8, 1)).astype(np.float32)


JAX_CASES = {
    "plain": (dict(), dict()),
    "label": (dict(), dict(label=2)),
    "max_samples": (dict(max_samples=9), dict()),
    "order": (dict(max_samples=10), dict(order=np.random.RandomState(3).permutation(16))),
    "k5": (dict(), dict(k=5)),
    # the LS fallback always shuffles: an explicit order on both sides
    "k9_fallback": (dict(), dict(k=9, order=np.random.RandomState(4).permutation(16))),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", JAX_CASES)
def test_matches_jax_module(tiny_dataset, mode, case):
    imgs, labs = tiny_dataset
    ctor, call = JAX_CASES[case]
    x = _x(3)
    kw = dict(kernel_size=3, batch_size=5, **ctor)
    jmod = jscores.LocalEquivBordersScoreModule(
        (imgs, labs), schedule=jcos, **kw, **MODES[mode])
    ours = _port(imgs, labs, mode, **kw)
    for t in (0.05, 0.5, 0.95):
        _check(ours(t, x, **call), np.asarray(jmod(t, jnp.asarray(x), **call)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["plain", "label", "k5"])
def test_high_matches_jax_module_interpret(tiny_dataset, monkeypatch, mode, case):
    """'high': the center region through the port's plain bf16x3 sweep
    against the JAX module driving its Pallas kernel in interpret mode
    (use_pallas=True; without it the JAX module on the CPU takes its fp32
    jnp path). The border regions are fp32 on both sides."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    imgs, labs = tiny_dataset
    ctor, call = JAX_CASES[case]
    x = _x(2)
    kw = dict(kernel_size=3, batch_size=5, precision="high", **ctor)
    jmod = jscores.LocalEquivBordersScoreModule(
        (imgs, labs), schedule=jcos, use_pallas=True, **kw, **MODES[mode])
    ours = _port(imgs, labs, mode, **kw)
    for t in (0.05, 0.5):
        _check(ours(t, x, **call), np.asarray(jmod(t, jnp.asarray(x), **call)))


def test_high_and_highest_differ_only_by_the_split(tiny_dataset):
    imgs, labs = tiny_dataset
    x = _x(2)
    hi = _port(imgs, labs, kernel_size=3, batch_size=5, precision="high")(0.3, x)
    ref = _port(imgs, labs, kernel_size=3, batch_size=5)(0.3, x)
    assert not torch.equal(hi, ref)
    _check(hi, ref.numpy(), atol=1e-3)


def test_argument_errors(tiny_dataset):
    imgs, labs = tiny_dataset
    mod = _port(imgs, labs)
    with pytest.raises(ValueError, match="odd"):
        mod(0.5, _x(1), k=4)
    with pytest.raises(ValueError, match="scalar label"):
        mod(0.5, _x(2), label=np.array([0, 1]))
    out = _port(imgs, labs, precision="default")(0.5, _x(1))
    assert out.shape == (1, 8, 8, 1) and torch.isfinite(out).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["plain", "label", "k5"])
def test_default_matches_jax_module_interpret(tiny_dataset, monkeypatch, mode, case):
    """'default': the center region through the port's plain bf16-exp sweep
    ('inbank' here, d <= 128) against the JAX module with its Pallas kernel
    in interpret mode; the border regions are fp32 on both sides. Tolerance
    2e-3 relative to scale, half the tier's 4e-3: in bank mode the JAX
    kernel re-bases its running max every block_p >= 512 bank rows where
    the port re-bases every 128; streamed, the JAX module's center region
    takes its fp32-exp jnp path. Worst observed ~1e-3 (streamed)."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    imgs, labs = tiny_dataset
    ctor, call = JAX_CASES[case]
    x = _x(2)
    kw = dict(kernel_size=3, batch_size=5, precision="default", **ctor)
    jmod = jscores.LocalEquivBordersScoreModule(
        (imgs, labs), schedule=jcos, use_pallas=True, **kw, **MODES[mode])
    ours = _port(imgs, labs, mode, **kw)
    for t in (0.05, 0.5):
        _check(ours(t, x, **call), np.asarray(jmod(t, jnp.asarray(x), **call)),
               atol=2e-3)
