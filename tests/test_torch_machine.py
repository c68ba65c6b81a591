"""Port vs JAX and vs the torch-reference goldens: the scheduled ELS and
bbELS machines end to end on the CPU, plus the DDIM step and the synthetic
dataset.

Tolerances: goldens as the JAX tests hold them (machine/els, machine/bbels
and gray/machine at atol 5e-4, bigk/machine at 1e-3, relative to scale); a
whole trajectory against the JAX machine at the repo's parity rule,
max|a-b| / max(|a|,|b|,1) <= 1e-3, at every step; the DDIM step at float32
rounding (rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.data as jdata
import convolutional_diffusion_tpu.sampling as jsampling
import convolutional_diffusion_tpu.scores as jscores
import convolutional_diffusion_tpu_torch.data as tdata
import convolutional_diffusion_tpu_torch.sampling as tsampling
from convolutional_diffusion_tpu_torch.scores import (
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


@pytest.fixture(scope="module")
def z():
    return np.load("tests/goldens/scores.npz")


def _check(ours, expect, atol):
    scale = max(np.abs(expect).max(), 1.0)
    np.testing.assert_allclose(ours.numpy(), expect, atol=atol * scale)


@pytest.mark.parametrize("budget", [48 << 30, 0], ids=["bank", "stream"])
@pytest.mark.parametrize("prefix,imgs,c,imsize,bs,atol", [
    ("machine/els", "imgs", 3, 8, 6, 5e-4),
    ("gray/machine", "gray/imgs16", 1, 16, 4, 5e-4),
    ("bigk/machine", "bigk/imgs24", 3, 24, 5, 1e-3),
], ids=["els8", "gray16", "bigk24"])
def test_machine_goldens(z, budget, prefix, imgs, c, imsize, bs, atol):
    labs_key = imgs.replace("imgs", "labs")
    x_key = imgs.replace("imgs", "x")
    scales_key = "machine/scales" if prefix == "machine/els" else f"{prefix.split('/')[0]}/machine/scales"
    mod = LocalEquivScoreModule(
        (_nhwc(z[imgs]), z[labs_key].astype(np.int32)), kernel_size=3,
        batch_size=bs, device="cpu", bank_budget_bytes=budget,
    )
    machine = ScheduledScoreMachine(
        mod, in_channels=c, imsize=imsize,
        scales=[int(s) for s in z[scales_key]],
    )
    _check(machine(_nhwc(z[x_key])[:1]), _nhwc(z[f"{prefix}/out"]), atol)


def _assert_same_trajectory(ttraj, jtraj, steps, tol=1e-3):
    assert len(ttraj) == len(jtraj) == steps
    for a, b in zip(ttraj, jtraj):
        a, b = a.numpy(), np.asarray(b)
        dev = np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)
        assert dev <= tol, dev
    assert np.isfinite(a).all()


def test_trajectory_matches_jax_machine():
    ds = tdata.synthetic_dataset(num_samples=32, image_size=16, seed=3)
    scales = [3, 3, 5, 5, 7]
    x0 = np.random.RandomState(11).normal(size=(2, 16, 16, 3)).astype(np.float32)
    jmod = jscores.LocalEquivScoreModule((ds.images, ds.labels), batch_size=8)
    jx, jtraj = jscores.ScheduledScoreMachine(jmod, imsize=16, scales=scales)(
        jnp.asarray(x0), collect_trajectory=True)
    tmod = LocalEquivScoreModule((ds.images, ds.labels), batch_size=8, device="cpu")
    tx, ttraj = ScheduledScoreMachine(tmod, imsize=16, scales=scales)(
        x0, collect_trajectory=True)
    _assert_same_trajectory(ttraj, jtraj, 4)


class _EpsBackbone:
    """An epsilon backbone, 0.1 x, on the CPU."""

    device = torch.device("cpu")

    def __call__(self, t, x, label=None, k=None):
        return 0.1 * x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


def test_machine_takes_score_backbone_and_visualize_fn():
    """An epsilon backbone under score_backbone=False is used as it is, and
    visualize_fn records (i, imputed x0) at each step, as in the JAX
    machine; score_backbone=True converts the same output from a score."""
    x0 = np.random.RandomState(5).normal(size=(2, 8, 8, 3)).astype(np.float32)
    jrec, trec = [], []
    jx = jscores.ScheduledScoreMachine(
        lambda t, x, label=None, k=None: 0.1 * x, imsize=8, score_backbone=False)(
        jnp.asarray(x0), nsteps=6, visualize_fn=lambda i, v: jrec.append((i, v)))
    tm = ScheduledScoreMachine(_EpsBackbone(), imsize=8, score_backbone=False)
    tx = tm(x0, nsteps=6, visualize_fn=lambda i, v: trec.append((i, v.numpy())))
    assert _rel(tx.numpy(), jx) <= 2e-4
    assert [i for i, _ in trec] == [i for i, _ in jrec] == [5, 4, 3, 2, 1]
    for (_, a), (_, b) in zip(trec, jrec):
        assert _rel(a, b) <= 2e-4
    as_score = ScheduledScoreMachine(_EpsBackbone(), imsize=8)(x0, nsteps=6)
    assert _rel(as_score.numpy(), tx.numpy()) > 1e-2


@pytest.mark.parametrize("budget", [48 << 30, 0], ids=["bank", "stream"])
def test_bbels_machine_golden(z, budget):
    mod = LocalEquivBordersScoreModule(
        (_nhwc(z["imgs"]), z["labs"].astype(np.int32)), kernel_size=3,
        batch_size=6, device="cpu", bank_budget_bytes=budget,
    )
    machine = ScheduledScoreMachine(
        mod, in_channels=3, imsize=8, scales=[int(s) for s in z["machine/scales"]])
    _check(machine(_nhwc(z["x"])), _nhwc(z["machine/bbels/out"]), 5e-4)


@pytest.mark.parametrize("budget", [48 << 30, 0], ids=["bank", "stream"])
def test_bbels_high_trajectory_matches_jax_machine(monkeypatch, budget):
    """bbELS at 'high': the JAX machine drives its Pallas kernel in
    interpret mode. The scales reach k = 9 >= the 8-pixel image, so the LS
    fallback runs too; N is a multiple of the batch size, so its shuffled
    order (torch's and jax.random's differ) cannot change the weights."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    ds = tdata.synthetic_dataset(num_samples=16, image_size=8, seed=4)
    scales = [3, 3, 5, 9, 7]
    x0 = np.random.RandomState(12).normal(size=(2, 8, 8, 3)).astype(np.float32)
    kw = dict(batch_size=8, precision="high", bank_budget_bytes=budget)
    jmod = jscores.LocalEquivBordersScoreModule(
        (ds.images, ds.labels), use_pallas=True, **kw)
    _, jtraj = jscores.ScheduledScoreMachine(jmod, imsize=8, scales=scales)(
        jnp.asarray(x0), collect_trajectory=True)
    tmod = LocalEquivBordersScoreModule((ds.images, ds.labels), device="cpu", **kw)
    _, ttraj = ScheduledScoreMachine(tmod, imsize=8, scales=scales)(
        x0, collect_trajectory=True)
    _assert_same_trajectory(ttraj, jtraj, 4)
    assert tmod._local_fallback_cache is not None


def test_default_trajectory_matches_jax_machine(monkeypatch):
    """ELS at 'default' (banked): the JAX machine drives its Pallas kernel in
    interpret mode with 128-row bank blocks (CDT_FLASH_BP), so that both
    sides re-base the running max at the same rows: the bf16 rounding of
    x = logit - m depends on that m (with the JAX default blocks the last
    step differs by 3.1e-3). k = 3, 5 take 'inbank', k = 7 'vpu', whose
    bf16 products XLA's CPU backend leaves unrounded; the steps amplify
    that to 9.0e-4 at the last one, held at 2e-3 relative to scale, half
    the tier's 4e-3 (`tests/test_flash_score.py:407`)."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    monkeypatch.setenv("CDT_FLASH_BP", "128")
    ds = tdata.synthetic_dataset(num_samples=32, image_size=16, seed=3)
    scales = [3, 3, 5, 5, 7]
    x0 = np.random.RandomState(11).normal(size=(2, 16, 16, 3)).astype(np.float32)
    kw = dict(batch_size=8, precision="default")
    jmod = jscores.LocalEquivScoreModule((ds.images, ds.labels), use_pallas=True, **kw)
    _, jtraj = jscores.ScheduledScoreMachine(jmod, imsize=16, scales=scales)(
        jnp.asarray(x0), collect_trajectory=True)
    tmod = LocalEquivScoreModule((ds.images, ds.labels), device="cpu", **kw)
    _, ttraj = ScheduledScoreMachine(tmod, imsize=16, scales=scales)(
        x0, collect_trajectory=True)
    _assert_same_trajectory(ttraj, jtraj, 4, tol=2e-3)


def test_ddim_step_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.normal(size=(3, 4, 4, 2)).astype(np.float32)
    eps = rs.normal(size=x.shape).astype(np.float32)
    bt = np.float32([0.5, 0.2, 0.9])
    bp = np.float32([0.4, 0.0, 0.85])
    ours = tsampling.ddim_step(torch.from_numpy(x), torch.from_numpy(eps),
                               torch.from_numpy(bt), torch.from_numpy(bp))
    want = jsampling.ddim_step(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(bt),
                               jnp.asarray(bp))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sample_uses_generator():
    ds = tdata.synthetic_dataset(num_samples=8, image_size=8, seed=1)
    mod = LocalEquivScoreModule((ds.images, ds.labels), batch_size=4, device="cpu")
    machine = ScheduledScoreMachine(mod, imsize=8, scales=[3, 3, 3])
    a = machine.sample(generator=torch.Generator().manual_seed(2), batch_size=2)
    b = machine.sample(generator=torch.Generator().manual_seed(2), batch_size=2)
    assert a.shape == (2, 8, 8, 3) and torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        machine.sample()


@pytest.mark.parametrize("kw", [
    dict(num_samples=5, image_size=8, num_channels=3, seed=0),
    dict(num_samples=4, image_size=12, num_channels=1, num_classes=3, seed=7),
])
def test_synthetic_dataset_bit_identical(kw):
    ours, want = tdata.synthetic_dataset(**kw), jdata.synthetic_dataset(**kw)
    np.testing.assert_array_equal(ours.images, want.images)
    np.testing.assert_array_equal(ours.labels, want.labels)
    assert ours.num_samples == kw["num_samples"]
