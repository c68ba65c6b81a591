"""Port vs JAX on a 16-channel image bank, where every sweep of the ELS and
bbELS modules takes the matrix value sums 'mxu' (c = 16 > 8; 'inbank'
stays off: d = 9 * 16 padded to 128 is past its ceiling): the modules in
bank and stream modes, with and without a label, at every tier; ELS with
prune=True; a short machine trajectory; and the artifact pipeline through
`cli.common.build_score_module` at in_channels = 16. On the CPU, small
sizes.

The JAX side runs its Pallas kernel in interpret mode at 'high' and
'default' (`CDT_FLASH_INTERPRET=1` with `use_pallas=True`; at 'default'
with 128-row bank blocks, `CDT_FLASH_BP`, so both sides re-base m at the
same rows), and its fp32 path at 'highest'. Tolerances, max|a-b| /
max(|a|,|b|,1): 2e-4 at 'highest' and 'high', the 'default' tier's 4e-3
(`tests/test_flash_score.py:407`) at 'default'; the pruned module 1e-3, as
`tests/test_torch_prune.py` holds it."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.data as jdata
import convolutional_diffusion_tpu.scores as jscores
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
from convolutional_diffusion_tpu_torch import pipeline
from convolutional_diffusion_tpu_torch.cli.common import build_score_module
from convolutional_diffusion_tpu_torch.ops import flash_score as tfs
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import (
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)
from convolutional_diffusion_tpu_torch.scores import els as tels

C = 16
TOL = {"highest": 2e-4, "high": 2e-4, "default": 4e-3}
MODES = {"bank": {}, "stream": {"bank_budget_bytes": 0}}


@pytest.fixture(scope="module")
def wide():
    ds = jdata.synthetic_dataset(num_samples=12, image_size=8, num_channels=C, seed=1)
    return ds.images, ds.labels


def _x(b=2, size=8, seed=0):
    return np.random.RandomState(seed).normal(size=(b, size, size, C)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


def _jax_side(monkeypatch, precision):
    """The JAX module keywords of a tier: its Pallas kernel in interpret
    mode at the split tiers (with 128-row bank blocks at 'default')."""
    if precision == "highest":
        return {}
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    if precision == "default":
        monkeypatch.setenv("CDT_FLASH_BP", "128")
    return dict(use_pallas=True)


def test_els_takes_mxu_at_16_channels():
    """The ELS value rule at c = 16: no 'inbank' at any tier or k (d padded
    to 128 is 256 and more), so 'auto' takes 'mxu' over bank chunks under
    2^18 rows, and 'mxu1' over longer ones with the bf16 exponential."""
    for precision in ("highest", "high", "default"):
        for k in (3, 9, 17):
            assert tels._value_kw(precision, k * k * C, (k * k // 2) * C, C) == {}
    for fast, P, strategy in ((False, 1 << 20, "mxu"), (True, 65536, "mxu"),
                              (True, 1 << 18, "mxu1")):
        assert tfs.sweep_plan("high", fast, "auto", C, 8, 8, P, 9 * C).strategy == strategy


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("cls", ["ELS", "bbELS"])
def test_wide_module_matches_jax(monkeypatch, wide, cls, precision, mode):
    """The module on the 16-channel bank against the JAX module, without a
    label and with one (ELS: also a label vector, one per seed)."""
    jcls, tcls = {"ELS": (jscores.LocalEquivScoreModule, LocalEquivScoreModule),
                  "bbELS": (jscores.LocalEquivBordersScoreModule,
                            LocalEquivBordersScoreModule)}[cls]
    kw = dict(batch_size=6, precision=precision, **MODES[mode])
    jmod = jcls(wide, **_jax_side(monkeypatch, precision), **kw)
    tmod = tcls(wide, device="cpu", **kw)
    calls = [{}, {"label": 2}]
    if cls == "ELS":
        calls.append({"label": np.array([5, 0], np.int32)})
    x = _x()
    for call in calls:
        want = np.asarray(jmod(0.5, jnp.asarray(x), k=3, **call))
        got = tmod(0.5, x, k=3, **call)
        assert got.shape == (2, 8, 8, C) and torch.isfinite(got).all()
        assert _rel(got.numpy(), want) <= TOL[precision], call


def _prototypes(n=64, protos=4, size=16, noise=0.01, seed=0):
    """n 16-channel images in `protos` runs of one flat colour plus small
    noise, labelled by colour: 4096 bank rows a colour, so the clustered
    bank's stats blocks (PRUNE_BLOCK rows) hold one colour each and the
    masks skip at low noise."""
    rs = np.random.RandomState(seed)
    colour = rs.uniform(-1, 1, (protos, 1, 1, C)).astype(np.float32)
    idx = np.arange(n) * protos // n
    imgs = colour[idx] + noise * rs.normal(size=(n, size, size, C))
    return imgs.astype(np.float32), idx.astype(np.int32)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_wide_pruned_module_matches_jax(monkeypatch, precision):
    """ELS prune=True at c = 16 (masked 'mxu' sweeps, K6) against the JAX
    package's pruned module, with masks that skip (prototype images, low
    noise); unconditional and with a label (unmasked on both sides)."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    imgs, labs = _prototypes()
    kw = dict(batch_size=8, precision=precision, prune=True)
    jmod = jscores.LocalEquivScoreModule((imgs, labs), schedule=jcos, use_pallas=True, **kw)
    tmod = LocalEquivScoreModule((imgs, labs), device="cpu", **kw)
    x = (0.99 * imgs[:2] + 0.1 * _x(size=16, seed=3)).astype(np.float32)
    skips = []
    inner = tels.sweep_masks

    def spy(*a, **k):
        masks = inner(*a, **k)
        skips.append(masks.float().mean().item())
        return masks

    monkeypatch.setattr(tels, "sweep_masks", spy)
    for t, call in ((0.02, {}), (0.3, {}), (0.02, {"label": 1})):
        want = np.asarray(jmod(t, jnp.asarray(x), k=3, **call))
        assert _rel(tmod(t, x, k=3, **call).numpy(), want) <= 1e-3
    assert skips and skips[0] > 0


def test_wide_machine_trajectory_matches_jax(wide):
    """A short 16-channel ELS machine trajectory ('highest') against the JAX
    machine, every step."""
    scales = [3, 3, 5, 5, 3]
    x0 = _x(seed=4)
    jx, jtraj = jscores.ScheduledScoreMachine(
        jscores.LocalEquivScoreModule(wide, batch_size=6), in_channels=C, imsize=8,
        scales=scales)(jnp.asarray(x0), collect_trajectory=True)
    tx, ttraj = ScheduledScoreMachine(
        LocalEquivScoreModule(wide, batch_size=6, device="cpu"), in_channels=C,
        imsize=8, scales=scales)(x0, collect_trajectory=True)
    assert len(ttraj) == len(jtraj) == 4
    for a, b in zip(ttraj, jtraj):
        assert _rel(a.numpy(), b) <= 2e-4
    assert torch.isfinite(tx).all()


@pytest.mark.parametrize("kind", ["ELS", "bbELS"])
def test_wide_pipeline_artifacts(wide, tmp_path, kind):
    """`pipeline.generate_els_samples` over a machine from
    `cli.common.build_score_module` at in_channels = 16: seeds, labels and
    outputs written as [1, 8, 8, 16] artifacts and read back; each output
    is the machine's on its saved seed (and label), and the JAX machine's
    on the same seed within 2e-4."""
    kw = dict(batch_size=6, image_size=8, channels=C, schedule=cosine_noise_schedule)
    mod = build_score_module(kind, wide, device="cpu", **kw)
    scales = [3, 3, 3, 5]
    machine = ScheduledScoreMachine(mod, in_channels=C, imsize=8, scales=scales)
    out = str(tmp_path / "exp")
    n = pipeline.generate_els_samples(machine, out, numiters=3, batch=2, in_channels=C,
                                      image_size=8, conditional=True, nlabels=3,
                                      log_fn=lambda s: None)
    assert n == 3
    jcls = {"ELS": jscores.LocalEquivScoreModule,
            "bbELS": jscores.LocalEquivBordersScoreModule}[kind]
    jm = jscores.ScheduledScoreMachine(jcls(wide, batch_size=6), in_channels=C,
                                       imsize=8, scales=scales)
    for i in range(3):
        seed, lab, got = (pipeline.load_array(os.path.join(out, sub, f"{i:04d}"))
                          for sub in ("seeds", "labels", "els_outputs"))
        assert seed.shape == got.shape == (1, 8, 8, C) and np.isfinite(got).all()
        again = machine(seed, label=int(lab[0])).numpy()
        np.testing.assert_allclose(got, again, rtol=1e-5, atol=1e-6)
        want = np.asarray(jm(jnp.asarray(seed), label=int(lab[0])))
        assert _rel(got, want) <= 2e-4
