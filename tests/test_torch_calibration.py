"""Port vs JAX and vs the torch-reference goldens: scale calibration
(`convolutional_diffusion_tpu_torch.calibration`, `cli.calibrate`) on the
CPU. Every comparison is exact: the aggregates against torch's median and
mode, and the per-step optimal k's, medians and modes against
`tests/goldens/calibration.npz` and against JAX `calibrate` on the same
seeds."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu import calibration as jcal
from convolutional_diffusion_tpu import scores as jscores
from convolutional_diffusion_tpu.models import DiffusionModel as JDiffusionModel
from convolutional_diffusion_tpu.models import MinimalResNet as JMinimalResNet
from convolutional_diffusion_tpu_torch import calibration as tcal
from convolutional_diffusion_tpu_torch import convert as tconvert
from convolutional_diffusion_tpu_torch import scores as tscores
from convolutional_diffusion_tpu_torch.cli import calibrate as cal_cli
from convolutional_diffusion_tpu_torch.models import DiffusionModel, MinimalResNet
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def test_lower_median_matches_torch():
    a = np.random.RandomState(0).randint(3, 18, size=(10, 7)).astype(np.float32)
    np.testing.assert_array_equal(tcal.lower_median(a, axis=0),
                                  torch.median(torch.tensor(a), dim=0).values.numpy())
    np.testing.assert_array_equal(tcal.lower_median(a, axis=1),
                                  torch.median(torch.tensor(a), dim=1).values.numpy())


def test_mode_smallest_matches_torch():
    a = np.random.RandomState(1).choice([3, 5, 7, 9], size=(12, 5)).astype(np.float32)
    np.testing.assert_array_equal(tcal.mode_smallest(a, axis=0),
                                  torch.mode(torch.tensor(a), dim=0).values.numpy())
    ties = np.array([[5, 3, 5, 3, 9], [9, 9, 7, 7, 1]], np.int32)  # two values twice
    np.testing.assert_array_equal(tcal.mode_smallest(ties, axis=1), [3, 7])
    np.testing.assert_array_equal(tcal.mode_smallest(ties, axis=1),
                                  torch.mode(torch.tensor(ties), dim=1).values.numpy())


GOLDEN_CASES = {
    # tag -> (module type, conditional, eval_mode, nsteps)
    "uncond_cos": ("bbELS", False, "cos", 4),
    "cond_cos": ("bbELS", True, "cos", 3),
    "uncond_l2": ("ELS", False, "l2_dist", 3),
}


def _port_eps(sd, conditional):
    net = MinimalResNet(channels=1, emb_dim=16, kernel_size=3, num_layers=1, lastksize=3,
                        mode="zeros", conditional=conditional,
                        num_classes=3 if conditional else None)
    model = DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


@pytest.mark.parametrize("tag", sorted(GOLDEN_CASES))
def test_calibrate_matches_golden(tag):
    z = np.load("tests/goldens/calibration.npz")
    smt, conditional, eval_mode, nsteps = GOLDEN_CASES[tag]
    sd = {k[len(f"{tag}/sd/"):]: z[k] for k in z.files if k.startswith(f"{tag}/sd/")}
    model = _port_eps(sd, conditional)
    dataset = (_nhwc(z["imgs"]), z["labs"].astype(np.int32))
    cls = (tscores.LocalEquivScoreModule if smt == "ELS"
           else tscores.LocalEquivBordersScoreModule)
    mods = {k: cls(dataset, kernel_size=k, batch_size=6, schedule=cosine_noise_schedule,
                   device="cpu") for k in (3, 5)}
    x0 = _nhwc(z[f"{tag}/x0"])
    res = tcal.calibrate(
        model, mods, image_size=8, in_channels=1, nsamps=x0.shape[0], nsteps=nsteps,
        conditional=conditional, nlabels=3, eval_mode=eval_mode, x0=x0,
        labels=z[f"{tag}/labels"] if conditional else None, device="cpu")
    for name in ("k_optimals", "median", "mode"):
        np.testing.assert_array_equal(res[name], z[f"{tag}/{name}"])
        assert res[name].dtype == np.int32


@pytest.fixture(scope="module")
def tiny():
    imgs = np.random.RandomState(3).uniform(-1, 1, (24, 8, 8, 1)).astype(np.float32)
    labs = np.random.RandomState(4).randint(0, 3, (24,)).astype(np.int32)
    jnet = JMinimalResNet(channels=1, emb_dim=16, num_layers=1, mode="zeros",
                          conditional=True, num_classes=3)
    params = jax.tree_util.tree_map(
        np.asarray, JDiffusionModel(jnet, in_channels=1, default_imsize=8).init(
            jax.random.PRNGKey(0)))
    net = MinimalResNet(channels=1, emb_dim=16, num_layers=1, mode="zeros",
                        conditional=True, num_classes=3)
    model = DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu")
    net.load_state_dict(tconvert.resnet_state_dict_from_jax_params(
        params, num_layers=1, conditional=True), strict=True)
    return (imgs, labs), jnet, params, model


@pytest.mark.parametrize("smt,conditional,eval_mode", [
    ("ELS", False, "cos"), ("ELS", True, "cos"), ("bbELS", True, "l2_dist")])
def test_calibrate_matches_jax(tiny, smt, conditional, eval_mode):
    """The same CNN weights, seeds and labels through JAX `calibrate` and the
    port's: the same k at every step. Conditional ELS scores every seed in
    one vector-label call; bbELS, one call per label (JAX: padded groups)."""
    dataset, jnet, params, model = tiny
    jcls = {"ELS": jscores.LocalEquivScoreModule,
            "bbELS": jscores.LocalEquivBordersScoreModule}[smt]
    tcls = {"ELS": tscores.LocalEquivScoreModule,
            "bbELS": tscores.LocalEquivBordersScoreModule}[smt]
    ks = (3, 5, 7)
    jmods = {k: jcls(dataset, kernel_size=k, batch_size=24, schedule=jcal.cosine_noise_schedule)
             for k in ks}
    tmods = {k: tcls(dataset, kernel_size=k, batch_size=24, schedule=cosine_noise_schedule,
                     device="cpu") for k in ks}
    rs = np.random.RandomState(5)
    x0 = rs.normal(size=(5, 8, 8, 1)).astype(np.float32)
    labels = np.array([0, 2, 1, 2, 0], np.int32)
    kw = dict(image_size=8, in_channels=1, nsamps=5, nsteps=4, conditional=conditional,
              nlabels=3, eval_mode=eval_mode, x0=x0, labels=labels if conditional else None)

    def jeps(t, x, label):
        return jnet.apply({"params": params}, t, x, label if conditional else
                          np.zeros(x.shape[0], np.int32))

    def teps(t, x, label):
        return model(t, x, label if conditional else torch.zeros(x.shape[0], dtype=torch.long))

    want = jcal.calibrate(jeps, jmods, **kw)
    got = tcal.calibrate(teps, tmods, device="cpu", **kw)
    for name in ("k_optimals", "median", "mode"):
        np.testing.assert_array_equal(got[name], want[name])


def test_calibrate_draws_seeds_from_its_generator(tiny):
    dataset, _, _, model = tiny
    mods = {k: tscores.LocalEquivScoreModule(dataset, kernel_size=k, batch_size=24,
                                             device="cpu") for k in (3, 5)}
    runs = [tcal.calibrate(model, mods, image_size=8, in_channels=1, nsamps=3, nsteps=3,
                           conditional=True, nlabels=3, device="cpu",
                           generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["k_optimals"], runs[1]["k_optimals"])
    assert set(np.unique(runs[0]["k_optimals"])) <= {3, 5}
    with pytest.raises(ValueError, match="Generator"):
        tcal.calibrate(model, mods, image_size=8, in_channels=1, device="cpu")
    with pytest.raises(ValueError, match="eval_mode"):
        tcal.calibrate(model, mods, image_size=8, in_channels=1, device="cpu",
                       eval_mode="cosine", generator=torch.Generator())


@pytest.mark.parametrize("fmt", ["npy", "pt"])
def test_calibrate_cli_with_the_conditional_pickle(tmp_path, fmt):
    """`cli.calibrate --cpu` ingests a reference .pt whole pickle and writes
    {kfilename}_{k_optimals,median,mode}.{fmt} and the median's JSON list."""
    tld = tmp_path / "out"
    res = cal_cli.main([
        "--modelfile", "tests/goldens/pickles/backbone_resnet_cond.pt",
        "--dataset", "synthetic", "--kernelsizes", "3", "5", "--nsamps", "2",
        "--nsteps", "2", "--scorebatchsize", "32", "--maxsamps", "32",
        "--tld", str(tld), "--cpu", "--conditional", "--scoremoduletype", "ELS",
        "--fmt", fmt,
    ])
    assert sorted(os.listdir(tld)) == sorted(
        [f"scales_{n}.{fmt}" for n in ("k_optimals", "median", "mode")]
        + ["scales_median.json"])
    with open(tld / "scales_median.json") as f:
        assert json.load(f) == [int(v) for v in res["median"]]
    assert res["k_optimals"].shape == (2, 2) and set(res["median"]) <= {3, 5}
    from convolutional_diffusion_tpu_torch.pipeline import load_array

    np.testing.assert_array_equal(load_array(str(tld / "scales_k_optimals")),
                                  res["k_optimals"])


def test_calibrate_cli_needs_model_and_kernel_sizes():
    with pytest.raises(ValueError, match="modelfile"):
        cal_cli.main(["--kernelsizes", "3", "--cpu"])
    with pytest.raises(ValueError, match="kernelsizes"):
        cal_cli.main(["--modelfile", "x.pt", "--cpu"])

