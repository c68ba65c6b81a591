"""The port across a process boundary: two gloo ranks on the CPU, mirroring
`tests/test_multihost.py`, plus data-parallel training, seed-sharded
sampling and the CLIs in a group.

One worker pair (`tests/torch_multihost_worker.py`, suite `multihost`)
computes every case once, in a module-scoped fixture, from inputs this file
prepares (JAX's weights, batches and draws); the tests hold each result
against JAX and against the port in one process:
 - a DP train step (batch 8 as 4 + 4) against JAX's unsharded step in
   float64 from JAX's t and eps, with `tests/test_torch_training.py`'s
   tolerances (loss 1e-5 relative; params 2e-6, weights without a gradient
   within AdamW's step bound; BatchNorm's running statistics 1e-5 relative
   to scale), and against the one-process step;
 - `train_diffusion(mesh=)` against one process (history 1e-5 relative,
   params 2e-6, weights without a gradient within AdamW's step bound,
   running statistics 1e-5 relative to scale); a resumed DP run against an
   unbroken one bit for bit;
 - sharded ELS against single-process JAX (rtol 2e-4, atol 1e-5);
 - `sample_sharded` and the CLIs' outputs against one process within
   1e-6 relative to scale (max|a-b| / max(|a|,|b|,1)); seeds, labels and
   file sets exactly."""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_training as tt
import torch_multihost_worker as W
from convolutional_diffusion_tpu import training as jtraining
from convolutional_diffusion_tpu.parallel import mesh as jmesh
from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch import sampling, training
from convolutional_diffusion_tpu_torch.cli import els as els_cli
from convolutional_diffusion_tpu_torch.cli import sample as sample_cli
from convolutional_diffusion_tpu_torch.cli import train as train_cli
from convolutional_diffusion_tpu_torch.parallel import mesh as pm
from convolutional_diffusion_tpu_torch.utils.checkpoint import restore_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICKLE = os.path.join(ROOT, "tests/goldens/pickles/backbone_resnet_cond.pt")
DP = {"dp_resnet": ("resnet", tt.RESNET, False), "dp_bn": ("unet", tt.UNET_BN, True)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


def _cli_args(tmp, tag):
    ck = tmp / "checkpoints"
    ck.mkdir(exist_ok=True)
    with open(ck / "scales_SYNTHETIC_ResNet_zeros.json", "w") as f:
        json.dump([3, 3], f)
    return {
        "els": ["--dataset", "synthetic", "--numiters", "3", "--batch", "3", "--cpu",
                "--checkpoints", str(ck), "--results", str(tmp / tag / "results"),
                "--expname", "exp", "--scorebatchsize", "64", "--scoremoduletype", "ELS",
                "--conditional"],
        "sample": ["--modelfile", PICKLE, "--cpu", "--nsamples", "4", "--nsteps", "3",
                   "--conditional", "--seed", "1", "--out", str(tmp / tag / "grid.png"),
                   "--save_arrays", str(tmp / tag / "arrays")],
        "train": ["--cpu", "--dataset", "synthetic", "--epochs", "1", "--layers", "2",
                  "--mult", "1", "--batchsize", "32", "--maxsamps", "64", "--mode", "zeros",
                  "--conditional", "--saveinterval", "1", "--suppress", "--homedir",
                  str(tmp / tag / "ckpt")],
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's float64 steps, the worker pair's results and the one-process
    CLI runs."""
    tmp = tmp_path_factory.mktemp("multihost")
    inputs, jax_runs = {}, {}
    for name, (kind, cfg, bn) in DP.items():
        jmodel, variables, tmodel = tt._pair(kind, cfg)
        batches = tt._batches(2, b=8)
        with tt.jax.enable_x64(True):
            trail, losses, draws, _ = tt._jax_run(
                jmodel, variables, batches, conditional=False, batch_norm=bn,
                config=jtraining.TrainConfig(**tt.CONFIG))
        inputs[name] = dict(kind=kind, cfg=cfg, conditional=False, config=tt.CONFIG,
                            batches=batches, draws=draws,
                            sd={k: v.clone() for k, v in tmodel.backbone.state_dict().items()})
        jax_runs[name] = dict(trail=trail, losses=losses, tmodel=tmodel)
    inputs["checkpoint_dir"] = str(tmp / "dp_ckpt")
    inputs["cli"] = _cli_args(tmp, "dp")
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    ranks = W.run_pair("multihost", str(tmp), inputs=path)
    one = _cli_args(tmp, "one")
    els_cli.main(one["els"] + ["--ndevices", "1"])
    sample_cli.main(one["sample"] + ["--ndevices", "1"])
    train_cli.main(one["train"] + ["--ndevices", "1"])
    return dict(tmp=tmp, ranks=ranks, inputs=inputs, jax=jax_runs)


def test_two_process_topology(setup):
    r0, r1 = setup["ranks"]
    assert r0["world"] == r1["world"] == 2 and (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["mesh_shape"] == {"data": 2}
    assert r0["mesh2_shape"] == r1["mesh2_shape"] == {"data": 2, "model": 1}


@pytest.mark.parametrize("n,axes", [(4, ("data", "model")), (8, ("data", "model")),
                                    (8, ("data", "model", "x")), (6, ("data", "model")),
                                    (7, ("data", "model")), (2, ("data",))])
def test_make_mesh_factoring_matches_jax(n, axes):
    """make_mesh's factoring (4 over ('data', 'model') -> (2, 2)) is JAX's,
    as a shape: no fourth process."""
    assert pm.mesh_shape(n, axes) == jmesh.make_mesh(n, axes).devices.shape


def _port_model(case):
    kind, cfg = case["kind"], case["cfg"]
    net = (tmodels.MinimalResNet if kind == "resnet" else tmodels.MinimalUNet)(**cfg)
    model = tmodels.DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu")
    model.backbone.load_state_dict(case["sd"], strict=True)
    return model


@pytest.mark.parametrize("name", list(DP), ids=["resnet", "unet_batchnorm"])
def test_dp_train_step_matches_jax_float64(setup, name):
    """Two DP steps (batch 8 split 4 + 4, BatchNorm over the global batch)
    against JAX's unsharded make_train_step in float64 from the same weights,
    batches, t and eps: losses, params and running statistics."""
    kind, cfg, _ = DP[name]
    case, ref = setup["inputs"][name], setup["jax"][name]
    got = setup["ranks"][0][name]
    for r in range(2):  # the ranks' replicas stay identical
        for a, b in zip(setup["ranks"][r][name]["trail"], got["trail"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
    for g, w in zip(got["losses"], ref["losses"]):
        assert tt._rel(g, w) <= tt.LOSS_TOL, (g, w)
    null = tt._null_gradient(ref["tmodel"], case["batches"][0], case["draws"][0], False)
    to_sd = tt._to_sd(kind, cfg)
    model = _port_model(case)
    for n_steps in (1, 2):
        model.backbone.load_state_dict(got["trail"][n_steps - 1])
        tt._assert_params(model, to_sd(ref["trail"][n_steps - 1]), null, tt._lrs(0, n_steps))


@pytest.mark.parametrize("name", list(DP), ids=["resnet", "unet_batchnorm"])
def test_dp_train_step_matches_one_process(setup, name):
    """The same two steps in one process over the whole batch."""
    kind, cfg, _ = DP[name]
    case, got = setup["inputs"][name], setup["ranks"][0][name]
    model = _port_model(case)
    state = training.TrainState(model, training.TrainConfig(**case["config"]))
    losses = tt._port_run(state, case["batches"], case["draws"], conditional=False)
    for g, w in zip(got["losses"], losses):
        assert tt._rel(g, w) <= tt.LOSS_TOL
    null = tt._null_gradient(setup["jax"][name]["tmodel"], case["batches"][0],
                             case["draws"][0], False)
    dp = _port_model(case)
    dp.backbone.load_state_dict(got["trail"][-1])
    tt._assert_params(dp, model.backbone.state_dict(), null, tt._lrs(0, 2))


def test_sharded_els_matches_single_process(setup):
    """tests/test_multihost.py's case: the bank spans both ranks and the
    merge crosses the process boundary; against single-process JAX."""
    from convolutional_diffusion_tpu.schedules import cosine_noise_schedule
    from convolutional_diffusion_tpu.scores import LocalEquivScoreModule

    rs = np.random.RandomState(11)
    rs.uniform(-1, 1, size=(8, 8, 8, 3))
    imgs = rs.uniform(-1, 1, size=(16, 8, 8, 3)).astype(np.float32)
    labs = rs.randint(0, 3, size=(16,)).astype(np.int32)
    x = rs.normal(size=(2, 8, 8, 3)).astype(np.float32)
    single = LocalEquivScoreModule((imgs, labs), kernel_size=3, batch_size=8,
                                   schedule=cosine_noise_schedule)
    for r in range(2):
        np.testing.assert_allclose(setup["ranks"][r]["sharded_els"].numpy(),
                                   np.asarray(single(0.5, x)), rtol=2e-4, atol=1e-5)


def _null_biases(backbone):
    """Conv biases right before a BatchNorm: no gradient, so AdamW moves
    them by rounding noise."""
    names = set()
    for name, m in backbone.named_modules():
        kids = list(m.named_children()) if isinstance(m, torch.nn.Sequential) else []
        for (a, conv), (_, norm) in zip(kids, kids[1:]):
            if isinstance(conv, torch.nn.Conv2d) and isinstance(norm, torch.nn.BatchNorm2d):
                names.add(f"{name}.{a}.bias" if name else f"{a}.bias")
    return names


def _assert_run(got, model, history, steps, lr=1e-3):
    """A DP run's history and weights against one process's."""
    assert got["step"] == steps
    assert all(tt._rel(a, b) <= 1e-5 for a, b in zip(got["history"], history))
    null, want = _null_biases(model.backbone), model.backbone.state_dict()
    for name, w in want.items():
        err = (got["sd"][name].double() - w.double()).abs().max().item()
        if name.endswith("num_batches_tracked"):
            assert got["sd"][name] == w, name
        elif name.endswith(("running_mean", "running_var")):
            assert err <= 1e-5 * max(w.abs().max().item(), 1.0) + 1.5 * lr * steps, name
        elif name in null:
            assert err <= 1.5 * lr * steps, name
        else:
            assert err <= tt.PARAM_ATOL, (name, err)


@pytest.mark.parametrize("kind", ["unet", "bn"], ids=["unet", "unet_batchnorm"])
def test_train_diffusion_over_the_mesh_matches_one_process(setup, kind):
    """train_diffusion(mesh=) for 2 epochs of 4 steps (batch 4 as 2 + 2)
    against the same run in one process, running statistics included."""
    images, labels = W.train_data()
    model = W._tiny_model(kind, "cpu")
    cfg = training.TrainConfig(epochs=2, batch_size=4, lr=1e-3, log_every=1, seed=3)
    state, hist = training.train_diffusion(model, (images, labels), cfg,
                                           conditional=kind == "unet", log_fn=lambda s: None)
    _assert_run(setup["ranks"][0][f"train_{kind}"], model, hist, 8)
    for k, v in setup["ranks"][1][f"train_{kind}"]["sd"].items():
        assert torch.equal(v, setup["ranks"][0][f"train_{kind}"]["sd"][k]), k


def test_ragged_tail_runs_whole_on_every_rank(setup):
    """9 images at batch 4 with drop_last=False: two split batches and a
    tail of one, computed whole on each rank; equal to one process."""
    images, labels = W.train_data()
    model = W._tiny_model("unet", "cpu")
    cfg = training.TrainConfig(epochs=1, batch_size=4, lr=1e-3, log_every=1, seed=3,
                               drop_last=False)
    _, hist = training.train_diffusion(model, (images[:9], labels[:9]), cfg,
                                       conditional=True, log_fn=lambda s: None)
    _assert_run(setup["ranks"][0]["train_ragged"], model, hist, 3)


def test_checkpoints_by_rank_zero_and_resume(setup):
    """Only rank 0 writes the checkpoint; a DP run resumed from it equals
    an unbroken DP run bit for bit."""
    r0, r1 = setup["ranks"]
    assert r0["saves"] == [4] and r1["saves"] == []
    assert sorted(os.listdir(setup["inputs"]["checkpoint_dir"])) == ["step_4"]
    assert r0["resume_equal"] and r1["resume_equal"]
    assert r0["resume_step"] == 8


class _FakeMesh(pm.Mesh):
    def __init__(self, n):
        super().__init__({"data": n}, {"data": 0}, {"data": None}, torch.device("cpu"))


def test_batchnorm_over_a_group_is_centred(tmp_path):
    """BatchNorm's group path (global statistics, here over a world of one)
    at a channel mean 100 x its std: the output and the gradients of the
    input, weight and bias within 2 x the one-process kernel's own distance
    from a float64 step, relative to scale. Normalising as x * scale -
    mean * scale loses eps32 * |mean| / std: 1.1e-5 on the weight's gradient
    against the kernel's 2.0e-6."""
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(32, 16, 16, 16, generator=g, dtype=torch.float64) + 100.0
    dy = torch.randn(32, 16, 16, 16, generator=g, dtype=torch.float64)

    def run(dtype, group):
        bn = tmodels.layers.BatchNorm(16).to(dtype).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
            bn.bias.fill_(0.1)
        x = x0.to(dtype).clone().requires_grad_()
        y = bn._global_forward(x, group) if group is not None else bn(x)
        (y * dy.to(dtype)).sum().backward()
        return [v.detach().double() for v in (y, x.grad, bn.weight.grad, bn.bias.grad)]

    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         world_size=1, rank=0)
    try:
        group = run(torch.float32, torch.distributed.group.WORLD)
    finally:
        torch.distributed.destroy_process_group()
    ref, kernel = run(torch.float64, None), run(torch.float32, None)
    for got, own, want in zip(group, kernel, ref):
        scale = want.abs().max()
        assert (got - want).abs().max() / scale <= 2 * (own - want).abs().max() / scale


def test_batch_that_does_not_divide_raises():
    model = W._tiny_model("unet", "cpu")
    images, labels = W.train_data()
    with pytest.raises(ValueError, match="divide over the 2 ranks"):
        training.train_diffusion(model, (images, labels),
                                 training.TrainConfig(batch_size=5), mesh=_FakeMesh(2),
                                 log_fn=lambda s: None)
    with pytest.raises(ValueError, match="does not divide over the 2 ranks"):
        sampling.sample_sharded(model, _FakeMesh(2), batch_size=3, nsteps=2,
                                generator=torch.Generator())


@pytest.mark.parametrize("ddpm", [False, True], ids=["ddim", "ddpm"])
def test_sample_sharded_equals_sample_seed_for_seed(setup, ddpm):
    """4 seeds over 2 ranks against one 4-seed call: the same initial noise
    and (DDPM) the same per-step noise per seed, gathered on both ranks."""
    model = W._tiny_model("unet", "cpu", seed=2)
    g = torch.Generator().manual_seed(4)
    want = sampling.sample(model, batch_size=4, nsteps=3, label=torch.tensor([0, 3, 1, 2]),
                           generator=g, ddpm=ddpm, device="cpu")
    for r in range(2):
        got = setup["ranks"][r][f"sample_ddpm{int(ddpm)}"]
        assert got.shape == want.shape and _rel(got, want) <= 1e-6


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def test_els_cli_over_two_ranks(setup):
    """cli.els --cpu --ndevices 2 (in the group: the torchrun path), the
    sharded ELS module grouping seeds by label, against --ndevices 1."""
    tmp = setup["tmp"]
    assert setup["ranks"][0]["cli_els"] == setup["ranks"][1]["cli_els"] == 3
    dp, one = tmp / "dp" / "results" / "exp", tmp / "one" / "results" / "exp"
    assert _tree(dp) == _tree(one) and len(_tree(one)) == 9
    for f in _tree(one):
        a, b = np.load(dp / f), np.load(one / f)
        if f.startswith("els_outputs"):
            assert _rel(a, b) <= 1e-6, f
        else:
            np.testing.assert_array_equal(a, b)


def test_sample_cli_over_two_ranks(setup):
    tmp = setup["tmp"]
    got = setup["ranks"][0]["cli_sample"]
    want = np.stack([np.load(tmp / "one" / "arrays" / f"{i:04d}.npy")[0] for i in range(4)])
    assert got.shape == want.shape == (4, 16, 16, 3) and _rel(got, want) <= 1e-6
    np.testing.assert_array_equal(setup["ranks"][1]["cli_sample"], got)
    assert _tree(tmp / "dp" / "arrays") == _tree(tmp / "one" / "arrays")
    assert (tmp / "dp" / "grid.png").exists()


def test_train_cli_over_two_ranks(setup):
    """cli.train --cpu --ndevices 2: 8 steps of batch 32 (16 per rank); the
    final checkpoint against the --ndevices 1 run's."""
    tmp = setup["tmp"]
    assert setup["ranks"][0]["cli_train_step"] == setup["ranks"][1]["cli_train_step"] == 8
    (name,) = os.listdir(tmp / "one" / "ckpt")
    assert os.listdir(tmp / "dp" / "ckpt") == [name]
    dp = restore_checkpoint(str(tmp / "dp" / "ckpt" / name))
    one = restore_checkpoint(str(tmp / "one" / "ckpt" / name))
    assert dp["meta"]["step"] == one["meta"]["step"] == 8
    for k, v in one["state"]["params"].items():
        assert (dp["state"]["params"][k] - v).abs().max().item() <= 1e-5, k


def test_ndevices_must_match_the_launchers_group(setup):
    for r in range(2):
        assert "--ndevices 3 does not match the launcher's group of 2 ranks" in (
            setup["ranks"][r]["cli_mismatch"])


def test_clis_write_once_by_rank_zero(setup):
    r0, r1 = setup["ranks"]
    assert r1["writes"] == {"save_array": 0, "save_image_grid": 0, "save_checkpoint": 0}
    assert r0["writes"]["save_array"] == 9 and r0["writes"]["save_image_grid"] == 1
    assert r0["writes"]["save_checkpoint"] >= 1


def test_ndevices_outside_a_group_spawns_the_ranks(setup, tmp_path):
    """cli.sample --cpu --ndevices 2 outside any group starts two gloo
    ranks itself (a file store in a temporary directory) and returns rank
    0's samples; equal to the one-process run."""
    tmp = setup["tmp"]
    (tmp_path / "spawned").mkdir()
    args = _cli_args(tmp_path, "spawned")["sample"] + ["--ndevices", "2"]
    got = sample_cli.main(args)
    want = np.stack([np.load(tmp / "one" / "arrays" / f"{i:04d}.npy")[0] for i in range(4)])
    assert got.shape == want.shape == (4, 16, 16, 3) and _rel(got, want) <= 1e-6
    assert _tree(tmp_path / "spawned" / "arrays") == _tree(tmp / "one" / "arrays")


def test_ndevices_above_the_visible_cards_raises_on_a_card_machine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check counts the visible cards")
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"{torch.cuda.device_count()} visible"):
        sample_cli.main(["--modelfile", PICKLE, "--ndevices", str(n), "--nsamples", str(n)])
