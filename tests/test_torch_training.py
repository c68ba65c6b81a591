"""Port vs JAX: the train step and the training loop
(`convolutional_diffusion_tpu_torch.training`) on the CPU.

The JAX `make_train_step` runs from a key; the test draws its t and eps
from that key exactly as the JAX step does (`jax.random.split`, randint,
normal) and feeds them to the port's `step_with_noise`. The JAX step runs
in float64 (`jax.enable_x64`, float64 params; its t, eps and noised images
stay float32, as the port's), the port in float32.

Tolerances: the loss within 1e-5 relative (|a - b| / max(|a|, |b|, 1)); the
params after 1 and 5 steps (lr 1e-3, so one step moves a weight by about
1e-3) within 2e-6 absolute, about 1/500 of one step's move: AdamW divides
each gradient by its own running scale, so float32 rounding of a gradient
moves its weight by far less; weights without a gradient (conv biases
before a per-channel norm, found from the port's float64 gradient) move by
normalised rounding noise in any float32 run and are held to AdamW's step
bound (`_null_gradient`, `_assert_params`). BatchNorm's running statistics within 1e-5
relative to scale; the reference's train-mode goldens at atol 5e-5 relative
to scale (as `tests/test_batchnorm.py`)."""

import copy
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu import models as jmodels
from convolutional_diffusion_tpu import training as jtraining
from convolutional_diffusion_tpu_torch import convert as tconvert
from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch import sampling as tsampling
from convolutional_diffusion_tpu_torch import training as ttraining

LOSS_TOL = 1e-5
PARAM_ATOL = 2e-6
CONFIG = dict(lr=1e-3, gamma=0.9, weight_decay=0.01)

# emb_dim 32, not the JAX trainer tests' 16: the ResNet's embedding MLP
# ends in GroupNorm(8), and with 2 features per group its output is +-1
# whatever its input, so the gradient into that Linear is rounding noise,
# which AdamW divides by its own scale into a move of up to lr
RESNET = dict(channels=1, emb_dim=32, num_layers=1, mode="zeros")
# last_norm off: a last_normalizer after the last decoder block's norm and
# ReLU removes any positive per-channel scale of them, so that norm's scale
# has only the gradient the normaliser's eps leaves, float32 rounding of
# which AdamW turns into moves of ~1e-5 (the BatchNorm goldens keep it on)
UNET = dict(channels=1, fsizes=(8, 16), emb_dim=16, mode="zeros", conditional=True,
            num_classes=4, normalization="GroupNorm", lastksize=3)
UNET_BN = dict(channels=1, fsizes=(8, 16), emb_dim=16, mode="zeros",
               normalization="BatchNorm")


def _np_tree(tree):
    """Numpy copies: a view of a JAX buffer changes when a later step takes
    (donates) that buffer."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _to_sd(kind, cfg):
    """The port's converter for a params-shaped tree of `kind`."""
    if kind == "resnet":
        return functools.partial(tconvert.resnet_state_dict_from_jax_params,
                                 num_layers=cfg["num_layers"],
                                 normalization=cfg.get("normalization"),
                                 conditional=cfg.get("conditional", False))
    return functools.partial(tconvert.unet_state_dict_from_jax_params,
                             n_feature_blocks=len(cfg["fsizes"]) - 1,
                             normalization=cfg.get("normalization"),
                             conditional=cfg.get("conditional", False),
                             last_norm=cfg.get("last_norm", False))


def _pair(kind, cfg, seed=0):
    """JAX DiffusionModel and float32 variables, and the port's model on the
    CPU with those variables carried across."""
    jnet = (jmodels.MinimalResNet if kind == "resnet" else jmodels.MinimalUNet)(**cfg)
    jmodel = jmodels.DiffusionModel(jnet, in_channels=1, default_imsize=8)
    variables = _np_tree(jmodel.init_variables(jax.random.PRNGKey(seed)))
    tnet = (tmodels.MinimalResNet if kind == "resnet" else tmodels.MinimalUNet)(**cfg)
    tmodel = tmodels.DiffusionModel(tnet, in_channels=1, default_imsize=8, device="cpu")
    tree = variables if "batch_stats" in variables else variables["params"]
    tmodel.backbone.load_state_dict(_to_sd(kind, cfg)(tree), strict=True)
    return jmodel, variables, tmodel


def _batches(n_steps, b=4, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(-1, 1, (b, 8, 8, 1)).astype(np.float32),
             rs.randint(0, 4, b).astype(np.int32)) for _ in range(n_steps)]


def _jax_draws(key, shape, max_t=1000):
    """t and eps as `convolutional_diffusion_tpu/training.py:95-100` draws
    them from the step's key."""
    kt, ke = jax.random.split(key)
    t = jax.random.randint(kt, (shape[0],), 0, max_t).astype(jnp.float32) / max_t
    return np.asarray(t), np.asarray(jax.random.normal(ke, shape, jnp.float32))


def _jax_run(jmodel, variables, batches, *, conditional, batch_norm, config,
             opt_state=None, key0=100):
    """JAX's own make_train_step in float64 over `batches`: (variables after
    each step, losses, the draws, opt_state)."""
    optimizer = jtraining.make_optimizer(config)
    step = jtraining.make_train_step(jmodel, optimizer, conditional=conditional,
                                     batch_norm=batch_norm)
    v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
    p = v64 if batch_norm else v64["params"]
    if opt_state is None:
        opt_state = optimizer.init(p["params"] if batch_norm else p)
    trail, losses, draws = [], [], []
    for i, (img, lab) in enumerate(batches):
        key = jax.random.PRNGKey(key0 + i)
        draws.append(_jax_draws(key, img.shape))
        p, opt_state, loss = step(p, opt_state, jnp.asarray(img), jnp.asarray(lab), key)
        trail.append(_np_tree(p))
        losses.append(float(loss))
    return trail, losses, draws, opt_state


def _port_run(state, batches, draws, *, conditional):
    losses = []
    for (img, lab), (t, eps) in zip(batches, draws):
        loss = ttraining.step_with_noise(
            state, torch.from_numpy(img), torch.from_numpy(lab).long(), torch.from_numpy(t),
            torch.from_numpy(eps), conditional=conditional)
        losses.append(float(loss))
    return losses


def _null_gradient(tmodel, batch, draw, conditional):
    """Per weight, where its float64 gradient at the first step is zero to
    rounding (1e-9 of the largest): conv biases before a per-channel
    GroupNorm or a BatchNorm, which removes them. Any float32 run moves
    those by AdamW's normalised rounding noise, up to about lr per step."""
    m = copy.deepcopy(tmodel).double().train()
    emb = m.backbone.embedding

    def emb64(t, label=None):  # the embedding's own formula, in float64
        d = emb.fdim // 2
        targ = t[:, None] / 10000.0 ** (torch.arange(d, dtype=torch.float64) / (d - 1))
        e = torch.cat([torch.sin(targ), torch.cos(targ)], dim=1)
        return e + emb.class_embeddings(label.long()) if emb.conditional else e

    emb.forward = emb64
    img, lab = batch
    t, eps = (torch.from_numpy(a).double() for a in draw)
    x = tsampling.q_sample(torch.from_numpy(img).double(), eps, m.noise_schedule(t).double())
    pred = m.backbone(t, x, torch.from_numpy(lab) if conditional else None)
    torch.mean((pred - eps) ** 2).backward()
    scale = max(p.grad.abs().max().item() for p in m.backbone.parameters())
    return {n: p.grad.abs() <= 1e-9 * scale for n, p in m.backbone.named_parameters()}


def _assert_params(tmodel, want_sd, null, lrs):
    """The port's weights against JAX float64's after steps at `lrs`: within
    PARAM_ATOL, those without a gradient (`null`) within AdamW's step bound,
    1.5 x the lrs' sum; running statistics within 1e-5 relative to scale,
    and a running mean after more than one step within that plus the step
    bound too: it follows the null conv bias before its BatchNorm (the
    variance does not)."""
    bound = 1.5 * sum(lrs)
    got = tmodel.backbone.state_dict()
    for name, w in want_sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        err = (got[name].double() - w.double()).abs()
        if name.endswith(("running_mean", "running_var")):
            drift = bound if name.endswith("mean") and len(lrs) > 1 else 0.0
            assert err.max().item() <= 1e-5 * max(w.abs().max(), 1.0) + drift, name
            continue
        live = err.masked_fill(null[name], 0).max().item()
        assert live <= PARAM_ATOL, (name, live)
        assert err.masked_fill(~null[name], 0).max().item() <= bound, name


def _lrs(first, last):
    return [CONFIG["lr"] * CONFIG["gamma"] ** i for i in range(first, last)]


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1.0)


@pytest.mark.parametrize("kind,cfg", [("resnet", RESNET), ("unet", UNET), ("bn", UNET_BN)],
                         ids=["resnet", "unet_groupnorm_cond", "unet_batchnorm"])
def test_train_steps_match_jax_float64(kind, cfg):
    """Loss and params after 1 and after 5 chained steps (and, for the
    BatchNorm UNet, its running statistics) against JAX's make_train_step
    evaluated in float64, from the same weights, batches, t and eps."""
    conditional = cfg.get("conditional", False)
    batch_norm = kind == "bn"
    jmodel, variables, tmodel = _pair("resnet" if kind == "resnet" else "unet", cfg)
    batches = _batches(5)
    config = ttraining.TrainConfig(**CONFIG)
    with jax.enable_x64(True):
        trail, jlosses, draws, _ = _jax_run(jmodel, variables, batches, conditional=conditional,
                                            batch_norm=batch_norm,
                                            config=jtraining.TrainConfig(**CONFIG))
    state = ttraining.TrainState(tmodel, config)
    to_sd = _to_sd("resnet" if kind == "resnet" else "unet", cfg)
    null = _null_gradient(tmodel, batches[0], draws[0], conditional)
    for n_steps in (1, 5):
        first = 0 if n_steps == 1 else 1
        losses = _port_run(state, batches[first:n_steps], draws[first:n_steps],
                           conditional=conditional)
        for got, want in zip(losses, jlosses[first:n_steps]):
            assert _rel(got, want) <= LOSS_TOL, (got, want)
        _assert_params(tmodel, to_sd(trail[n_steps - 1]), null, _lrs(0, n_steps))
    assert state.step == 5 and not tmodel.training  # served in eval() again


def test_train_step_draws_match_jax_float32():
    """JAX's float32 step from a key: the test's recomputed draws are the
    ones it used (the port's loss from them equals JAX's)."""
    jmodel, variables, tmodel = _pair("resnet", RESNET)
    batches = _batches(2)
    _, jlosses, draws, _ = _jax_run(jmodel, variables, batches, conditional=False,
                                    batch_norm=False, config=jtraining.TrainConfig(**CONFIG))
    state = ttraining.TrainState(tmodel, ttraining.TrainConfig(**CONFIG))
    losses = _port_run(state, batches, draws, conditional=False)
    for got, want in zip(losses, jlosses):
        assert _rel(got, want) <= 1e-5, (got, want)


def _nchw_to_nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def test_batchnorm_train_mode_matches_reference_goldens():
    """The reference BatchNorm UNet's three train-mode forwards from fresh
    running statistics (tests/goldens/unet_batchnorm.npz train_out0..2)
    and the running statistics they leave (the golden's state_dict)."""
    z = np.load("tests/goldens/unet_batchnorm.npz")
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd/")}
    net = tmodels.MinimalUNet(channels=3, fsizes=(8, 16), emb_dim=16, kernel_size=3,
                              lastksize=1, mode="zeros", normalization="BatchNorm",
                              last_norm=True)
    fresh = dict(sd)
    for name in sd:
        if name.endswith("running_mean"):
            fresh[name] = torch.zeros_like(sd[name])
        elif name.endswith("running_var"):
            fresh[name] = torch.ones_like(sd[name])
        elif name.endswith("num_batches_tracked"):
            fresh[name] = torch.zeros_like(sd[name])
    net.load_state_dict(fresh, strict=True)
    net.train()
    t = torch.from_numpy(z["t"])
    with torch.no_grad():
        for i in range(3):
            out = net(t, torch.from_numpy(_nchw_to_nhwc(z[f"x{i}"]))).numpy()
            want = _nchw_to_nhwc(z[f"train_out{i}"])
            np.testing.assert_allclose(out, want, atol=5e-5 * max(np.abs(want).max(), 1.0),
                                       err_msg=f"train_out{i}")
    got = net.state_dict()
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), sd[name].numpy(), rtol=2e-5,
                                       atol=1e-6, err_msg=name)
    assert int(got["feature_blocks.0.model.1.num_batches_tracked"]) == 3


def _orbax_round_trip(opt_state, tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from convolutional_diffusion_tpu.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    path = save_checkpoint(str(tmp_path / "jax_ckpt"), params={"w": np.zeros(1)},
                           opt_state=opt_state, step=3)
    return restore_checkpoint(path)["state"]["opt_state"]


@pytest.mark.parametrize("through_orbax", [False, True], ids=["numpy", "orbax"])
@pytest.mark.parametrize("kind,cfg", [("resnet", RESNET), ("unet", UNET)],
                         ids=["resnet", "unet_groupnorm_cond"])
def test_jax_optimizer_state_carries_across(kind, cfg, through_orbax, tmp_path):
    """JAX trains 3 steps; its params and optax state cross to the port
    (`convert.adamw_state_from_jax`; one variant through the JAX package's
    own Orbax save and restore), which runs 3 more steps from JAX's draws:
    the result equals JAX's 6 steps."""
    conditional = cfg.get("conditional", False)
    jmodel, variables, tmodel = _pair(kind, cfg)
    batches = _batches(6)
    jconfig = jtraining.TrainConfig(**CONFIG)
    with jax.enable_x64(True):
        trail, _, draws, opt3 = _jax_run(jmodel, variables, batches[:3],
                                         conditional=conditional, batch_norm=False,
                                         config=jconfig)
        opt3 = _np_tree(opt3)  # before the next steps take (donate) its buffers
        trail6, _, draws6, _ = _jax_run(jmodel, {"params": trail[-1]}, batches[3:],
                                        conditional=conditional, batch_norm=False,
                                        config=jconfig, opt_state=opt3, key0=103)
    if through_orbax:
        opt3 = _orbax_round_trip(opt3, tmp_path)
    to_sd = _to_sd(kind, cfg)
    tmodel.backbone.load_state_dict(to_sd(trail[-1]), strict=True)
    state = ttraining.TrainState(tmodel, ttraining.TrainConfig(**CONFIG))
    count = tconvert.adamw_state_from_jax(opt3, state.optimizer, state.scheduler,
                                          tmodel.backbone, to_sd)
    assert count == 3
    assert state.scheduler.get_last_lr()[0] == pytest.approx(CONFIG["lr"] * CONFIG["gamma"] ** 3)
    null = _null_gradient(tmodel, batches[3], draws6[0], conditional)
    _port_run(state, batches[3:], draws6, conditional=conditional)
    _assert_params(tmodel, to_sd(trail6[-1]), null, _lrs(3, 6))


def test_adamw_state_from_jax_refuses_other_states():
    net = tmodels.MinimalResNet(**RESNET)
    state = ttraining.TrainState(
        tmodels.DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu"),
        ttraining.TrainConfig())
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        tconvert.adamw_state_from_jax(({"count": 0},), state.optimizer, state.scheduler,
                                      net, _to_sd("resnet", RESNET))


# --- the precision scope reaches the backward --------------------------------


def _flags_in_backward(precision):
    """Both TF32 flags as a conv's gradient hook reads them during the
    step's backward."""
    net = tmodels.MinimalResNet(**dict(RESNET, precision=precision))
    model = tmodels.DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu")
    seen = []

    def on_forward(module, args, out):
        out.register_hook(lambda g: seen.append(
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))

    net.up_projection.register_forward_hook(on_forward)
    state = ttraining.TrainState(model, ttraining.TrainConfig())
    img, lab = _batches(1)[0]
    t, eps = ttraining.draw_noise(torch.from_numpy(img), state.generator, 1000)
    ttraining.step_with_noise(state, torch.from_numpy(img), torch.from_numpy(lab), t, eps)
    return seen


@pytest.mark.parametrize("precision,allowed", [("highest", False), (None, True)])
def test_tf32_flags_inside_the_backward(precision, allowed):
    """At 'highest' the gradient convolutions run with TF32 off in both
    cuDNN and cuBLAS, with precision=None on: the step runs its backward
    inside the backbone's precision scope, whatever the flags are outside."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not allowed
        seen = _flags_in_backward(precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    assert seen == [(allowed, allowed)]


# --- the training loop --------------------------------------------------------


def _tiny_model(**kw):
    net = tmodels.MinimalResNet(**RESNET)
    return tmodels.DiffusionModel(net, in_channels=1, default_imsize=8, device="cpu", **kw)


def test_loss_decreases(tiny_dataset):
    config = ttraining.TrainConfig(epochs=30, batch_size=8, lr=3e-3, log_every=1)
    state, history = ttraining.train_diffusion(_tiny_model(), tiny_dataset, config,
                                               log_fn=lambda s: None)
    assert history[-1] < history[0] * 0.9, history
    assert state.step == 60 and len(history) == 30


def test_batch_order_is_jax_permutation(tiny_dataset, monkeypatch):
    """Each step's batch is the one JAX's train_diffusion takes:
    RandomState(seed).permutation(n) per epoch."""
    images = np.arange(16, dtype=np.float32)[:, None, None, None] * np.ones((1, 8, 8, 1),
                                                                            np.float32)
    labels = tiny_dataset[1]
    seen_jax, seen_port = [], []
    real_make = jtraining.make_train_step

    def spy_make(*args, **kw):
        step = real_make(*args, **kw)

        def wrapped(params, opt_state, img, lab, key):
            seen_jax.append(np.asarray(img)[:, 0, 0, 0])
            return step(params, opt_state, img, lab, key)
        return wrapped

    monkeypatch.setattr(jtraining, "make_train_step", spy_make)
    jnet = jmodels.MinimalResNet(**RESNET)
    jmodel = jmodels.DiffusionModel(jnet, in_channels=1, default_imsize=8)
    config = dict(epochs=3, batch_size=4, seed=7, log_every=100)
    jtraining.train_diffusion(jmodel, jmodel.init(jax.random.PRNGKey(0)), (images, labels),
                              jtraining.TrainConfig(**config), log_fn=lambda s: None)
    real_step = ttraining.step_with_noise

    def spy_step(state, img, lab, t, eps, **kw):
        seen_port.append(img[:, 0, 0, 0].numpy().copy())
        return real_step(state, img, lab, t, eps, **kw)

    monkeypatch.setattr(ttraining, "step_with_noise", spy_step)
    ttraining.train_diffusion(_tiny_model(), (images, labels),
                              ttraining.TrainConfig(**config), log_fn=lambda s: None)
    assert len(seen_port) == len(seen_jax) == 12
    for a, b in zip(seen_port, seen_jax):
        np.testing.assert_array_equal(a, b)


def test_too_small_dataset_raises(tiny_dataset):
    with pytest.raises(ValueError, match="smaller than batch_size"):
        ttraining.train_diffusion(_tiny_model(), tiny_dataset,
                                  ttraining.TrainConfig(batch_size=32), log_fn=lambda s: None)


@pytest.mark.parametrize("kw,item", [
    pytest.param("use_native_loader", "unavailable", id="kw0-item 3"),
    pytest.param("native_loader", "smaller than batch_size", id="kw1-item 3")])
def test_unported_keywords_raise(tiny_dataset, kw, item, monkeypatch):
    """The native loader's keywords, ported: where the library cannot be
    built, use_native_loader=True logs JAX's line and trains from the
    arrays; a given loader's size is checked against the batch like the
    dataset's (`tests/test_torch_native_loader.py` trains from both)."""
    from convolutional_diffusion_tpu_torch.utils import native_loader

    if kw == "use_native_loader":
        monkeypatch.setattr(native_loader, "is_available", lambda: False)
        logs = []
        _, history = ttraining.train_diffusion(
            _tiny_model(), tiny_dataset, ttraining.TrainConfig(epochs=1, batch_size=8),
            use_native_loader=True, log_fn=logs.append)
        assert logs[0] == "native loader unavailable; using numpy batches"
        assert np.isfinite(history).all()
        return
    loader = SimpleNamespace(num_samples=4)
    with pytest.raises(ValueError, match=item):
        ttraining.train_diffusion(_tiny_model(), None, ttraining.TrainConfig(batch_size=8),
                                  native_loader=loader, log_fn=lambda s: None)


def test_make_optimizer_is_adamw_with_per_batch_decay():
    p = torch.nn.Parameter(torch.ones(3))
    opt, sched = ttraining.make_optimizer([p], ttraining.TrainConfig(lr=1e-2, gamma=0.5,
                                                                     weight_decay=0.1))
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW) and group["fused"]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.1
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    assert sched.get_last_lr() == [pytest.approx(1e-2 * 0.5 ** 3)]
