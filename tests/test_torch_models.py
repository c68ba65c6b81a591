"""Port vs JAX and vs the torch-reference goldens: the backbones
(`convolutional_diffusion_tpu_torch.models`) on the CPU.

Tolerances: the goldens as `tests/test_parity_torch.py` holds them (atol
5e-5, rtol 2e-4; the BatchNorm UNet at atol 5e-5 relative to scale, as
`tests/test_batchnorm.py`); against the JAX forward with the same flax
params carried across by the port's converter, max|a-b| / max(|a|,|b|,1)
<= 1e-5 against the JAX forward evaluated in float64 (the JAX float32
forward is itself up to ~2.6e-5 from that value here, and is held within
1e-5 plus its own error); single layers (embedding, PaddedConv) at 1e-5 absolute; the
params' round trip through both converters exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu import convert as jconvert
from convolutional_diffusion_tpu import models as jmodels
from convolutional_diffusion_tpu.models.layers import PaddedConv as JPaddedConv
from convolutional_diffusion_tpu_torch import convert as tconvert
from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch.models.layers import PaddedConv, seeded_init

GOLDENS = "tests/goldens/"


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _group(z, prefix):
    p = prefix + "/"
    return {k[len(p):]: torch.from_numpy(z[k]) for k in z.files if k.startswith(p)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


def _forward(net, t, x, label=None):
    net.eval()
    with torch.no_grad():
        return net(torch.from_numpy(t), torch.from_numpy(x),
                   None if label is None else torch.from_numpy(label)).numpy()


RESNET_CFGS = {
    "zeros_plain": dict(mode="zeros", normalization=None, conditional=False),
    "circular_plain": dict(mode="circular", normalization=None, conditional=False),
    "zeros_norm_cond": dict(mode="zeros", normalization="GroupNorm", conditional=True,
                            num_classes=10),
    "zeros_noaddone": dict(mode="zeros", normalization=None, conditional=False,
                           add_one=False),
}
RESNET_ARCH = dict(channels=3, emb_dim=16, kernel_size=3, num_layers=2, lastksize=3)
UNET_CFGS = {
    "zeros_plain": dict(mode="zeros", normalization=None, conditional=False),
    "circular_plain": dict(mode="circular", normalization=None, conditional=False),
    "zeros_norm_cond": dict(mode="zeros", normalization="GroupNorm", conditional=True,
                            num_classes=10, last_norm=True),
}
UNET_ARCH = dict(channels=3, fsizes=(8, 16, 32), emb_dim=16, kernel_size=3, lastksize=1)
BN_ARCH = dict(channels=3, fsizes=(8, 16), emb_dim=16, kernel_size=3, lastksize=1,
               mode="zeros", normalization="BatchNorm", last_norm=True)


# --- layers ---------------------------------------------------------------


@pytest.mark.parametrize("conditional", [False, True])
def test_time_class_embedding_matches_jax(conditional):
    rs = np.random.RandomState(0)
    t = rs.uniform(0, 1, 5).astype(np.float32)
    label = rs.randint(0, 7, 5).astype(np.int32)
    kw = dict(conditional=conditional, num_classes=7 if conditional else None)
    jm = jmodels.TimeClassEmbedding(16, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(label))
    want = np.asarray(jm.apply(params, jnp.asarray(t), jnp.asarray(label)))
    tm = tmodels.TimeClassEmbedding(16, **kw)
    if conditional:
        tm.load_state_dict({"class_embeddings.weight": torch.from_numpy(np.asarray(
            params["params"]["class_embeddings"]["embedding"]))})
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_time_embedding_denominator_quirk():
    """The exponent is arange(d) / (d - 1): the last sine column is
    sin(t / 10000) exactly, not sin(t / 10000^((d-1)/d))."""
    t = torch.tensor([0.3, 0.9])
    emb = tmodels.TimeClassEmbedding(16)(t)
    d = 8
    np.testing.assert_allclose(emb[:, d - 1].numpy(), np.sin(t.numpy() / 10000.0), rtol=1e-6)
    np.testing.assert_allclose(emb[:, 0].numpy(), np.sin(t.numpy()), rtol=1e-6)
    np.testing.assert_allclose(emb[:, d].numpy(), np.cos(t.numpy()), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("mode", ["zeros", "circular"])
def test_padded_conv_matches_jax_pad_same(k, mode):
    """nn.Conv2d(padding='same') against JAX pad_same + VALID conv, even k
    included (floor-left / ceil-right)."""
    rs = np.random.RandomState(k)
    x = rs.normal(size=(2, 8, 8, 3)).astype(np.float32)
    conv = PaddedConv(3, 4, k, mode)
    jm = JPaddedConv(features=4, kernel_size=k, mode=mode)
    params = {"params": {"conv": {
        "kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
        "bias": jnp.asarray(conv.bias.detach().numpy()),
    }}}
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_padded_conv_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        PaddedConv(3, 4, 3, "reflect")


# --- forward against the torch-reference goldens ---------------------------


@pytest.mark.parametrize("cfg_name", sorted(RESNET_CFGS))
def test_resnet_matches_golden(cfg_name):
    z = np.load(GOLDENS + "resnet_forward.npz")
    cfg = RESNET_CFGS[cfg_name]
    net = tmodels.MinimalResNet(**RESNET_ARCH, **cfg)
    net.load_state_dict(_group(z, f"{cfg_name}/sd"), strict=True)
    out = _forward(net, z["t"], _nhwc(z["x"]), z["label"] if cfg["conditional"] else None)
    np.testing.assert_allclose(out, _nhwc(z[f"{cfg_name}/out"]), atol=5e-5, rtol=2e-4)


@pytest.mark.parametrize("cfg_name", sorted(UNET_CFGS))
def test_unet_matches_golden(cfg_name):
    z = np.load(GOLDENS + "unet_forward.npz")
    cfg = UNET_CFGS[cfg_name]
    net = tmodels.MinimalUNet(**UNET_ARCH, **cfg)
    net.load_state_dict(_group(z, f"{cfg_name}/sd"), strict=True)
    out = _forward(net, z["t"], _nhwc(z["x"]), z["label"] if cfg["conditional"] else None)
    np.testing.assert_allclose(out, _nhwc(z[f"{cfg_name}/out"]), atol=5e-5, rtol=2e-4)


def test_batchnorm_unet_matches_golden_in_eval():
    """BatchNorm serves with the golden's running statistics (eval())."""
    z = np.load(GOLDENS + "unet_batchnorm.npz")
    net = tmodels.MinimalUNet(**BN_ARCH)
    net.load_state_dict(_group(z, "sd"), strict=True)
    out = _forward(net, z["t"], _nhwc(z["x_eval"]))
    expect = _nhwc(z["out_eval"])
    np.testing.assert_allclose(out, expect, atol=5e-5 * max(np.abs(expect).max(), 1.0))


# --- forward against JAX, flax params carried across -----------------------


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_and_port(kind, cfg, seed):
    """A JAX backbone with flax-initialised variables, and the port's
    backbone with those variables carried across by the port's converter."""
    if kind == "resnet":
        jnet = jmodels.MinimalResNet(**RESNET_ARCH, **cfg)
    elif kind == "unet":
        jnet = jmodels.MinimalUNet(**UNET_ARCH, **cfg)
    else:
        jnet = jmodels.MinimalUNet(**BN_ARCH)
    cond = cfg.get("conditional", False)
    jmodel = jmodels.DiffusionModel(jnet, in_channels=3, default_imsize=16)
    variables = _numpy_tree(jmodel.init_variables(jax.random.PRNGKey(seed)))
    if kind == "resnet":
        tnet = tmodels.MinimalResNet(**RESNET_ARCH, **cfg)
        sd = tconvert.resnet_state_dict_from_jax_params(
            variables["params"], num_layers=2, normalization=cfg["normalization"],
            add_one=cfg.get("add_one", True), conditional=cond)
    else:
        if kind == "bn":  # move the running statistics off their init values
            rs = np.random.RandomState(seed)
            variables["batch_stats"] = jax.tree_util.tree_map(
                lambda a: (rs.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(np.float32),
                variables["batch_stats"])
        arch = BN_ARCH if kind == "bn" else dict(UNET_ARCH, **cfg)
        tnet = tmodels.MinimalUNet(**arch)
        sd = tconvert.unet_state_dict_from_jax_params(
            variables, n_feature_blocks=len(arch["fsizes"]) - 1,
            normalization=arch.get("normalization"), conditional=cond,
            last_norm=arch.get("last_norm", False))
    tnet.load_state_dict(sd, strict=True)
    return jnet, variables, tnet, sd


JAX_CASES = ([("resnet", n) for n in sorted(RESNET_CFGS)]
             + [("unet", n) for n in sorted(UNET_CFGS)] + [("bn", "batchnorm")])


@pytest.mark.parametrize("kind,cfg_name", JAX_CASES)
def test_forward_matches_jax_through_converter(kind, cfg_name):
    cfg = {"resnet": RESNET_CFGS, "unet": UNET_CFGS}.get(kind, {}).get(cfg_name, {})
    jnet, variables, tnet, _ = _jax_and_port(kind, cfg, seed=len(cfg_name))
    rs = np.random.RandomState(1)
    x = rs.normal(size=(3, 16, 16, 3)).astype(np.float32)
    t = rs.uniform(0, 1, 3).astype(np.float32)
    label = rs.randint(0, 10, 3).astype(np.int32) if cfg.get("conditional") else None
    jlabel = None if label is None else jnp.asarray(label)
    want = np.asarray(jnet.apply(variables, jnp.asarray(t), jnp.asarray(x), jlabel))
    with jax.enable_x64(True):  # the same JAX function in float64
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        exact = np.asarray(jnet.apply(v64, jnp.asarray(t, jnp.float64),
                                      jnp.asarray(x, jnp.float64), jlabel))
    got = _forward(tnet, t, x, label)
    # JAX's own float32 forward is up to ~2.6e-5 from its float64 value in
    # two of these configurations, so the 1e-5 gate is held against the
    # float64 one, and the float32 one within 1e-5 plus JAX's own error
    assert _rel(got, exact) <= 1e-5
    assert _rel(got, want) <= 1e-5 + _rel(want, exact)


@pytest.mark.parametrize("kind,cfg_name", [("resnet", "zeros_norm_cond"), ("bn", "batchnorm")])
def test_flax_init_round_trip(kind, cfg_name):
    """flax init -> numpy -> the port's state_dict -> the JAX package's
    torch importer gives back the same variables, bit for bit."""
    cfg = RESNET_CFGS.get(cfg_name, {}) if kind == "resnet" else {}
    _, variables, _, sd = _jax_and_port(kind, cfg, seed=3)
    if kind == "resnet":
        back = {"params": jconvert.resnet_params_from_torch(
            sd, num_layers=2, normalization=cfg["normalization"], conditional=True)}
    else:
        back = jconvert.unet_variables_from_torch(sd, n_feature_blocks=1, last_norm=True)
    flat_a = jax.tree_util.tree_leaves_with_path(_numpy_tree(back))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


# --- DiffusionModel ---------------------------------------------------------


def test_diffusion_model_seeded_eval_nhwc():
    """Weights come from the seed alone (not the global generator), the
    model serves in eval(), and forward is NHWC in and out."""
    def make(seed):
        torch.manual_seed(1234 + seed)  # must not matter
        net = tmodels.MinimalUNet(**BN_ARCH)
        return tmodels.DiffusionModel(net, in_channels=3, default_imsize=16, seed=seed,
                                      device="cpu")

    a, b, c = make(0), make(0), make(1)
    assert not a.training and not a.backbone.training
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert not torch.equal(a.backbone.output_conv.weight, c.backbone.output_conv.weight)
    x = torch.randn(2, 16, 16, 3)
    with torch.no_grad():
        out = a(0.5, x)
    assert out.shape == x.shape and a.device.type == "cpu" and not a.conditional


def test_seeded_init_follows_pytorch_default_ranges():
    conv, again = torch.nn.Conv2d(4, 6, 3), torch.nn.Conv2d(4, 6, 3)
    state = torch.random.get_rng_state()
    seeded_init(conv, 0), seeded_init(again, 0)
    bound = 1.0 / np.sqrt(4 * 9)
    assert conv.weight.abs().max() <= bound and conv.bias.abs().max() <= bound
    assert torch.equal(conv.weight, again.weight) and torch.equal(conv.bias, again.bias)
    assert torch.equal(torch.random.get_rng_state(), state)


def test_precision_argument():
    with pytest.raises(ValueError, match="precision"):
        tmodels.MinimalResNet(precision="high")
    tmodels.MinimalResNet(precision=None)


@pytest.mark.parametrize("resnet,nonorm", [(True, False), (False, True)])
def test_build_backbone_from_flags_matches_jax(resnet, nonorm):
    """The training script's construction: the same architecture fields as
    the JAX package's `build_backbone_from_flags`."""
    from convolutional_diffusion_tpu.cli.common import build_backbone_from_flags as jbuild
    from convolutional_diffusion_tpu_torch.cli.common import build_backbone_from_flags

    meta = {"num_channels": 1, "num_classes": 10}
    kw = dict(resnet=resnet, mode="zeros", mult=2, layers=3, conditional=True,
              nonorm=nonorm)
    got, want = build_backbone_from_flags(meta, **kw), jbuild(meta, **kw)
    fields = (("emb_dim", "kernel_size", "num_layers") if resnet
              else ("fsizes", "emb_dim", "last_norm"))
    for f in ("channels", "mode", "normalization", "conditional", "num_classes",
              "lastksize", "precision") + fields:
        assert getattr(got, f) == (tuple(getattr(want, f)) if f == "fsizes"
                                   else getattr(want, f)), f
