"""Reference whole pickles (`tests/goldens/pickles/backbone_*.pt`) load into
the port without the reference's code, with their architecture read back
from the pickled attributes, and reproduce the torch forwards recorded in
`tests/goldens/pickle_forward.npz` (atol 5e-5, rtol 2e-4, as
`tests/test_convert_pickle.py`) and the JAX package's forward of the same
pickle (max|a-b| / max(|a|,|b|,1) <= 1e-5). BatchNorm running statistics
cross from JAX variables exactly."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu import convert as jconvert
from convolutional_diffusion_tpu import models as jmodels
from convolutional_diffusion_tpu_torch import convert as tconvert
from convolutional_diffusion_tpu_torch.cli.common import load_model

PICKLES = "tests/goldens/pickles/"


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


@pytest.fixture(scope="module")
def z():
    return np.load("tests/goldens/pickle_forward.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


CASES = {
    # pickle -> (architecture read back, conditional)
    "backbone_resnet_cond.pt": (dict(kind="MinimalResNet", mode="zeros", normalization=None,
                                     add_one=True, num_classes=10, emb_dim=16,
                                     num_layers=2, kernel_size=3, lastksize=3), True),
    "backbone_unet.pt": (dict(kind="MinimalUNet", mode="zeros", normalization="GroupNorm",
                              fsizes=(8, 16), last_norm=True, num_classes=None,
                              emb_dim=16, kernel_size=3, lastksize=1), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pickle_loads_and_matches_reference_forward(z, name):
    arch, conditional = CASES[name]
    model = tconvert.diffusion_model_from_torch_pickle(PICKLES + name, device="cpu")
    net = model.backbone
    assert type(net).__name__ == arch.pop("kind")
    for attr, want in arch.items():
        assert getattr(net, attr) == want, attr
    assert net.conditional == conditional
    assert model.in_channels == 3 and model.default_imsize == 16
    assert not model.training and model.device.type == "cpu"
    label = torch.from_numpy(z["label"]) if conditional else None
    with torch.no_grad():
        out = model(torch.from_numpy(z["t"]), torch.from_numpy(_nhwc(z["x"])), label)
    key = "resnet_out" if "resnet" in name else "unet_out"
    np.testing.assert_allclose(out.numpy(), _nhwc(z[key]), atol=5e-5, rtol=2e-4)
    # the JAX package's forward of the same pickle
    jmodel, params = jconvert.diffusion_model_from_torch_pickle(PICKLES + name)
    want = jmodel.apply(params, jnp.asarray(z["t"]), jnp.asarray(_nhwc(z["x"])),
                        jnp.asarray(z["label"]) if conditional else None)
    assert _rel(out.numpy(), want) <= 1e-5


def test_load_model_reads_pickles_and_refuses_checkpoint_dirs(tmp_path):
    model = load_model(PICKLES + "backbone_resnet_cond.pt", device="cpu")
    assert model.conditional
    # a directory without this package's checkpoint (an Orbax one, say)
    with pytest.raises(ValueError, match="Orbax"):
        load_model(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match=".pt"):
        load_model(str(tmp_path / "model.msgpack"), device="cpu")


_PROBE = r"""
import sys
from convolutional_diffusion_tpu_torch import convert
stub = convert.load_torch_pickle(sys.argv[1])
print(type(stub).__name__, stub._stub_classname)
print(sorted(m for m in sys.modules if m == "src" or m.startswith("src.")))
"""


def test_unpickling_imports_no_reference_code():
    """Every reference class becomes a stub: no `src.*` module is imported,
    even where one would be importable."""
    out = subprocess.run([sys.executable, "-c", _PROBE, PICKLES + "backbone_unet.pt"],
                         capture_output=True, text=True, check=True, timeout=120)
    first, mods = out.stdout.strip().splitlines()[-2:]
    assert first == "DDIM src.models.DDIM" and mods == "[]"


def test_unknown_backbone_class_is_refused(tmp_path):
    """A pickle whose backbone is not a reference ResNet or UNet."""
    path = tmp_path / "other.pt"
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="unsupported backbone"):
        tconvert.diffusion_model_from_torch_pickle(str(path), device="cpu")


def test_module_state_dict_walks_stubs_and_torch_modules():
    stub = tconvert.load_torch_pickle(PICKLES + "backbone_resnet_cond.pt")
    backbone = tconvert.module_child(stub, "backbone")
    assert isinstance(backbone, tconvert._StubModule)
    sd = tconvert.module_state_dict(backbone)
    assert sd["embedding.class_embeddings.weight"].shape == (10, 16)
    assert isinstance(tconvert.module_child(backbone, "up_projection"), torch.nn.Conv2d)
    assert tconvert.module_attr(backbone, "mode") == "zeros"


def test_batchnorm_stats_cross_from_jax_variables():
    """JAX variables' batch_stats -> running_mean / running_var exactly; the
    params-only tree would leave them at their defaults."""
    net = jmodels.MinimalUNet(channels=3, fsizes=(8, 16), emb_dim=16, mode="zeros",
                              normalization="BatchNorm", last_norm=True)
    variables = jmodels.DiffusionModel(net, default_imsize=16).init_variables(
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rs.uniform(0.5, 2.0, a.shape).astype(np.float32), variables["batch_stats"])
    sd = tconvert.unet_state_dict_from_jax_params(
        variables, n_feature_blocks=1, normalization="BatchNorm", last_norm=True)
    bs = variables["batch_stats"]
    np.testing.assert_array_equal(sd["feature_blocks.0.model.1.running_mean"].numpy(),
                                  bs["feature_block_0"]["norm_0"]["mean"])
    np.testing.assert_array_equal(sd["output_blocks.0.model.4.running_var"].numpy(),
                                  bs["output_block_0"]["norm_1"]["var"])
    np.testing.assert_array_equal(sd["last_normalizer.running_var"].numpy(),
                                  bs["last_normalizer"]["var"])

