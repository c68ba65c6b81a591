"""The port's analysis (`convolutional_diffusion_tpu_torch.analysis`) and the
differentiable score modules it needs, held against the JAX package on the
CPU.

The score modules differentiate: their Jacobians (`torch.func.jacrev`, the
modules with a flash-score sweep built with use_pallas=False) equal JAX's on
the same numpy inputs within 1e-5 of the Jacobian's scale; the kernel route
refuses inputs that require grad. Then JAX's own analysis tests
(`tests/test_analysis.py`) against the port: the exterior derivative's
properties and a CNN-shaped field through the converted ResNet (against
JAX's in float64, 1e-5 of scale), and the patch statistics (distances
against JAX and scipy within 32 float32 ulps of ||a||^2 + ||b||^2, the
radial spectrum within 1e-5 of its scale, the fits identical)."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu import scores as jscores
from convolutional_diffusion_tpu.analysis import exterior_derivative as jed
from convolutional_diffusion_tpu.analysis import patch_statistics as jps
from convolutional_diffusion_tpu_torch import scores as tscores
from convolutional_diffusion_tpu_torch.analysis import patch_statistics as ps
from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import (
    ExteriorDerivative,
    compute_exterior_derivative,
    compute_exterior_derivative_nd,
    conservative_field,
    exterior_derivative_magnitude,
    is_closed,
    is_exact,
    jacobian_nd,
    rotation_field,
)
from convolutional_diffusion_tpu_torch.data import synthetic_dataset
from convolutional_diffusion_tpu_torch.ops import flash_score as tfs
from convolutional_diffusion_tpu_torch.ops.patches import window_view
from convolutional_diffusion_tpu_torch.scores import els as tels

TOL = 1e-5  # of the Jacobian's scale, max|J|
T = 0.5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1e-30)


def _data(c=3, n=16, size=8):
    rs = np.random.RandomState(0)
    images = rs.uniform(-1, 1, (n, size, size, c)).astype(np.float32)
    labels = rs.randint(0, 4, n).astype(np.int32)
    x = rs.normal(size=(1, size, size, c)).astype(np.float32)
    return images, labels, x


def _jax_jacobian(fn, x):
    """JAX's Jacobian of fn at x, eager once first (the modules' caches),
    then jitted."""
    fn(jnp.asarray(x))
    n = x.size
    flat = lambda xf: fn(xf.reshape(x.shape)).reshape(n)  # noqa: E731
    return np.asarray(jax.jit(jax.jacrev(flat))(jnp.asarray(x).reshape(n)))


# kind -> (JAX class, port class, keywords both take)
MODULES = {
    "bbELS": (jscores.LocalEquivBordersScoreModule, tscores.LocalEquivBordersScoreModule,
              dict(kernel_size=3, batch_size=8, use_pallas=False)),
    "ELS": (jscores.LocalEquivScoreModule, tscores.LocalEquivScoreModule,
            dict(kernel_size=3, batch_size=8, use_pallas=False)),
    "LS": (jscores.LocalScoreModule, tscores.LocalScoreModule,
           dict(kernel_size=3, batch_size=16, shuffle=False)),
    "IS": (jscores.IdealScoreModule, tscores.IdealScoreModule, dict(batch_size=8)),
}


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_score_jacobians_match_jax(kind):
    """The repair: the score modules differentiate (the parent's no_grad
    gave an all-zero Jacobian), and their Jacobians are JAX's."""
    jcls, tcls, kw = MODULES[kind]
    images, labels, x = _data()
    jmod = jcls((images, labels), **kw)
    tmod = tcls((images, labels), device="cpu", **kw)
    want = _jax_jacobian(lambda xb: jmod(T, xb), x)
    tmod(T, torch.from_numpy(x))  # eager first: the bank is cached outside the transform
    got = jacobian_nd(torch.from_numpy(x), lambda xb: tmod(T, xb))[0].numpy()
    assert np.abs(want).max() > 1.0
    assert _rel(got, want) <= TOL
    if kind == "bbELS":  # its curl as the analysis reads it
        df = compute_exterior_derivative_nd(torch.from_numpy(x), lambda xb: tmod(T, xb))
        assert _rel(df[0].numpy(), want - want.T) <= TOL


def test_use_pallas_is_taken_not_swallowed(monkeypatch):
    images, labels, x = _data()
    calls = {"routed": 0, "plain": 0}
    real, real_plain = tels.flash_score_update, tels.flash_score_update_plain

    def routed(*a, **k):
        calls["routed"] += 1
        return real(*a, **k)

    def plain(*a, **k):
        calls["plain"] += 1
        return real_plain(*a, **k)

    monkeypatch.setattr(tels, "flash_score_update", routed)
    monkeypatch.setattr(tels, "flash_score_update_plain", plain)
    outs = {}
    for use_pallas in (None, True, False):
        mod = tscores.LocalEquivScoreModule((images, labels), kernel_size=3, batch_size=8,
                                            use_pallas=use_pallas, device="cpu")
        assert mod.use_pallas is use_pallas
        before = dict(calls)
        outs[use_pallas] = mod(T, torch.from_numpy(x))
        took = "plain" if use_pallas is False else "routed"
        assert calls[took] > before[took]
        assert calls["plain" if took == "routed" else "routed"] == before[
            "plain" if took == "routed" else "routed"]
    # on the CPU both routes are the plain version
    assert torch.equal(outs[None], outs[False]) and torch.equal(outs[True], outs[False])
    bb = tscores.LocalEquivBordersScoreModule((images, labels), use_pallas=False, device="cpu")
    assert bb.use_pallas is False


def test_kernel_route_refuses_grad():
    """The kernels read raw pointers: an input that requires grad is refused
    with a pointer to use_pallas=False, instead of a Jacobian of zeros."""
    q = torch.randn(4, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        tfs._refuse_grad(q, torch.zeros(4))
    with torch.no_grad():
        tfs._refuse_grad(q)
    tfs._refuse_grad(q.detach(), None, 0.5)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_split_and_bf16_tiers_refuse_grad(precision):
    """The plain version differentiates at 'highest' only: at 'high' and
    'default' it repeats the kernels' roundings step by step."""
    images, labels, x = _data()
    mod = tscores.LocalEquivScoreModule((images, labels), kernel_size=3, batch_size=8,
                                        use_pallas=False, precision=precision, device="cpu")
    x = torch.from_numpy(x)
    assert torch.isfinite(mod(T, x)).all()  # no grad needed: it runs
    with pytest.raises(NotImplementedError, match="'highest'"):
        jacobian_nd(x, lambda xb: mod(T, xb))


@pytest.mark.parametrize("case", ["1-D", "per-seed", "masked"])
def test_plain_block_backward_matches_autograd(case, monkeypatch):
    """The plain sweep's block backward (recomputed exponentials, the [M, n]
    work shared by every lane) against autograd through the same ops, on the
    offset-invariant quantities m + log s1 and s2 / s1 of a chained state."""
    g = torch.Generator().manual_seed(1)
    M, d, P, c = 64, 8, 3 * 1024, 3
    q = torch.randn(M, d, generator=g)
    qn = (q * q).sum(1)
    bank = torch.randn(P, d, generator=g)
    pn = (bank * bank).sum(1)
    values = torch.randn(P, c, generator=g)
    w = torch.rand((2, P) if case == "per-seed" else (P,), generator=g) + 0.1
    kw = dict(rows_per_seed=M // 2) if case == "per-seed" else {}
    if case == "masked":
        mask = torch.zeros(tfs.prune_grid(M, P), dtype=torch.int32)
        mask[0, 1] = 1
        kw["prune_mask"] = mask
    monkeypatch.setattr(tfs, "PLAIN_BLOCK", 1024)  # three blocks

    cuts = [slice(0, P)] if case == "masked" else [slice(0, P // 2), slice(P // 2, P)]

    def fn(qq):
        state = (torch.full((M,), tfs.NEG_INF), torch.zeros(M), torch.zeros(M, c))
        for cut in cuts:  # two chained calls, or one masked one
            state = tfs.flash_score_update(qq, (qq * qq).sum(1), bank[cut], pn[cut],
                                           values[cut], w[..., cut], 0.8, 0.6, state, **kw)
        m, s1, s2 = state
        return torch.cat([m + torch.log(s1), (s2 / s1[:, None]).reshape(-1)])

    got = torch.func.jacrev(fn)(q)
    monkeypatch.setattr(tfs._Fp32Block, "apply", staticmethod(
        lambda q_, bank_, bias_, v_, skip_, ds_, m_, s1_, s2_: tfs._online_step(
            tfs._block_logits(q_, bank_, bias_, skip_, ds_), v_, m_, s1_, s2_)))
    want = torch.func.jacrev(fn)(q)
    assert want.abs().max() > 0.1
    assert _rel(got.numpy(), want.numpy()) <= TOL


def test_window_view_gathers_under_autograd_bit_equal():
    """Under autograd the windows come from an index gather, whose backward
    batches under vmap (`unfold`'s does not): the same values."""
    x = torch.randn(2, 7, 6, 3)
    plain = window_view(x, 3)
    gathered = window_view(x.clone().requires_grad_(), 3)
    assert gathered.shape == plain.shape and torch.equal(gathered.detach(), plain)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the per-lane fallback warns
        J = torch.func.jacrev(lambda v: window_view(v, 3).sum((1, 2, 3, 4)))(x)
    assert J.shape == (2, 3, 2, 7, 6, 3)


# --- exterior derivative: JAX's tests/test_analysis.py ----------------------


def _randn(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def test_conservative_field_is_closed():
    df = compute_exterior_derivative(_randn(0, 4, 5), conservative_field)
    assert df.shape == (4, 5, 5)
    assert bool(is_closed(df).all()) and is_exact(df)


def test_gradient_field_is_closed():
    df = compute_exterior_derivative(_randn(1, 3, 6), lambda x: 4 * x**3 + 2 * x)
    np.testing.assert_allclose(df.numpy(), 0.0, atol=1e-5)


def test_rotation_field_known_magnitude():
    df = compute_exterior_derivative(_randn(2, 5, 2), rotation_field)
    # J = [[0, -1], [1, 0]]; df = [[0, -2], [2, 0]]; ||df||_F = 2 sqrt(2)
    np.testing.assert_allclose(exterior_derivative_magnitude(df).numpy(), 2 * np.sqrt(2),
                               rtol=1e-5)
    assert not bool(is_closed(df).any())


def test_antisymmetry():
    df = compute_exterior_derivative(_randn(3, 2, 7), lambda x: torch.sin(x) * torch.roll(x, 1))
    np.testing.assert_allclose(df.numpy(), -df.transpose(1, 2).numpy(), atol=1e-6)


def test_nd_cnn_shaped_input():
    def score_fn(x):  # [b, h, w, c] -> [b, h, w, c]
        return -x + 0.1 * torch.roll(x, 1, dims=1)

    x = _randn(4, 2, 4, 4, 1)
    df = compute_exterior_derivative_nd(x, score_fn)
    assert df.shape == (2, 16, 16)
    np.testing.assert_allclose(df.numpy(), -df.transpose(1, 2).numpy(), atol=1e-6)
    df0 = compute_exterior_derivative_nd(x[:1], score_fn)
    np.testing.assert_allclose(df[:1].numpy(), df0.numpy(), atol=1e-6)
    jdf = jed.compute_exterior_derivative_nd(
        jnp.asarray(x.numpy()), lambda v: -v + 0.1 * jnp.roll(v, 1, axis=1))
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), atol=1e-6)


def test_batch_independence(monkeypatch):
    from convolutional_diffusion_tpu_torch.analysis import exterior_derivative

    monkeypatch.setattr(exterior_derivative, "CPU_LANES", 3)  # the lanes in chunks
    x = _randn(5, 3, 4)
    df_all = compute_exterior_derivative(x, lambda v: v**2)
    for i in range(3):
        df_i = compute_exterior_derivative(x[i:i + 1], lambda v: v**2)
        np.testing.assert_allclose(df_all[i].numpy(), df_i[0].numpy())


def test_exterior_derivative_class_wrapper():
    ed = ExteriorDerivative(conservative_field, flatten=False)
    x = _randn(0, 2, 4)
    assert ed(x).shape == (2, 4, 4)
    np.testing.assert_allclose(ed.magnitude(x).numpy(), 0.0, atol=1e-5)
    nd = ExteriorDerivative(lambda v: -v)
    assert nd(_randn(1, 2, 3, 3, 1)).shape == (2, 9, 9)


def test_cnn_field_matches_jax_through_converter():
    """A CNN-shaped field: a small ResNet (the flagship's mode and norm) with
    the port's seeded weights, carried to the JAX model by the JAX
    package's converter; its curl against JAX's
    `compute_exterior_derivative_nd` in float64."""
    from convolutional_diffusion_tpu import convert as jconvert
    from convolutional_diffusion_tpu import models as jmodels
    from convolutional_diffusion_tpu_torch import models as tmodels

    arch = dict(channels=3, emb_dim=16, kernel_size=3, num_layers=2, lastksize=3,
                mode="zeros", normalization="GroupNorm", conditional=False)
    model = tmodels.DiffusionModel(tmodels.MinimalResNet(**arch), in_channels=3,
                                   default_imsize=8, seed=3, device="cpu")
    params = jconvert.resnet_params_from_torch(
        {k: v.numpy() for k, v in model.backbone.state_dict().items()},
        num_layers=2, normalization="GroupNorm", conditional=False)
    jnet = jmodels.MinimalResNet(**arch)
    x = np.random.RandomState(4).normal(size=(2, 6, 6, 3)).astype(np.float32)
    got = compute_exterior_derivative_nd(torch.from_numpy(x), lambda xb: model(T, xb))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), {"params": params})
        want = jax.jit(lambda xx: jed.compute_exterior_derivative_nd(
            xx, lambda xb: jnet.apply(v64, jnp.full((1,), T, jnp.float64), xb, None)))(
                jnp.asarray(x, jnp.float64))
    assert np.abs(np.asarray(want)).max() > 0.1
    assert _rel(got.numpy(), want) <= TOL


# --- patch statistics --------------------------------------------------------


def test_random_patches_shape_and_range():
    ds = synthetic_dataset(num_samples=32, image_size=16, num_channels=3)
    patches = ps.random_patches(torch.from_numpy(ds.images), 5, 50,
                                torch.Generator().manual_seed(0))
    assert patches.shape == (50, 5, 5, 3)
    assert patches.abs().max() <= 1.0
    # each patch is a crop of an image
    p = patches[0].numpy()
    windows = window_view(torch.from_numpy(ds.images), 5).reshape(-1, 5, 5, 3).numpy()
    assert (np.abs(windows - p).reshape(len(windows), -1).max(1) == 0).any()


def test_shape_robustness():
    assert ps.random_patches(torch.ones(16, 16), 4, 5).shape == (5, 4, 4, 1)
    assert ps.random_patches(torch.ones(6, 16, 16), 4, 5).shape == (5, 4, 4, 1)
    assert ps.random_patches(torch.ones(16, 16, 3), 4, 5).shape == (5, 4, 4, 3)


def test_patch_too_large_raises():
    ds = synthetic_dataset(num_samples=4, image_size=8, num_channels=1)
    with pytest.raises(ValueError):
        ps.random_patches(torch.from_numpy(ds.images), 9, 10)


def _d2_ulps(dists, patches):
    """max |d^2 - exact d^2| / (||a||^2 + ||b||^2) in float32 ulps (2^-24)."""
    f = np.asarray(patches, np.float64).reshape(len(patches), -1)
    sq = (f * f).sum(1)
    i, j = np.triu_indices(len(f), 1)
    exact = ((f[i] - f[j]) ** 2).sum(1)
    return np.abs(np.asarray(dists, np.float64) ** 2 - exact).max() / (
        (sq[i] + sq[j]).min() * 2.0**-24)


def test_pairwise_distances_match_jax_and_scipy():
    from scipy.spatial.distance import pdist

    patches = np.random.RandomState(0).normal(size=(20, 3, 3, 2)).astype(np.float32)
    ours = ps.pairwise_distances(torch.from_numpy(patches)).numpy()
    theirs = np.asarray(jps.pairwise_distances(jnp.asarray(patches)))
    ref = pdist(patches.reshape(20, -1))
    assert ours.shape == theirs.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    assert _d2_ulps(ours, patches) <= 32
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-6)


def test_fit_recovers_weibull_and_equals_jax():
    from scipy import stats

    data = stats.weibull_min.rvs(2.0, loc=0, scale=3.0, size=4000, random_state=0)
    fits = ps.fit_distributions(data)
    assert fits["best_fit"] in ("weibull", "gev")  # GEV nests Weibull
    assert fits["weibull"]["ks_pvalue"] > 0.01
    c, loc, scale = fits["weibull"]["params"]
    assert abs(c - 2.0) < 0.3 and abs(scale - 3.0) < 0.3
    assert fits == jps.fit_distributions(data)


def test_fit_too_few_samples_raises():
    with pytest.raises(ValueError):
        ps.fit_distributions(np.ones(5))


def test_radial_power_spectrum_matches_jax():
    radii, power = ps.radial_power_spectrum(torch.ones(8, 8))
    assert power[0] > 0
    np.testing.assert_allclose(power[1:].numpy(), 0.0, atol=1e-6)
    patch = np.random.RandomState(1).normal(size=(10, 10, 3)).astype(np.float32)
    radii, power = ps.radial_power_spectrum(torch.from_numpy(patch))
    jradii, jpower = jps.radial_power_spectrum(jnp.asarray(patch))
    np.testing.assert_array_equal(radii, jradii)
    assert _rel(power.numpy(), np.asarray(jpower)) <= TOL


def test_analyze_patch_distances_end_to_end(tmp_path):
    ds = synthetic_dataset(num_samples=64, image_size=16, num_channels=1)
    res = ps.analyze_patch_distances(
        ds.images, patch_size=4, num_samples=60, generator=torch.Generator().manual_seed(1),
        dataset_name="synth", save_dir=str(tmp_path), device="cpu")
    assert res["num_distances"] == 60 * 59 // 2
    assert "best_fit" in res["fits"]
    assert os.path.exists(tmp_path / "synth_patch4_analysis.json")
    assert os.path.exists(tmp_path / "synth_patch4_analysis.png")
    with open(tmp_path / "synth_patch4_analysis.json") as f:
        blob = json.load(f)
    assert blob["dataset"] == "synth" and "_distances" not in blob
    # the same draws again: the same result; and what it reports is the
    # fits, spectrum and statistics of its own patches
    again = ps.analyze_patch_distances(
        ds.images, patch_size=4, num_samples=60, generator=torch.Generator().manual_seed(1),
        device="cpu", make_plots=False)
    np.testing.assert_array_equal(again["_distances"], res["_distances"])
    patches = ps.random_patches(torch.from_numpy(ds.images), 4, 60,
                                torch.Generator().manual_seed(1))
    d = ps.pairwise_distances(patches).numpy()
    np.testing.assert_array_equal(res["_distances"], d)
    assert res["fits"] == jps.fit_distributions(d)
    _, power = jps.radial_power_spectrum(jnp.asarray(patches.mean(0).numpy()))
    assert _rel(res["power_spectrum"]["power"], np.asarray(power)) <= TOL


def test_multi_dataset_driver_contains_failures(tmp_path):
    good = synthetic_dataset(num_samples=32, image_size=16, num_channels=1).images
    bad = np.zeros((2, 4, 4, 1), np.float32)  # too small for k = 6
    logs = []
    res = ps.analyze_multiple_datasets(
        {"good": good, "bad": bad}, patch_sizes=(3, 6), num_samples=40,
        save_dir=str(tmp_path), log_fn=logs.append, device="cpu")
    assert 3 in res["good"] and 6 in res["good"]
    assert 6 not in res["bad"]  # failed, and did not stop the run
    assert any("FAILED" in line for line in logs)
    assert os.path.exists(tmp_path / "good_distribution_comparison.png")
