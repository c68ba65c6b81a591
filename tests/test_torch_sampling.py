"""Port vs JAX and vs the torch-reference goldens: the samplers
(`convolutional_diffusion_tpu_torch.sampling`) on the CPU.

Tolerances: trajectories and steps within 2e-5 relative to scale
(atol = 2e-5 * max|expect|, as `tests/test_parity_torch.py`; the zero-noise
DDPM golden at 2e-5 * max(|expect|, 1)); DDPM, whose random stream cannot
match JAX's or torch's draw for draw, by its per-pixel moments over 512
seeds at `tests/test_ddpm_moments.py`'s 6-sigma bounds, and by `ddpm_step`
with injected noise against JAX at 2e-5 relative to scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu import convert as jconvert
from convolutional_diffusion_tpu import sampling as jsampling
from convolutional_diffusion_tpu.models import DiffusionModel as JDiffusionModel
from convolutional_diffusion_tpu.models import MinimalResNet as JMinimalResNet
from convolutional_diffusion_tpu_torch import sampling as tsampling
from convolutional_diffusion_tpu_torch.models import DiffusionModel, MinimalResNet
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule

ARCH = dict(channels=3, emb_dim=16, kernel_size=3, num_layers=2, lastksize=3, mode="zeros")


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _sd(z):
    return {k[3:]: z[k] for k in z.files if k.startswith("sd/")}


def _models(sd):
    """The port's model and the JAX model + params, both with `sd`."""
    net = MinimalResNet(**ARCH)
    model = DiffusionModel(net, in_channels=3, default_imsize=16, device="cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jmodel = JDiffusionModel(JMinimalResNet(**ARCH), in_channels=3, default_imsize=16)
    params = jconvert.resnet_params_from_torch(sd, num_layers=2)
    return model, jmodel, params


@pytest.fixture(scope="module")
def golden():
    z = np.load("tests/goldens/sample.npz")
    return (z, *_models(_sd(z)))


def _close(got, expect, floor=0.0):
    expect = np.asarray(expect)
    atol = 2e-5 * max(np.abs(expect).max(), floor)
    np.testing.assert_allclose(np.asarray(got), expect, atol=atol)


@pytest.mark.parametrize("breakstep,key", [(-1, "out_ddim"), (3, "out_break"),
                                           (5, None), (7, "out_ddim")])
def test_ddim_matches_golden_and_jax(golden, breakstep, key):
    """breakstep inside the loop (3), at nsteps (5: every step frozen) and
    above it (7: the full pass, as the reference's loop never meets it)."""
    z, model, jmodel, params = golden
    x0 = _nhwc(z["x0"])
    out = tsampling.sample(model, x=x0, nsteps=5, breakstep=breakstep, device="cpu")
    want = jsampling.sample(jmodel, params, x=jnp.asarray(x0), nsteps=5,
                            breakstep=breakstep)
    _close(out, want)
    if key is not None:
        _close(out, _nhwc(z[key]))
    else:
        np.testing.assert_array_equal(out.numpy(), x0)


def test_ddpm_step_injected_noise_matches_golden_and_jax(golden):
    z, model, jmodel, params = golden
    x = torch.from_numpy(_nhwc(z["x0"]))
    jx = jnp.asarray(_nhwc(z["x0"]))
    rs = np.random.RandomState(0)
    for i in range(5, 0, -1):
        t = torch.full((2,), i / 5)
        beta_t, beta_prev = cosine_noise_schedule(t), cosine_noise_schedule(t - 1 / 5)
        with torch.no_grad():
            eps = model(t, x)
        noise = rs.normal(size=x.shape).astype(np.float32)
        got = tsampling.ddpm_step(x, eps, beta_t, beta_prev, torch.from_numpy(noise))
        want = jsampling.ddpm_step(jx, jnp.asarray(eps.numpy()), jnp.asarray(beta_t.numpy()),
                                   jnp.asarray(beta_prev.numpy()), jnp.asarray(noise))
        _close(got, want)
        # the zero-noise trajectory is the golden's
        x = tsampling.ddpm_step(x, eps, beta_t, beta_prev, torch.zeros_like(x))
        jt = jnp.full((2,), i / 5)
        jeps = jmodel.apply(params, jt, jx, None)
        jx = jsampling.ddpm_step(jx, jeps, jmodel.noise_schedule(jt),
                                 jmodel.noise_schedule(jt - 1 / 5), jnp.zeros_like(jx))
    _close(x, _nhwc(z["out_ddpm0"]), floor=1.0)
    _close(x, jx, floor=1.0)


def test_ddpm_sigma_guards():
    """sigma's maximum(beta_t, 1e-20) guard and the clamp at 0 (beta_t = 0
    at t = 0): finite, and against JAX."""
    x = torch.ones(2, 2, 2, 1)
    eps = torch.full_like(x, 0.5)
    noise = torch.full_like(x, 0.25)
    beta_t = torch.tensor([0.0, 0.3])
    beta_prev = torch.tensor([0.0, 0.1])
    got = tsampling.ddpm_step(x, eps, beta_t, beta_prev, noise)
    want = jsampling.ddpm_step(*(jnp.asarray(a.numpy()) for a in (x, eps, beta_t, beta_prev,
                                                                   noise)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_q_sample_and_make_sampler(golden):
    z, model, _, _ = golden
    x0 = torch.from_numpy(_nhwc(z["x0"]))
    eps = torch.ones_like(x0)
    beta = torch.tensor([0.25, 0.64])
    got = tsampling.q_sample(x0, eps, beta)
    want = jsampling.q_sample(jnp.asarray(x0.numpy()), jnp.ones(x0.shape), jnp.asarray(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    fn = tsampling.make_sampler(model, nsteps=5)
    _close(fn(x0), _nhwc(z["out_ddim"]))


def test_step_betas_match_the_jax_scan():
    ts, betas, prevs = tsampling.step_betas(cosine_noise_schedule, 20, "cpu")
    steps = np.arange(20, 0, -1)
    jt = jnp.asarray(steps).astype(jnp.float32) * jnp.ones(()) / 20
    from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos

    np.testing.assert_array_equal(ts.numpy(), np.asarray(jt))
    np.testing.assert_allclose(betas.numpy(), np.asarray(jcos(jt)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(prevs.numpy(), np.asarray(jcos(jt - 1.0 / 20)),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def moments():
    z = np.load("tests/goldens/ddpm_moments.npz")
    model, _, _ = _models(_sd(z))
    return z, model, torch.from_numpy(_nhwc(z["x0"]))


def _check_moments(ours, mean_key, std_key, z, n=512):
    ours = ours.numpy()
    mean = ours.mean(axis=0)
    std = ours.std(axis=0, ddof=1)
    exp_mean = np.transpose(z[mean_key], (1, 2, 0))
    exp_std = np.transpose(z[std_key], (1, 2, 0))
    tol_mean = 6.0 * exp_std / np.sqrt(n)  # the mean's sd ~ sigma / sqrt(n)
    assert np.all(np.abs(mean - exp_mean) < tol_mean + 1e-6)
    tol_std = 6.0 * exp_std / np.sqrt(2 * (n - 1))  # the std's sd
    assert np.all(np.abs(std - exp_std) < tol_std + 1e-6)


@pytest.mark.parametrize("breakstep,keys,seed", [(-1, ("final_mean", "final_std"), 123),
                                                 (3, ("mid_mean", "mid_std"), 321)])
def test_ddpm_moments(moments, breakstep, keys, seed):
    z, model, x0 = moments
    out = tsampling.sample(model, x=x0, nsteps=5, ddpm=True, breakstep=breakstep,
                           generator=torch.Generator().manual_seed(seed), device="cpu")
    _check_moments(out, *keys, z)


def test_ddpm_distinct_generators_distinct_samples(moments):
    _, model, x0 = moments
    a, b = (tsampling.sample(model, x=x0[:4], nsteps=5, ddpm=True, device="cpu",
                             generator=torch.Generator().manual_seed(s)) for s in (1, 2))
    assert not torch.allclose(a, b)


def test_sample_draws_seeds_and_checks_its_arguments(golden):
    _, model, _, _ = golden
    a = tsampling.sample(model, batch_size=3, nsteps=2, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    b = tsampling.sample(model, batch_size=3, nsteps=2, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert a.shape == (3, 16, 16, 3) and torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        tsampling.sample(model, batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        tsampling.sample(model, x=torch.zeros(1, 16, 16, 3), ddpm=True, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        tsampling.sample(model, x=torch.zeros(1, 16, 16, 3), device="meta")
