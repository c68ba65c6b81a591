"""Port vs JAX: noise schedules, on a t grid that includes t <= 0 (the score
machine's last step evaluates beta(t - 1/nsteps) = beta(0)).

Tolerance: both sides compute in float32 from the same formula; agreement to
1 ulp (rtol 1e-6, atol 1e-7)."""

import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.schedules as jsched
import convolutional_diffusion_tpu_torch.schedules as tsched

T_GRID = np.concatenate([
    np.linspace(-0.3, 1.2, 31, dtype=np.float32),
    np.float32([0.0, -0.05, 1.0 / 20, 19.0 / 20]),
])


@pytest.mark.parametrize("name", ["exponential", "linear", "cosine"])
def test_schedule_matches_jax(name):
    ours = tsched.get_schedule(name)(torch.from_numpy(T_GRID))
    want = np.asarray(jsched.get_schedule(name)(T_GRID))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["legacy", "offset"])
def test_cosine_modes_match_jax(mode):
    ours = tsched.cosine_noise_schedule(torch.from_numpy(T_GRID), mode=mode)
    want = np.asarray(jsched.cosine_noise_schedule(T_GRID, mode=mode))
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t", [0.0, -0.05, 0.05, 0.5, 0.95])
def test_scalar_inputs(t):
    for name in ("exponential", "linear", "cosine"):
        ours = float(tsched.get_schedule(name)(t))
        want = float(jsched.get_schedule(name)(np.float32(t)))
        assert ours == pytest.approx(want, rel=1e-6, abs=1e-7), name


def test_legacy_cosine_zero_at_zero_and_unknown_name():
    assert float(tsched.cosine_noise_schedule(0.0)) == 0.0
    with pytest.raises(ValueError, match="unknown schedule"):
        tsched.get_schedule("sigmoid")
