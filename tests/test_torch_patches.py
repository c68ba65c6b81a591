"""Port vs JAX: patch extraction and padding. Pure data movement, so the
results must be bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.ops.patches as jp
import convolutional_diffusion_tpu_torch.ops.patches as tp


def _images(c, seed=0):
    return np.random.default_rng(seed).normal(size=(2, 7, 6, c)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("mode", ["circular", "zeros"])
@pytest.mark.parametrize("c", [1, 3])
def test_padded_patches_bit_equal(k, mode, c):
    x = _images(c, seed=k * 10 + c)
    ours = tp.extract_patches(tp.pad_image(torch.from_numpy(x), k // 2, mode), k)
    want = jp.extract_patches(jp.pad_image(jnp.asarray(x), k // 2, mode), k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("c", [1, 3])
def test_centers_bit_equal(k, c):
    x = _images(c, seed=k + c)
    ours = tp.extract_patches(torch.from_numpy(x), k)
    want = jp.extract_patches(jnp.asarray(x), k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    assert tp.center_index(k, c) == jp.center_index(k, c)
    np.testing.assert_array_equal(
        tp.patch_centers(ours, k, c).numpy(),
        np.asarray(jp.patch_centers(want, k, c)),
    )


def test_circular_pad_wider_than_image():
    x = _images(1)[:, :3, :3]
    ours = tp.pad_image(torch.from_numpy(x), 4, "circular")
    want = jp.pad_image(jnp.asarray(x), 4, "circular")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="mode"):
        tp.pad_image(torch.from_numpy(x), 1, "reflect")
