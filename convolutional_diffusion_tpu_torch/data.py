"""Datasets as whole arrays (NHWC float32 in [-1, 1], int32 labels).

Counterpart of `convolutional_diffusion_tpu/data.py`; this slice carries the
container and the deterministic synthetic family, which gives images
bit-identical to the JAX package's for the same arguments. The raw-file
parsers (MNIST, CIFAR10, CelebA) come in a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["ArrayDataset", "synthetic_dataset"]


class ArrayDataset(NamedTuple):
    images: np.ndarray  # [N, h, w, c] float32 in [-1, 1]
    labels: np.ndarray  # [N] int32

    @property
    def num_samples(self) -> int:
        return self.images.shape[0]


def synthetic_dataset(
    num_samples: int = 256,
    image_size: int = 32,
    num_channels: int = 3,
    num_classes: int = 10,
    seed: int = 0,
) -> ArrayDataset:
    """Deterministic procedural dataset (class-dependent Gabor-ish textures)
    for tests and benchmarks — no files, no network."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, num_classes, size=(num_samples,)).astype(np.int32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    imgs = np.empty((num_samples, image_size, image_size, num_channels), np.float32)
    for i in range(num_samples):
        cls = labels[i]
        phase = rs.uniform(0, 2 * np.pi)
        fx, fy = 1 + cls % 4, 1 + (cls // 4) % 4
        base = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
        for ch in range(num_channels):
            noise = rs.normal(0, 0.3, size=base.shape).astype(np.float32)
            imgs[i, :, :, ch] = np.clip(0.7 * base + noise, -1, 1)
    return ArrayDataset(imgs, labels)
