"""Base class for analytic score modules.

Counterpart of `convolutional_diffusion_tpu/scores/base.py`. A module holds
the training set as device tensors and computes the exact Bayes-optimal score
of the empirical distribution under a locality / equivariance restriction,
by streaming the training set through an online softmax.

Conventions (shared with the JAX package, so one numpy array feeds both):
 - x is NHWC [b, h, w, c]; t is a scalar or [b] with equal entries;
 - label is None, a scalar int, or (where `supports_vector_label`) a [b]
   vector with one label per seed;
 - the SCORE is returned (not epsilon): -(x - a_t * posterior_mean) / beta_t.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..schedules import cosine_noise_schedule

PRECISIONS = ("highest", "high", "default")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another. Without a CUDA device that is an error, never a quiet CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def _as_scalar_t(t) -> torch.Tensor:
    """t as a float32 0-d CPU tensor (the first entry of a [b] vector)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if t.ndim > 0:
        t = t.reshape(-1)[0]
    return t.cpu()


class ScoreModuleBase:
    """Holds the dataset tensors and the configuration; subclasses implement
    `_score(k, x, label, at, bt, order)`."""

    supports_vector_label = False

    def __init__(
        self,
        dataset,
        *,
        kernel_size: int = 3,
        batch_size: int = 64,
        schedule: Callable = cosine_noise_schedule,
        max_samples: Optional[int] = None,
        chunk_size: Optional[int] = None,
        precision: str = "highest",
        shuffle: bool = False,
        generator: Optional[torch.Generator] = None,
        device=None,
        **_unused,
    ):
        """precision: 'highest' (true fp32 dots: the parity configuration,
        kernel K1 on the card), 'high' (the flash-score sweeps' QK dots as
        a bf16x3 split, ~2^-16 relative dot error, with fp32 elementwise:
        kernel K2 on the card) or 'default' (the same split dots with a
        bf16 exponential and bf16 value products, ~3e-3 on posterior
        means: kernel K3/K4 on the card). Dots outside the sweeps stay
        fp32 at every tier.

        chunk_size: images per compute chunk where a module streams the raw
        images (default batch_size); the reference's semantics stay keyed
        to batch_size, whatever the chunk.

        shuffle: stream the dataset in a fresh random order on every call
        (the reference DataLoader's shuffle=True), drawn with `generator`
        (default: a CPU generator seeded with 0). Order changes results only
        through batch composition; see common.image_weights."""
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be 'highest', 'high' or 'default', got "
                f"{precision!r}"
            )
        self.device = resolve_device(device)
        images, labels = dataset
        # tensors (e.g. another module's) are kept as they are where they
        # already lie on the device: no second copy of the dataset
        if not isinstance(images, torch.Tensor):
            images = torch.as_tensor(np.asarray(images, dtype=np.float32))
        if not isinstance(labels, torch.Tensor):
            labels = torch.as_tensor(np.asarray(labels, dtype=np.int64))
        if images.ndim != 4:
            raise ValueError("dataset images must be [N, h, w, c] (NHWC)")
        self.images = images.to(self.device, torch.float32)
        self.labels = labels.to(self.device, torch.int64)
        self.kernel_size = kernel_size
        self.batch_size = batch_size
        self.chunk_size = chunk_size or batch_size
        self.schedule = schedule
        self.max_samples = max_samples
        self.precision = precision
        self.shuffle = shuffle
        self._generator = (
            generator if generator is not None
            else torch.Generator().manual_seed(0)
        )

    def _stream_order(self, order=None) -> torch.Tensor:
        """The per-call stream order: an explicit `order` wins; else a fresh
        permutation when self.shuffle; else the identity. Over the whole
        image set (the labels), also where a module holds a shard of it."""
        n = self.labels.shape[0]
        if order is None and self.shuffle:
            order = torch.randperm(
                n, generator=self._generator, device=self._generator.device
            )
        if order is None:
            order = torch.arange(n)
        if not isinstance(order, torch.Tensor):
            order = torch.as_tensor(np.asarray(order))
        return order.to(device=self.device, dtype=torch.long)

    def _check_k(self, k) -> int:
        k = self.kernel_size if k is None else int(k)
        if k % 2 == 0 or k < 1:
            raise ValueError(
                f"kernel size must be odd and positive, got {k} (the k//2 "
                "window padding assumes a center pixel)"
            )
        return k

    def _coeffs(self, t):
        """(a_t, b_t) = (sqrt(1 - beta), sqrt(beta)) as float32 CPU scalars."""
        beta = self.schedule(_as_scalar_t(t))
        return torch.sqrt(1.0 - beta), torch.sqrt(beta)

    def _score(self, k, x, label, at, bt, order):
        raise NotImplementedError

    # The sharding hooks (`parallel.sharded_score`): a module holding one
    # rank's shard of the images slices the global per-image weights to it
    # and merges its partial softmax states over the mesh. On one device
    # both are the identity.
    def _local_weights(self, w: torch.Tensor) -> torch.Tensor:
        """Per-image weights ([n] or [S, n]) of the images this module holds."""
        return w

    def _merge(self, states) -> list:
        """Partial (m, s1, s2) states of this module's images -> the states
        of the whole image set."""
        return states

    def __call__(self, t, x, label=None, k=None, order=None):
        k = self._check_k(k)
        if label is not None and np.ndim(label) >= 1 and not self.supports_vector_label:
            raise ValueError(
                f"{type(self).__name__} takes a scalar label per call"
            )
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        at, bt = self._coeffs(t)
        return self._score(k, x, label, at, bt, self._stream_order(order))
