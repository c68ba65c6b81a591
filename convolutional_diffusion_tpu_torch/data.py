"""Dataset registry and loading: whole datasets as arrays (NHWC float32 in
[-1, 1], int32 labels).

Counterpart of `convolutional_diffusion_tpu/data.py`, with the same
registry, metadata table, parsers and synthetic family; given the same files
and arguments it returns the same arrays. No network: MNIST, FashionMNIST
and CIFAR10 are parsed from their standard raw files under `root`, CelebA
from its image directory (PIL, imported only there); a missing dataset
raises FileNotFoundError and nothing is downloaded.

Normalization is the reference's ToTensor then Normalize(0.5, 0.5): pixels
in [-1, 1]. Resizing (MNIST's 28 -> 32, or any `image_size`) is the JAX
package's `jax.image.resize(..., "bilinear")`: separable triangle-kernel
weights that widen by the scale factor when downsampling (antialiasing), as
`jax.image.scale_and_translate` defines them. They are computed here in
numpy; `torch.nn.functional.interpolate` follows another kernel.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import NamedTuple, Optional

import numpy as np

__all__ = ["ArrayDataset", "get_metadata", "get_dataset", "synthetic_dataset"]


class ArrayDataset(NamedTuple):
    images: np.ndarray  # [N, h, w, c] float32 in [-1, 1]
    labels: np.ndarray  # [N] int32

    @property
    def num_samples(self) -> int:
        return self.images.shape[0]


# The reference's metadata table value for value, including its CIFAR10
# train_images=60000 quirk (the train split holds 50000; the field is unused
# downstream).
_METADATA = {
    "mnist": dict(
        name="mnist", image_size=32, num_classes=10, num_channels=1,
        train_images=60000, val_images=10000, mean=[0.5], std=[0.5],
    ),
    "fashion_mnist": dict(
        name="fashion_mnist", image_size=32, num_classes=10, num_channels=1,
        train_images=60000, val_images=10000, mean=[0.5], std=[0.5],
    ),
    "cifar10": dict(
        name="cifar10", image_size=32, num_classes=10, num_channels=3,
        train_images=60000, val_images=10000, mean=[0.5, 0.5, 0.5],
        std=[0.5, 0.5, 0.5],
    ),
    "celeba": dict(
        name="celeba", image_size=32, num_classes=1, num_channels=3,
        train_images=200000, val_images=0, mean=[0.5, 0.5, 0.5],
        std=[0.5, 0.5, 0.5],
    ),
}
_METADATA["fashionmnist"] = _METADATA["fashion_mnist"]


def get_metadata(name: str) -> dict:
    """Per-dataset metadata; an unknown name gets the reference's default."""
    name = name.lower()
    if name in _METADATA:
        return dict(_METADATA[name])
    return dict(
        name=name, image_size=32, num_classes=1, num_channels=3,
        train_images=0, val_images=0, mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5],
    )


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of a 1-D bilinear resize with
    antialiasing, as `jax.image.scale_and_translate` computes them: a
    triangle kernel at the half-centered sample positions, widened by the
    inverse scale when downsampling, each column normalized to sum 1."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_bilinear(x: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize [N, h, w, c] -> [N, size, size, c] (the JAX
    package's `jax.image.resize(x, ..., "bilinear")`)."""
    _, h, w, _ = x.shape
    out = x.astype(np.float32)
    if h != size:
        out = np.einsum("nhwc,hH->nHwc", out, _resize_weights(h, size))
    if w != size:
        out = np.einsum("nhwc,wW->nhWc", out, _resize_weights(w, size))
    return np.ascontiguousarray(out, dtype=np.float32)


def _normalize(u8: np.ndarray) -> np.ndarray:
    """uint8 [N,h,w,c] -> float32 in [-1,1] (ToTensor + Normalize(0.5, 0.5))."""
    return (u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def _load_idx(path: str) -> np.ndarray:
    """Parse an IDX file (MNIST format), gz or raw."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: str, candidates) -> Optional[str]:
    for c in candidates:
        p = os.path.join(root, c)
        if os.path.exists(p):
            return p
    return None


def _load_mnist_family(root: str, name: str, train: bool, image_size: int):
    sub = {"mnist": "MNIST", "fashion_mnist": "FashionMNIST"}[name]
    split = "train" if train else "t10k"
    img_path = lab_path = None
    for b in (os.path.join(root, sub, "raw"), os.path.join(root, sub), root):
        img_path = img_path or _find(
            b, [f"{split}-images-idx3-ubyte", f"{split}-images-idx3-ubyte.gz"]
        )
        lab_path = lab_path or _find(
            b, [f"{split}-labels-idx1-ubyte", f"{split}-labels-idx1-ubyte.gz"]
        )
    if img_path is None or lab_path is None:
        raise FileNotFoundError(
            f"{name} raw files not found under {root} (need {split}-images-idx3-ubyte[.gz])"
        )
    imgs = _load_idx(img_path)[:, :, :, None]  # [N,28,28,1]
    labels = _load_idx(lab_path).astype(np.int32)
    x = _normalize(imgs)
    if image_size != imgs.shape[1]:
        x = _resize_bilinear(x, image_size)
    return ArrayDataset(x, labels)


def _load_cifar10(root: str, train: bool, image_size: int):
    """CIFAR10 from the extracted cifar-10-batches-py/ directory or the
    python tarball."""
    d = os.path.join(root, "cifar-10-batches-py")
    batches = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]

    def read_batch(fobj):
        raw = pickle.load(fobj, encoding="bytes")
        data = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return data, np.asarray(raw[b"labels"], np.int32)

    parts = []
    if os.path.isdir(d):
        for b in batches:
            with open(os.path.join(d, b), "rb") as f:
                parts.append(read_batch(f))
    else:
        tar = _find(root, ["cifar-10-python.tar.gz", "cifar-10-python.tar"])
        if tar is None:
            raise FileNotFoundError(f"cifar10 not found under {root}")
        with tarfile.open(tar) as tf:
            for b in batches:
                parts.append(read_batch(tf.extractfile(f"cifar-10-batches-py/{b}")))
    x = _normalize(np.concatenate([p[0] for p in parts]))
    if image_size != 32:
        x = _resize_bilinear(x, image_size)
    return ArrayDataset(x, np.concatenate([p[1] for p in parts]))


def _load_celeba(root: str, train: bool, image_size: int):
    """CelebA from celeba/img_align_celeba/ + list_eval_partition.txt (0 =
    train, 1 = val, the reference's split choice); without the partition
    file every image serves both splits."""
    img_dir = os.path.join(root, "celeba", "img_align_celeba")
    part_file = os.path.join(root, "celeba", "list_eval_partition.txt")
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(f"celeba images not found at {img_dir}")
    from PIL import Image

    want = 0 if train else 1
    if os.path.exists(part_file):
        with open(part_file) as f:
            names = [
                parts[0]
                for parts in (ln.split() for ln in f)
                if len(parts) >= 2 and int(parts[1]) == want
            ]
    else:
        exts = (".jpg", ".jpeg", ".png")
        names = sorted(
            n for n in os.listdir(img_dir)
            if n.lower().endswith(exts) and os.path.isfile(os.path.join(img_dir, n))
        )
    out = np.empty((len(names), image_size, image_size, 3), np.float32)
    for i, n in enumerate(names):
        im = Image.open(os.path.join(img_dir, n)).convert("RGB").resize(
            (image_size, image_size), Image.BILINEAR
        )
        out[i] = (np.asarray(im, np.float32) / 255.0 - 0.5) / 0.5
    return ArrayDataset(out, np.zeros((len(names),), np.int32))


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


def get_dataset(
    name: str,
    root: str = "./data",
    train: bool = True,
    image_size: Optional[int] = None,
    **synthetic_kwargs,
):
    """Load a dataset by name -> (ArrayDataset, metadata dict): 'mnist',
    'fashion_mnist', 'cifar10', 'celeba', or the 'synthetic' family (whose
    validation split, train=False, draws from seed 1 unless a seed is
    given). Raises FileNotFoundError (never downloads) when raw files are
    absent and ValueError for an unknown name."""
    name = name.lower()
    meta = get_metadata(name if not name.startswith("synthetic") else "cifar10")
    size = image_size or meta["image_size"]
    if name.startswith("synthetic"):
        if "seed" not in synthetic_kwargs and not train:
            synthetic_kwargs = dict(synthetic_kwargs, seed=1)
        ds = synthetic_dataset(image_size=size, **synthetic_kwargs)
        meta = dict(meta, name=name, num_channels=ds.images.shape[-1], image_size=size)
        return ds, meta
    if name in ("mnist", "fashion_mnist"):
        return _load_mnist_family(root, name, train, size), meta
    if name == "cifar10":
        return _load_cifar10(root, train, size), meta
    if name == "celeba":
        return _load_celeba(root, train, size), meta
    raise ValueError(f"unknown dataset {name!r}")
