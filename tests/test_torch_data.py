"""Port vs JAX: the dataset registry and parsers. Each parser reads tiny raw
files the test writes (IDX raw and gz, the CIFAR10 directory and tarball,
a CelebA directory) through both packages' `get_dataset`, which must agree.

Tolerances: exact where no resize runs (the same uint8 -> float32
normalization); 1e-5 where the bilinear resize runs: the port contracts the
same float32 weights in float32 matmuls, the JAX package in its CPU einsum,
which sits up to ~5e-6 from the float64 result at 28 -> 32."""

import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

from convolutional_diffusion_tpu import data as jdata
from convolutional_diffusion_tpu_torch import data as tdata


def _same(root, name, atol=0.0, **kw):
    ours, meta_o = tdata.get_dataset(name, root=str(root), **kw)
    want, meta_w = jdata.get_dataset(name, root=str(root), **kw)
    assert meta_o == meta_w
    assert ours.images.dtype == np.float32 and ours.labels.dtype == np.int32
    np.testing.assert_array_equal(ours.labels, want.labels)
    np.testing.assert_allclose(ours.images, np.asarray(want.images), rtol=0, atol=atol)
    return ours


def _write_idx(root, gz, split="train", sub="MNIST"):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, size=(6, 28, 28), dtype=np.uint8)
    labels = rs.randint(0, 10, size=(6,), dtype=np.uint8)
    raw = root / sub / "raw"
    raw.mkdir(parents=True)
    opener = gzip.open if gz else open
    ext = ".gz" if gz else ""
    with opener(raw / f"{split}-images-idx3-ubyte{ext}", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 6, 28, 28))
        f.write(images.tobytes())
    with opener(raw / f"{split}-labels-idx1-ubyte{ext}", "wb") as f:
        f.write(struct.pack(">II", 0x801, 6))
        f.write(labels.tobytes())
    return images, labels


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_idx_parser_matches_jax(tmp_path, gz):
    images, labels = _write_idx(tmp_path, gz)
    ds = _same(tmp_path, "mnist", atol=1e-5)  # resized 28 -> 32
    assert ds.images.shape == (6, 32, 32, 1)
    ds28 = _same(tmp_path, "mnist", image_size=28)
    np.testing.assert_array_equal(
        ds28.images[..., 0], (images.astype(np.float32) / 255 - 0.5) / 0.5)
    np.testing.assert_array_equal(ds28.labels, labels.astype(np.int32))


def test_fashion_mnist_test_split(tmp_path):
    _write_idx(tmp_path, gz=True, split="t10k", sub="FashionMNIST")
    _same(tmp_path, "fashion_mnist", atol=1e-5, train=False)


def _cifar_batches():
    rs = np.random.RandomState(1)
    return [{b"data": rs.randint(0, 256, size=(4, 3072), dtype=np.uint8),
             b"labels": list(rs.randint(0, 10, size=(4,)))} for _ in range(6)]


def test_cifar_dir_matches_jax(tmp_path):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    batches = _cifar_batches()
    for i, b in enumerate(batches[:5], 1):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump(b, f)
    with open(d / "test_batch", "wb") as f:
        pickle.dump(batches[5], f)
    ds = _same(tmp_path, "cifar10")
    assert ds.images.shape == (20, 32, 32, 3)
    chw = batches[0][b"data"][0].reshape(3, 32, 32)
    np.testing.assert_array_equal(
        ds.images[0], (chw.transpose(1, 2, 0).astype(np.float32) / 255 - 0.5) / 0.5)
    assert _same(tmp_path, "cifar10", train=False).images.shape == (4, 32, 32, 3)
    # downsampling: 32 -> 16 through the antialiased bilinear resize
    assert _same(tmp_path, "cifar10", atol=1e-5, image_size=16).images.shape == (20, 16, 16, 3)


def test_cifar_tarball_matches_jax(tmp_path):
    batches = _cifar_batches()
    with tarfile.open(tmp_path / "cifar-10-python.tar.gz", "w:gz") as tf:
        names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        for name, b in zip(names, batches):
            blob = pickle.dumps(b)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    assert _same(tmp_path, "cifar10").images.shape == (20, 32, 32, 3)
    assert _same(tmp_path, "cifar10", train=False).labels.shape == (4,)


def test_celeba_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img_dir = tmp_path / "celeba" / "img_align_celeba"
    img_dir.mkdir(parents=True)
    rs = np.random.RandomState(2)
    for i in range(4):
        Image.fromarray(rs.randint(0, 256, size=(40, 36, 3), dtype=np.uint8)).save(
            img_dir / f"{i:06d}.png")
    (tmp_path / "celeba" / "list_eval_partition.txt").write_text(
        "000000.png 0\n000001.png 1\n000002.png 0\n000003.png 2\n")
    assert _same(tmp_path, "celeba").images.shape == (2, 32, 32, 3)
    assert _same(tmp_path, "celeba", train=False).images.shape == (1, 32, 32, 3)


@pytest.mark.parametrize("shape,size", [((3, 28, 28, 2), 32), ((3, 32, 32, 3), 16),
                                        ((2, 32, 32, 1), 11), ((2, 8, 8, 3), 8)])
def test_resize_matches_jax(shape, size):
    x = np.random.RandomState(3).uniform(-1, 1, shape).astype(np.float32)
    np.testing.assert_allclose(tdata._resize_bilinear(x, size),
                               np.asarray(jdata._resize_bilinear(x, size)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["mnist", "MNIST", "fashion_mnist", "fashionmnist",
                                  "cifar10", "CIFAR10", "celeba", "something_else"])
def test_metadata_table(name):
    assert tdata.get_metadata(name) == jdata.get_metadata(name)
    assert tdata.get_metadata("cifar10")["train_images"] == 60000  # the reference's quirk


@pytest.mark.parametrize("kw", [dict(num_samples=8, num_channels=1),
                                dict(num_samples=5, image_size=16, train=False),
                                dict(num_samples=4, seed=3, train=False)])
def test_synthetic_via_get_dataset(kw):
    _same("unused", "synthetic", **kw)


def test_missing_and_unknown_raise(tmp_path):
    for name in ("mnist", "cifar10", "celeba"):
        with pytest.raises(FileNotFoundError):
            tdata.get_dataset(name, root=str(tmp_path))
    with pytest.raises(ValueError):
        tdata.get_dataset("not_a_dataset")
    assert not os.listdir(tmp_path)  # nothing downloaded or written
