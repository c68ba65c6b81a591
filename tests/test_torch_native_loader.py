"""The port's binding of the native C++ loader (`native/loader.cpp`), built by
the port into `build/native_loader/`, on the CPU. Mirrors the JAX package's
`tests/test_native_loader.py` (build, IDX and CIFAR parsing, normalisation,
shuffling determinism, a bad path) and `tests/test_training_native.py`
(`train_diffusion` from the loader: from arrays, and from IDX files with no
dataset); adds that the port's batches are the JAX binding's bit for bit
for the same arrays and seed, that the build writes nothing under
`native/`, and the pinned device path's CPU fallback."""

import os
import struct

import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu_torch import models as tmodels
from convolutional_diffusion_tpu_torch import training as ttraining
from convolutional_diffusion_tpu_torch.utils import native_loader

pytestmark = pytest.mark.skipif(
    not native_loader.is_available(), reason="native loader not buildable (no C++ compiler)"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _expect(u8):
    return (u8.astype(np.float32) / np.float32(255.0) - np.float32(0.5)) / np.float32(0.5)


def test_memory_loader_normalization_and_shuffle():
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, size=(40, 8, 8, 3), dtype=np.uint8)
    labels = np.arange(40, dtype=np.int32)
    ld = native_loader.NativeLoader.from_arrays(images, labels, batch_size=16, seed=7)
    assert ld.num_samples == 40 and ld.shape == (8, 8, 3)
    xb, yb = ld.next()
    assert xb.shape == (16, 8, 8, 3) and yb.shape == (16,)
    # x = (u8 / 255 - 0.5) / 0.5, the labels naming the images, bit for bit
    np.testing.assert_array_equal(xb, _expect(images[yb]))
    seen = list(yb) + list(ld.next()[1])  # one epoch: without replacement
    assert len(set(seen)) == 32
    ld.close()


def test_seed_determinism():
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, size=(32, 4, 4, 1), dtype=np.uint8)
    labels = np.arange(32, dtype=np.int32)
    loaders = [native_loader.NativeLoader.from_arrays(images, labels, batch_size=8, seed=s)
               for s in (5, 5, 6)]
    ya, yb, yc = (np.concatenate([ld.next()[1] for _ in range(4)]) for ld in loaders)
    np.testing.assert_array_equal(ya, yb)
    assert not np.array_equal(ya, yc)
    for ld in loaders:
        ld.close()


def test_batches_equal_the_jax_bindings():
    """The same C++ source, arrays and seed: the same batches, bit for bit,
    across an epoch boundary."""
    from convolutional_diffusion_tpu.utils import native_loader as jnative

    if not jnative.is_available():
        pytest.skip("the JAX binding's library is not built")
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, size=(50, 6, 6, 3), dtype=np.uint8)
    labels = rs.randint(0, 10, size=(50,)).astype(np.int32)
    ours = native_loader.NativeLoader.from_arrays(images, labels, batch_size=16, seed=11)
    theirs = jnative.NativeLoader.from_arrays(images, labels, batch_size=16, seed=11)
    for _ in range(6):
        (xa, ya), (xb, yb) = ours.next(), theirs.next()
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    ours.close()
    theirs.close()


def test_idx_files(tmp_path):
    rs = np.random.RandomState(2)
    images = rs.randint(0, 256, size=(10, 6, 6), dtype=np.uint8)
    labels = rs.permutation(10).astype(np.uint8)  # unique: they name the images
    img_path, lab_path = tmp_path / "train-images-idx3-ubyte", tmp_path / "train-labels-idx1-ubyte"
    img_path.write_bytes(struct.pack(">IIII", 0x803, 10, 6, 6) + images.tobytes())
    lab_path.write_bytes(struct.pack(">II", 0x801, 10) + labels.tobytes())
    ld = native_loader.NativeLoader.from_idx(str(img_path), str(lab_path), batch_size=10)
    assert ld.num_samples == 10 and ld.shape == (6, 6, 1)
    xb, yb = ld.next()
    assert sorted(yb) == sorted(labels.astype(np.int32))
    order = {int(lab): i for i, lab in enumerate(labels)}
    np.testing.assert_array_equal(xb, _expect(images[[order[int(y)] for y in yb]])[..., None])
    ld.close()


def test_cifar_bin(tmp_path):
    rs = np.random.RandomState(3)
    n = 7
    chw = rs.randint(0, 256, size=(n, 3, 32, 32), dtype=np.uint8)
    labs = rs.permutation(10)[:n].astype(np.uint8)  # unique labels
    p = tmp_path / "data_batch_1.bin"
    p.write_bytes(b"".join(bytes([labs[i]]) + chw[i].tobytes() for i in range(n)))
    ld = native_loader.NativeLoader.from_cifar_bins([str(p)], batch_size=7, seed=0)
    assert ld.num_samples == 7 and ld.shape == (32, 32, 3)
    xb, yb = ld.next()
    order = {int(lab): i for i, lab in enumerate(labs)}
    for j in range(7):  # CHW records become HWC
        np.testing.assert_array_equal(xb[j], _expect(chw[order[int(yb[j])]].transpose(1, 2, 0)))
    ld.close()


def test_bad_path_raises():
    with pytest.raises(RuntimeError):
        native_loader.NativeLoader.from_idx("/nope/img", "/nope/lab", batch_size=4)


def test_builds_into_its_own_directory_and_never_into_native(tmp_path, monkeypatch):
    native_dir = os.path.join(REPO, "native")

    def listing():
        return {name: os.stat(os.path.join(native_dir, name)).st_mtime_ns
                for name in os.listdir(native_dir)}

    before = listing()
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "native_loader")
    built = native_loader.build()  # a fresh build
    assert built.seconds > 0 and built.path.parent == tmp_path / "native_loader"
    assert built.path.name.startswith("libcdtpu_loader_") and built.path.exists()
    assert native_loader.build() == (built.path, 0.0)  # reused
    assert listing() == before
    default = native_loader._target()
    assert default.parent == tmp_path / "native_loader"


def test_next_device_on_the_cpu():
    images = np.random.RandomState(5).randint(0, 256, size=(20, 4, 4, 3), dtype=np.uint8)
    ld = native_loader.NativeLoader.from_arrays(images, np.arange(20), batch_size=8, seed=1)
    xb, yb = ld.next_device("cpu")
    assert xb.dtype == torch.float32 and yb.dtype == torch.int64 and xb.shape == (8, 4, 4, 3)
    np.testing.assert_array_equal(xb.numpy(), _expect(images[yb.numpy()]))
    ld.close()


def _tiny_model(channels=1, size=8):
    net = tmodels.MinimalResNet(channels=channels, emb_dim=16, num_layers=1, mode="zeros")
    return tmodels.DiffusionModel(net, in_channels=channels, default_imsize=size, device="cpu")


def test_train_with_native_loader(tiny_dataset, monkeypatch):
    images, labels = tiny_dataset
    taken = []
    real = native_loader.NativeLoader.next_device
    monkeypatch.setattr(native_loader.NativeLoader, "next_device",
                        lambda self, dev: taken.append(1) or real(self, dev))
    config = ttraining.TrainConfig(epochs=15, batch_size=8, lr=3e-3, log_every=1)
    _, history = ttraining.train_diffusion(_tiny_model(), (images, labels), config,
                                           use_native_loader=True, log_fn=lambda s: None)
    assert len(taken) == 15 * 2
    assert np.isfinite(history).all()
    assert history[-1] < history[0]


def test_file_backed_idx_training(tmp_path):
    """Out of core: train from NativeLoader.from_idx on raw IDX files, with no
    dataset (native/loader.cpp parses, shuffles, normalises, prefetches)."""
    rs = np.random.RandomState(7)
    n, h, w = 24, 8, 8
    imgs = rs.randint(0, 256, size=(n, h, w), dtype=np.uint8)
    labs = rs.randint(0, 4, size=(n,)).astype(np.uint8)
    ip, lp = tmp_path / "train-images-idx3-ubyte", tmp_path / "train-labels-idx1-ubyte"
    ip.write_bytes(struct.pack(">IIII", 0x803, n, h, w) + imgs.tobytes())
    lp.write_bytes(struct.pack(">II", 0x801, n) + labs.tobytes())
    loader = native_loader.NativeLoader.from_idx(str(ip), str(lp), batch_size=8, seed=3)
    assert loader.num_samples == n and loader.shape == (h, w, 1)
    _, history = ttraining.train_diffusion(
        _tiny_model(), None, ttraining.TrainConfig(epochs=2, batch_size=8, max_t=10,
                                                   log_every=1),
        native_loader=loader, log_fn=lambda s: None)
    assert len(history) == 2 and np.isfinite(history[-1])
    loader.close()
