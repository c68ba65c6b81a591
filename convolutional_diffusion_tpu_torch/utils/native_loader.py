"""ctypes binding of the native C++ data loader (`native/loader.cpp`).

Counterpart of `convolutional_diffusion_tpu/utils/native_loader.py`, with
its API: `is_available()`, and `NativeLoader` (`from_idx`,
`from_cifar_bins`, `from_arrays`, `next`, `close`, `shape`,
`num_samples`): shuffled, normalised, prefetched host batches with no Python
in the per-batch path.

The library builds at first use from the checkout's `native/loader.cpp`
with the system C++ compiler (`$CXX`, else `c++` or `g++`) and the flags of
`native/Makefile`, into `build/native_loader/` at the root of the checkout
(git-ignored), under a name that carries a hash of the source and the flags,
as `ops/_build.py` builds the kernels. `native/` is only read: no `make`,
no file written there. `is_available()` is the feature gate.

`NativeLoader.next_device(device)` hands batches to the card: the C++ call
writes into one of SLOTS pinned host buffers in turn, and the buffer goes
to the device with `non_blocking=True`; a CUDA event per buffer makes the
next write into it wait until its last copy has finished.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "loader.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native_loader"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]  # native/Makefile's
SLOTS = 2  # pinned host buffers per loader, used in turn by next_device

_lib = None


class Built(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an existing build was reused


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (set CXX) to build native/loader.cpp")


def _target() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcdtpu_loader_{digest}.so"


def build() -> Built:
    """Compile `native/loader.cpp` unless an identical build exists."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found: the loader builds from the checkout")
    out = _target()
    if out.exists():
        return Built(out, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"could not build the native loader:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return Built(out, time.perf_counter() - t0)


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build().path))
    lib.cdtpu_loader_open_idx.restype = ctypes.c_void_p
    lib.cdtpu_loader_open_idx.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.cdtpu_loader_open_cifar.restype = ctypes.c_void_p
    lib.cdtpu_loader_open_cifar.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.cdtpu_loader_open_memory.restype = ctypes.c_void_p
    lib.cdtpu_loader_open_memory.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.cdtpu_loader_num_samples.restype = ctypes.c_int64
    lib.cdtpu_loader_num_samples.argtypes = [ctypes.c_void_p]
    lib.cdtpu_loader_shape.restype = ctypes.c_int
    lib.cdtpu_loader_shape.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.cdtpu_loader_next.restype = ctypes.c_int
    lib.cdtpu_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.cdtpu_loader_close.restype = None
    lib.cdtpu_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def is_available() -> bool:
    """Whether the library builds and loads here (the feature gate)."""
    try:
        _load_lib()
        return True
    except (RuntimeError, OSError):
        return False


class NativeLoader:
    """Prefetched shuffled batch iterator backed by the C++ runtime."""

    def __init__(self, handle, batch_size: int, drop_last: bool = True):
        if not handle:
            raise RuntimeError("native loader failed to open dataset")
        self._h = handle
        self._lib = _load_lib()
        self.batch_size = batch_size
        hh, ww, cc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._lib.cdtpu_loader_shape(self._h, hh, ww, cc)
        self.shape = (hh.value, ww.value, cc.value)
        self.num_samples = int(self._lib.cdtpu_loader_num_samples(self._h))
        self._slots = None  # (images, labels, events) pinned, by next_device
        self._slot = 0
        if drop_last and self.num_samples < batch_size:
            # the C++ loop would serve short batches forever, against
            # drop_last's fixed batch shape
            self.close()
            raise ValueError(
                f"dataset of {self.num_samples} samples is smaller than "
                f"batch_size={batch_size} with drop_last=True"
            )

    @classmethod
    def from_idx(cls, images_path: str, labels_path: str, *, batch_size: int = 128,
                 seed: int = 0, drop_last: bool = True) -> "NativeLoader":
        """MNIST-style IDX image and label files."""
        h = _load_lib().cdtpu_loader_open_idx(
            images_path.encode(), labels_path.encode(), batch_size, seed, int(drop_last))
        return cls(h, batch_size, drop_last)

    @classmethod
    def from_cifar_bins(cls, paths, *, batch_size: int = 128, seed: int = 0,
                        drop_last: bool = True) -> "NativeLoader":
        """CIFAR-10 binary batch files (label byte + 3x32x32 CHW each)."""
        h = _load_lib().cdtpu_loader_open_cifar(
            ";".join(paths).encode(), batch_size, seed, int(drop_last))
        return cls(h, batch_size, drop_last)

    @classmethod
    def from_arrays(cls, images_u8: np.ndarray, labels: np.ndarray, *,
                    batch_size: int = 128, seed: int = 0,
                    drop_last: bool = True) -> "NativeLoader":
        """images_u8: [n, h, w, c] uint8 (raw pixels, not normalised); the C++
        side copies them."""
        images_u8 = np.ascontiguousarray(images_u8, np.uint8)
        labels = np.ascontiguousarray(labels, np.int32)
        n, h, w, c = images_u8.shape
        handle = _load_lib().cdtpu_loader_open_memory(
            images_u8.ctypes.data, labels.ctypes.data, n, h, w, c, batch_size, seed,
            int(drop_last))
        return cls(handle, batch_size, drop_last)

    def _next_into(self, images_ptr: int, labels_ptr: int) -> int:
        return self._lib.cdtpu_loader_next(self._h, images_ptr, labels_ptr)

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        """Next prefetched batch: float32 [b, h, w, c] in [-1, 1], int32 [b]."""
        h, w, c = self.shape
        images = np.empty((self.batch_size, h, w, c), np.float32)
        labels = np.empty((self.batch_size,), np.int32)
        got = self._next_into(images.ctypes.data, labels.ctypes.data)
        return images[:got], labels[:got]

    def next_device(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Next batch as tensors on `device`: float32 [b, h, w, c] and int64
        [b]. On a card the batch goes through the pinned buffers in turn (see
        the module docstring) and its copy is queued on the current stream;
        on the CPU it is `next()` as tensors."""
        device = torch.device(device)
        if device.type != "cuda":
            images, labels = self.next()
            return torch.from_numpy(images), torch.from_numpy(labels).long()
        if self._slots is None:
            h, w, c = self.shape
            self._slots = [
                (torch.empty((self.batch_size, h, w, c), dtype=torch.float32,
                             pin_memory=True),
                 torch.empty((self.batch_size,), dtype=torch.int32, pin_memory=True),
                 None)
                for _ in range(SLOTS)
            ]
        images, labels, copied = self._slots[self._slot]
        if copied is not None:
            copied.synchronize()  # the buffer's last copy has read it
        got = self._next_into(images.data_ptr(), labels.data_ptr())
        out = (images[:got].to(device, non_blocking=True),
               labels[:got].to(device, non_blocking=True).long())
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(device))
        self._slots[self._slot] = (images, labels, copied)
        self._slot = (self._slot + 1) % SLOTS
        return out

    def close(self):
        if self._h:
            self._lib.cdtpu_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
