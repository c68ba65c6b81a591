"""Denormalization and image grids.

Counterpart of `denormalize`, `denormalize_imshow` and `save_image_grid` in
`convolutional_diffusion_tpu/utils/visualize.py`, NHWC. The JAX package
draws its grid with matplotlib; this one writes the PNG with the standard
library (`zlib`, `struct`), so it needs neither matplotlib nor PIL: the same
denormalized, clipped tiles in the same row-major grid of `ncols` columns,
one pixel per pixel, with no gaps, empty cells white. Gray images are drawn
as the JAX grid's ``gray_r`` colormap draws them: 0 white, 1 black. Only
`denormalize_imshow` needs matplotlib, which it imports when called.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["denormalize", "denormalize_imshow", "grid_pixels", "save_image_grid"]


def denormalize(image, means, stds):
    """Invert Normalize(mean, std): x * std + mean, per channel (last axis).
    Accepts [h, w, c] or [b, h, w, c]."""
    image = np.asarray(image)
    means = np.asarray(means, image.dtype)
    stds = np.asarray(stds, image.dtype)
    return image * stds + means


def denormalize_imshow(image, means, stds, show=True):
    """Denormalize and imshow the (first) image with matplotlib, imported
    here (the reference's idealscore.py:22-29)."""
    import matplotlib.pyplot as plt

    img = denormalize(image, means, stds)
    if img.ndim == 4:
        img = img[0]
    if img.shape[-1] == 1:
        img = img[..., 0]
    plt.imshow(np.clip(img, 0, 1), cmap="gray_r")
    plt.axis("off")
    if show:
        plt.show()


def grid_pixels(images, *, ncols: int = 8, means=0.5, stds=0.5) -> np.ndarray:
    """[b, h, w, c] samples -> the grid's 8-bit pixels: [H, W, 3] for RGB,
    [H, W] for gray (c = 1), with H = rows * h and W = ncols * w."""
    images = np.clip(denormalize(np.asarray(images, np.float32), means, stds), 0.0, 1.0)
    n, h, w, c = images.shape
    if c == 1:
        images = 1.0 - images  # gray_r
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    grid = np.ones((nrows * h, ncols * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    pixels = np.round(grid * 255.0).astype(np.uint8)
    return pixels[..., 0] if c == 1 else pixels


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(pixels: np.ndarray, path: str) -> str:
    """8-bit gray [H, W] or RGB [H, W, 3] pixels -> a PNG file."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    height, width = pixels.shape[:2]
    color = 0 if pixels.ndim == 2 else 2
    rows = pixels.reshape(height, -1)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(height))  # filter 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
    return path


def save_image_grid(images, path, *, ncols: int = 8, means=0.5, stds=0.5):
    """Save a grid of NHWC samples as one PNG (denormalized, clipped)."""
    return write_png(grid_pixels(images, ncols=ncols, means=means, stds=stds), path)
