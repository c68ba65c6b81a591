"""`cli.sample --cpu` end to end, and the image grid it writes: the PNG is
decoded here with zlib alone and must hold the samples' denormalized,
clipped 8-bit tiles in a row-major grid (exactly), and the saved arrays
the samples the sampler gives for the same seed (exactly)."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu_torch.cli import sample as sample_cli
from convolutional_diffusion_tpu_torch.cli.common import load_model
from convolutional_diffusion_tpu_torch.sampling import sample
from convolutional_diffusion_tpu_torch.utils.visualize import denormalize, save_image_grid

PICKLE = "tests/goldens/pickles/backbone_resnet_cond.pt"


def decode_png(path):
    """8-bit gray or RGB PNG, filter type 0 on every row -> [H, W(, 3)]."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and color in (0, 2) and b"IEND" in chunks
    ch = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * ch)
    assert (raw[:, 0] == 0).all()
    px = raw[:, 1:].reshape(h, w, ch)
    return px if ch == 3 else px[..., 0]


def expected_grid(x, ncols, gray_reversed=False):
    v = np.clip(denormalize(x, 0.5, 0.5), 0, 1)
    if gray_reversed:
        v = 1.0 - v
    n, h, w, c = v.shape
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    grid = np.full((nrows * h, ncols * w, c), 255, np.uint8)
    for i in range(n):
        r, col = divmod(i, ncols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = np.round(v[i] * 255)
    return grid if c == 3 else grid[..., 0]


@pytest.mark.parametrize("extra,nsamples", [([], 10), (["--ddpm", "--label", "4"], 3)])
def test_sample_cli_cpu_end_to_end(tmp_path, extra, nsamples):
    out_png = tmp_path / "grid.png"
    arrays = tmp_path / "arrays"
    out = sample_cli.main(["--modelfile", PICKLE, "--conditional", "--cpu", "--nsteps", "4",
                           "--nsamples", str(nsamples), "--out", str(out_png),
                           "--save_arrays", str(arrays), "--seed", "3", *extra])
    assert out.shape == (nsamples, 16, 16, 3) and np.isfinite(out).all()
    assert np.abs(out).max() <= 1.0  # --clip by default
    saved = np.concatenate([np.load(arrays / f"{i:04d}.npy") for i in range(nsamples)])
    np.testing.assert_array_equal(saved, out)
    assert len(os.listdir(arrays)) == nsamples
    px = decode_png(out_png)
    assert px.shape == (16 * -(-nsamples // 8), 16 * min(8, nsamples), 3)
    np.testing.assert_array_equal(px, expected_grid(out, 8))
    # the same draws through the sampler: labels first, then the seeds
    model = load_model(PICKLE, device="cpu")
    g = torch.Generator().manual_seed(3)
    if "--label" in extra:
        label = torch.full((nsamples,), 4)
    else:
        label = torch.randint(0, 10, (nsamples,), generator=g)
    again = sample(model, batch_size=nsamples, nsteps=4, label=label, generator=g,
                   ddpm="--ddpm" in extra, device="cpu")
    np.testing.assert_array_equal(np.clip(again.numpy(), -1, 1), out)


def test_sample_cli_refuses_several_devices(tmp_path):
    """--ndevices 2 outside a group starts one rank per card: more ranks
    than visible cards (none here) is refused, naming their count."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible: --ndevices 2 runs")
    with pytest.raises(ValueError, match=f"{torch.cuda.device_count()} visible"):
        sample_cli.main(["--modelfile", PICKLE, "--ndevices", "2",
                         "--out", str(tmp_path / "g.png")])


def test_gray_grid_is_drawn_as_gray_r(tmp_path):
    x = np.random.RandomState(0).uniform(-1.2, 1.2, (5, 4, 6, 1)).astype(np.float32)
    save_image_grid(x, str(tmp_path / "g.png"), ncols=2)
    px = decode_png(tmp_path / "g.png")
    assert px.shape == (12, 12)
    np.testing.assert_array_equal(px, expected_grid(x, 2, gray_reversed=True))
