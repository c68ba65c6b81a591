"""The bbELS border regions on their own chunking, on the CPU: the port's
bbELS score against the benchmark's plain reference
(`port_bench/reference/bbels.py`), on a square and an oblong image, and
the border chunk at one image against one chunk of all images.

Seeded random images 20 x 20 x 3, N = 7, two seeds, at 'highest' and
'high' (the plain route): at k = 13 (p = 6) the border classes hold 84% of
the pixels. The batch quota (batches of 2, max_samples 4) leaves the last
image out, so the weights are not all alike. The border regions are fp32
at every tier, so the chunking is compared at 'highest' alone.

Tolerances, relative to scale (max |a - b| / max(max |b|, 1)):
- against the reference: 1e-4, the benchmark's reference tests' `TOL`
  (float32 machines against float64 sums read ~1e-5 there);
- one chunking against another: 1e-5. The dots are the same fp32
  products; what moves is the online softmax's float32 rescaling at each
  chunk boundary (a 2^-24 rounding of exp(m_old - m_new) per merge) and
  the order of the value sums.
"""

import numpy as np
import pytest
import torch

from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import LocalEquivBordersScoreModule
from convolutional_diffusion_tpu_torch.scores import bbels
from port_bench.reference import bbels as ref_bbels

N, B, C = 7, 2, 3
REF_TOL = 1e-4  # port_bench/tests/test_port_bench_reference.py TOL
ORDER_TOL = 1e-5
MODES = {"highest": "fp32", "high": "bf16x3"}
CELEBA_SCALES = [3, 3, 3, 3, 3, 3, 3, 5, 5, 5, 5, 5, 7, 7, 9, 9, 9, 13, 19, 27]


def _bank(h=20, w=20, seed=0):
    g = np.random.RandomState(seed)
    images = g.uniform(-1, 1, (N, h, w, C)).astype(np.float32)
    labels = np.zeros(N, dtype=np.int64)
    x = g.normal(size=(B, h, w, C)).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(x)


def _module(images, labels, precision):
    return LocalEquivBordersScoreModule((images, labels), batch_size=2, max_samples=4,
                                        precision=precision, schedule=cosine_noise_schedule,
                                        device="cpu")


def _reference(t, x, k, images, labels, precision):
    cfg = dict(scorebatchsize=2, max_samples=4, border_dots="fp32")
    return torch.cat([ref_bbels.score(t, x[i : i + 1], k, images, labels, None, cfg,
                                      MODES[precision]) for i in range(x.shape[0])])


def _gap(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("k", [3, 7, 13])
@pytest.mark.parametrize("t", [0.1, 0.5, 0.9])
def test_score_matches_the_plain_reference(precision, k, t):
    images, labels, x = _bank()
    tt = torch.tensor(t, dtype=torch.float32)
    got = _module(images, labels, precision)(tt, x, k=k)
    assert _gap(got, _reference(tt, x, k, images, labels, precision)) < REF_TOL


@pytest.mark.parametrize("w", [20, 14])
@pytest.mark.parametrize("k", [3, 7, 13])
@pytest.mark.parametrize("t", [0.1, 0.9])
def test_one_image_a_chunk_equals_one_chunk(monkeypatch, w, k, t):
    images, labels, x = _bank(w=w)
    mod = _module(images, labels, "highest")
    monkeypatch.setattr(bbels, "BORDER_CHUNK_BYTES", 1 << 40)
    assert bbels._border_chunk(N, 20, w, C, k, B) == N
    whole = mod(torch.tensor(t), x, k=k)
    monkeypatch.setattr(bbels, "BORDER_CHUNK_BYTES", 1)
    assert bbels._border_chunk(N, 20, w, C, k, B) == 1
    calls = []
    update = bbels.update_state
    monkeypatch.setattr(bbels, "update_state", lambda *a: calls.append(1) or update(*a))
    single = mod(torch.tensor(t), x, k=k)
    assert len(calls) == 3 * N  # row bands, column bands, corners, once an image
    assert _gap(single, whole) < ORDER_TOL


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("k", [3, 7, 13])
def test_oblong_image_matches_the_plain_reference(precision, k):
    """h != w: row bands of w - 2p positions, column bands of h - 2p."""
    images, labels, x = _bank(h=20, w=14, seed=1)
    tt = torch.tensor(0.3, dtype=torch.float32)
    got = _module(images, labels, precision)(tt, x, k=k)
    assert _gap(got, _reference(tt, x, k, images, labels, precision)) < REF_TOL


def test_celeba64_call_runs_35_border_chunks():
    """The benchmark's 64 x 64 cell: 4 seeds over 1000 images, the 19 steps
    of the CelebA_UNet_zeros schedule, against 989 chunks when the border
    regions took the center bank's chunk."""
    chunks = [-(-1000 // bbels._border_chunk(1000, 64, 64, 3, k, 4)) for k in CELEBA_SCALES[1:]]
    assert sum(chunks) == 35 and max(chunks) == 12
