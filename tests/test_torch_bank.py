"""Port vs JAX: bank geometry, bank construction, the ledger, and the bank
carried across with `convert.bank_from_jax_numpy`.

Tolerances: geometry and patch values are exact (data movement); squared
norms are float32 sums in another order (rtol 1e-6)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.scores.bank as jb
import convolutional_diffusion_tpu_torch.scores.bank as tb
from convolutional_diffusion_tpu_torch import convert
from convolutional_diffusion_tpu_torch.scores import LocalEquivScoreModule

CIFAR10_SCALES = [3, 3, 3, 3, 5, 5, 5, 7, 7, 7, 7, 9, 9, 11, 11, 13, 15, 17, 17, 17]

GEOMETRIES = [
    (50000, 32, 32, 3, k, 65536) for k in sorted(set(CIFAR10_SCALES))
] + [
    (12, 8, 8, 3, 3, 65536), (12, 8, 8, 3, 5, 100), (7, 6, 6, 1, 3, 30),
    (3, 4, 4, 3, 5, 64), (60000, 32, 32, 1, 15, 65536),
]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
def test_geometry_and_nbytes_match_jax(geom):
    assert tuple(tb.bank_geometry(*geom)) == tuple(jb.bank_geometry(*geom))
    assert tb.bank_nbytes(*geom) == jb.bank_nbytes(*geom)


def test_main_path_launch_count():
    """Sweep launches of one 20-step CIFAR10 machine call = sum of nblk over
    the 19 steps it takes (i = 19 .. 1)."""
    def total(n):
        return sum(tb.bank_geometry(n, 32, 32, 3, CIFAR10_SCALES[i], 65536).nblk
                   for i in range(19, 0, -1))

    assert total(50000) == 8749
    assert total(10000) == 1760


@pytest.mark.parametrize("k,target_block,c", [(3, 65536, 3), (3, 100, 3), (5, 80, 1)])
def test_build_bank_matches_jax(k, target_block, c):
    rs = np.random.RandomState(k + c)
    imgs = rs.uniform(-1, 1, size=(11, 8, 8, c)).astype(np.float32)
    g = tb.bank_geometry(11, 8, 8, c, k, target_block)
    jbank = [np.asarray(a) for a in jb.build_bank(jnp.asarray(imgs), k, target_block)]
    carried = convert.bank_from_jax_numpy(*jbank, g, device="cpu")
    ours = tb.build_bank(torch.from_numpy(imgs), k, target_block)
    assert ours.bank.shape == (g.nblk, g.block, g.d)
    np.testing.assert_array_equal(ours.bank.numpy(), carried.bank.numpy())
    np.testing.assert_array_equal(ours.centers.numpy(), carried.centers.numpy())
    np.testing.assert_allclose(ours.pn.numpy(), carried.pn.numpy(), rtol=1e-6)
    # chunk-padding rows (if any) are zero
    pad_rows = g.nblk * g.block - 11 * g.per_img
    if pad_rows:
        assert not ours.bank[-1, -pad_rows:].any()


def test_bank_from_jax_numpy_checks_geometry():
    g = tb.bank_geometry(4, 6, 6, 3, 3, 65536)
    with pytest.raises(ValueError, match="geometry"):
        convert.bank_from_jax_numpy(
            np.zeros((g.nblk, g.block * g.d + 1)), np.zeros((g.nblk, g.block * 3)),
            np.zeros((g.nblk, g.block)), g, device="cpu")


def _module(imgs, labs, **kw):
    return LocalEquivScoreModule((imgs, labs), kernel_size=3, batch_size=4,
                                 device="cpu", **kw)


def test_ledger_cumulative_and_misses_not_cached(tiny_dataset):
    imgs, labs = tiny_dataset
    need3 = tb.bank_nbytes(16, 8, 8, 1, 3, 65536)
    need5 = tb.bank_nbytes(16, 8, 8, 1, 5, 65536)
    mod = _module(imgs, labs, bank_budget_bytes=need3 + need5 - 1)
    assert mod._bank(3) is not None
    assert mod._bank(5) is None  # over the cumulative budget
    assert 5 not in mod._bank_cache
    mod.bank_ledger.budget = need3 + need5
    assert mod._bank(5) is not None  # a later call may find budget
    assert mod.bank_ledger.used == need3 + need5


def test_misses_are_not_poisoned():
    """tests/test_scores.py's TestBankBudgetAccounting case: a miss is not
    cached, and `bank_budget_bytes` set after construction retunes the
    module's ledger (a property onto `bank_ledger.budget`, as in JAX)."""
    imgs = np.zeros((64, 32, 32, 3), np.float32)
    labs = np.zeros((64,), np.int32)
    mod = LocalEquivScoreModule((imgs, labs), batch_size=256, bank_budget_bytes=0,
                                device="cpu")
    assert mod._bank(3) is None
    assert 3 not in mod._bank_cache  # retried next call
    mod.bank_budget_bytes = 1 << 30
    assert mod.bank_ledger.budget == mod.bank_budget_bytes == 1 << 30
    assert mod._bank(3) is not None


def test_shared_ledger_and_release_on_failed_build(tiny_dataset, monkeypatch):
    imgs, labs = tiny_dataset
    need = tb.bank_nbytes(16, 8, 8, 1, 3, 65536)
    ledger = tb.BankLedger(need)
    a = _module(imgs, labs, bank_ledger=ledger)
    b = _module(imgs, labs, bank_ledger=ledger)
    assert a._bank(3) is not None and b._bank(3) is None

    def boom(*_a, **_k):
        raise MemoryError("simulated")

    c = _module(imgs, labs, bank_budget_bytes=need)
    monkeypatch.setattr(tb, "build_bank", boom)
    with pytest.raises(MemoryError):
        c._bank(3)
    assert c.bank_ledger.used == 0


def test_load_scales(tmp_path):
    js = tmp_path / "s.json"
    js.write_text(json.dumps(CIFAR10_SCALES))
    npy = tmp_path / "s.npy"
    np.save(npy, np.asarray(CIFAR10_SCALES))
    pt = tmp_path / "s.pt"
    torch.save(CIFAR10_SCALES, pt)  # the reference's scales_*.pt format
    assert convert.load_scales(str(js)) == CIFAR10_SCALES
    assert convert.load_scales(str(npy)) == CIFAR10_SCALES
    assert convert.load_scales(str(pt)) == CIFAR10_SCALES
    with pytest.raises(FileNotFoundError):
        convert.load_scales(str(tmp_path / "missing.pt"))


def test_clustered_bank_in_the_ledger(tiny_dataset, monkeypatch):
    """With prune, `_bank` reserves the bank's bytes plus its int32 image
    indices, caches a ClusteredBank, and releases the reservation when the
    clustered build fails; a budget that holds the plain bank but not the
    indices misses."""
    imgs, labs = tiny_dataset
    need = tb.bank_cache_nbytes(16, 8, 8, 1, 3, 65536, prune=True)
    g = tb.bank_geometry(16, 8, 8, 1, 3, 65536)
    assert need == tb.bank_nbytes(16, 8, 8, 1, 3, 65536) + g.nblk * g.block * 4
    assert _module(imgs, labs, prune=True, bank_budget_bytes=need - 1)._bank(3) is None
    mod = _module(imgs, labs, prune=True, bank_budget_bytes=need)
    bank = mod._bank(3)
    assert isinstance(bank, tb.ClusteredBank) and mod.bank_ledger.used == need
    assert bank.img_idx.dtype == torch.int32 and bank.img_idx.shape == (g.nblk, g.block)
    assert sorted(bank.img_idx.reshape(-1).tolist()) == sorted(
        i for i in range(16) for _ in range(g.per_img))

    def boom(*_a, **_k):
        raise MemoryError("simulated")

    monkeypatch.setattr(tb, "build_clustered_bank", boom)
    failed = _module(imgs, labs, prune=True, bank_budget_bytes=need)
    with pytest.raises(MemoryError):
        failed._bank(3)
    assert failed.bank_ledger.used == 0


def test_gather_patches_are_extract_patches(tiny_dataset):
    """A row gathered by (image, position) is that image's extracted patch;
    a padding image's row is zero."""
    from convolutional_diffusion_tpu_torch.ops.patches import extract_patches

    imgs = torch.from_numpy(tiny_dataset[0])
    k = 5
    want = extract_patches(imgs, k).reshape(16, -1, k * k)
    img = torch.tensor([0, 3, 15, 16, 7])
    pos = torch.tensor([0, 5, 15, 2, 11])
    got = tb.gather_patches(imgs, img, pos, k)
    for r in (0, 1, 2, 4):
        assert torch.equal(got[r], want[img[r], pos[r]])
    assert not got[3].any()
