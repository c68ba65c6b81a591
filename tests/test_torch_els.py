"""Port vs JAX and vs the torch-reference goldens: the ELS score module, in
bank mode and in streaming mode (bank_budget_bytes=0), on the CPU.

Tolerances: goldens are held at the JAX tests' own atol 2e-4 relative to
scale; the port vs the JAX module at 2e-4 relative to scale (both are fp32;
the port sums in base 2 with folded biases, the JAX CPU path in base e)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.scores as jscores
import convolutional_diffusion_tpu_torch.scores.els as tels
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcos
from convolutional_diffusion_tpu_torch.scores import LocalEquivScoreModule
from convolutional_diffusion_tpu_torch.scores.bank import bank_geometry, build_bank
from convolutional_diffusion_tpu_torch.scores.common import (
    CutoffRule, Weighting, image_weights,
)

MODES = {"bank": {}, "stream": {"bank_budget_bytes": 0}}


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


@pytest.fixture(scope="module")
def z():
    return np.load("tests/goldens/scores.npz")


@pytest.fixture(scope="module")
def zc():
    return np.load("tests/goldens/cutoffs.npz")


def _data(z):
    return _nhwc(z["imgs"]), z["labs"].astype(np.int32), _nhwc(z["x"]), float(z["t"][0])


def _check(ours, expect, atol=2e-4):
    scale = max(np.nanmax(np.abs(expect)), 1.0)
    np.testing.assert_allclose(ours.numpy(), expect, atol=atol * scale)


def _port(imgs, labs, mode, **kw):
    return LocalEquivScoreModule((imgs, labs), device="cpu", **MODES[mode], **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("key,kw,call", [
    ("els/k3b5", dict(kernel_size=3, batch_size=5), {}),
    ("els/k3b12", dict(kernel_size=3, batch_size=12), {}),
    ("els/k5b5", dict(kernel_size=5, batch_size=5), {}),
    ("els/k5b12", dict(kernel_size=3, batch_size=12), dict(k=5)),
    ("els/k3label2", dict(kernel_size=3, batch_size=5), dict(label=2)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_scores_goldens(z, mode, key, kw, call):
    imgs, labs, x, t = _data(z)
    mod = _port(imgs, labs, mode, **kw)
    _check(mod(t, x, **call), _nhwc(z[f"{key}/out"]))


@pytest.mark.parametrize("mode", MODES)
def test_batched_x_golden(z, mode):
    imgs, labs, _, t = _data(z)
    mod = _port(imgs, labs, mode, kernel_size=3, batch_size=5)
    _check(mod(t, _nhwc(z["x2"])), _nhwc(z["els/k3b5x2/out"]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [13, 19])
def test_large_k_goldens(z, mode, k):
    imgs, labs = _nhwc(z["bigk/imgs24"]), z["bigk/labs24"].astype(np.int32)
    x = _nhwc(z["bigk/x24"])[:1]
    mod = _port(imgs, labs, mode, kernel_size=k, batch_size=5)
    _check(mod(float(z["t"][0]), x), _nhwc(z[f"bigk/els_k{k}/out"]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("max_samples,label,tag", [
    (8, None, "max8"), (10, None, "max10"), (11, None, "max11"), (6, 1, "label1max6"),
])
def test_cutoff_goldens(zc, mode, max_samples, label, tag):
    imgs, labs, x, t = _data(zc)
    mod = _port(imgs, labs, mode, kernel_size=3, batch_size=5, max_samples=max_samples)
    _check(mod(t, x, label=label), _nhwc(zc[f"els/{tag}/out"]))


@pytest.mark.parametrize("mode", MODES)
def test_shuffled_stream_golden(zc, mode):
    imgs, labs, x, t = _data(zc)
    mod = _port(imgs, labs, mode, kernel_size=3, batch_size=5, max_samples=8)
    _check(mod(t, x, order=zc["els/max8shuf/perm"]), _nhwc(zc["els/max8shuf/out"]))


def _x(b, seed=5):
    return np.random.RandomState(seed).normal(size=(b, 8, 8, 1)).astype(np.float32)


JAX_CASES = {
    "plain": (dict(), dict()),
    "label": (dict(), dict(label=2)),
    "max_samples": (dict(max_samples=9), dict()),
    "order": (dict(max_samples=10), dict(order=np.random.RandomState(3).permutation(16))),
    "vector_label": (dict(max_samples=15), dict(label=np.array([0, 2, 1, 0], np.int32))),
    "vector_label_order": (dict(max_samples=10), dict(
        label=np.array([1, 3, 1, 2], np.int32),
        order=np.random.RandomState(4).permutation(16))),
    "k5": (dict(), dict(k=5)),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", JAX_CASES)
def test_matches_jax_module(tiny_dataset, mode, case):
    imgs, labs = tiny_dataset
    ctor, call = JAX_CASES[case]
    x = _x(4)
    kw = dict(kernel_size=3, batch_size=5, **ctor)
    jmod = jscores.LocalEquivScoreModule(
        (imgs, labs), schedule=jcos, **kw,
        **({"bank_budget_bytes": 0} if mode == "stream" else {}),
    )
    for t in (0.05, 0.5, 0.95):
        want = np.asarray(jmod(t, jnp.asarray(x), **call))
        ours = _port(imgs, labs, mode, **kw)(t, x, **call)
        _check(ours, want)


@pytest.mark.parametrize("mode", MODES)
def test_vector_label_equals_scalar_calls(tiny_dataset, mode):
    """A label vector (one per-seed sweep) equals one scalar-label call per
    seed, bit for bit: query rows are independent."""
    imgs, labs = tiny_dataset
    mod = _port(imgs, labs, mode, kernel_size=3, batch_size=5, max_samples=10)
    x = _x(4)
    vec = np.array([3, 1, 1, 0], np.int32)
    got = mod(0.3, x, label=vec)
    rows = torch.cat([mod(0.3, x[i : i + 1], label=int(vec[i])) for i in range(4)])
    torch.testing.assert_close(got, rows, rtol=0, atol=0)


def test_shuffle_generator_deterministic_and_fresh(tiny_dataset):
    imgs, labs = tiny_dataset
    kw = dict(kernel_size=3, batch_size=5, max_samples=8, shuffle=True)
    a = _port(imgs, labs, "bank", generator=torch.Generator().manual_seed(4), **kw)
    b = _port(imgs, labs, "bank", generator=torch.Generator().manual_seed(4), **kw)
    x = _x(1)
    o1, o2, r1 = a(0.4, x), a(0.4, x), b(0.4, x)
    torch.testing.assert_close(o1, r1, rtol=0, atol=0)
    assert not torch.allclose(o1, o2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["plain", "label", "k5", "vector_label"])
def test_high_matches_jax_module_interpret(tiny_dataset, monkeypatch, mode, case):
    """'high': the port's plain bf16x3 sweep against the JAX module driving
    its Pallas kernel in interpret mode (use_pallas=True; without it the
    JAX module on the CPU takes its fp32 jnp path). A label vector is one
    per-seed sweep in the port; the JAX module runs the kernel per seed
    (vmap) in bank mode and groups seeds by label when streaming."""
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    imgs, labs = tiny_dataset
    ctor, call = JAX_CASES[case]
    x = _x(len(call["label"]) if np.ndim(call.get("label")) else 2)
    kw = dict(kernel_size=3, batch_size=5, precision="high", **ctor)
    jmod = jscores.LocalEquivScoreModule(
        (imgs, labs), schedule=jcos, use_pallas=True, **kw,
        **({"bank_budget_bytes": 0} if mode == "stream" else {}),
    )
    ours = _port(imgs, labs, mode, **kw)
    for t in (0.05, 0.5):
        _check(ours(t, x, **call), np.asarray(jmod(t, jnp.asarray(x), **call)))


def _sweep_inputs(tiny_dataset, k=3):
    imgs, labs = tiny_dataset
    images = torch.from_numpy(imgs)
    g = bank_geometry(16, 8, 8, 1, k, 100)  # 2 images per chunk, 8 chunks
    w = image_weights(torch.from_numpy(labs.astype(np.int64)), None, batch_size=5,
                      max_samples=None, cutoff=CutoffRule.UNFILTERED,
                      weighting=Weighting.MEAN, per_image_bank=g.per_img)
    from convolutional_diffusion_tpu_torch.ops.patches import extract_patches, pad_image

    xq = extract_patches(pad_image(torch.from_numpy(_x(2)), 1, "circular"), k)
    xq = xq.reshape(-1, g.d)
    return images, w, xq, (xq * xq).sum(-1), g


def test_els_sweep_state0_chaining(tiny_dataset):
    images, w, xq, qn, g = _sweep_inputs(tiny_dataset)
    at, bt = torch.tensor(0.8), torch.tensor(0.6)
    whole = tels.els_sweep(images, w, xq, qn, at, bt, k=3, cs=g.cs)
    j = 3 * g.cs
    head = tels.els_sweep(images[:j], w[:j], xq, qn, at, bt, k=3, cs=g.cs)
    chained = tels.els_sweep(images[j:], w[j:], xq, qn, at, bt, k=3, cs=g.cs, state0=head)
    for a, b in zip(whole, chained):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_banked_sweep_equals_streaming_and_chains(tiny_dataset):
    images, w, xq, qn, g = _sweep_inputs(tiny_dataset)
    at, bt = torch.tensor(0.7), torch.tensor(0.5)
    bank = build_bank(images, 3, 100)
    banked = tels.banked_sweep(xq, qn, bank, w, at, bt, per_img=g.per_img)
    streamed = tels.els_sweep(images, w, xq, qn, at, bt, k=3, cs=g.cs)
    for a, b in zip(banked, streamed):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    j = 5 * g.cs
    head = tels.banked_sweep(xq, qn, bank._replace(**{f: getattr(bank, f)[:5] for f in bank._fields}),
                             w[:j], at, bt, per_img=g.per_img)
    tail = tels.banked_sweep(xq, qn, bank._replace(**{f: getattr(bank, f)[5:] for f in bank._fields}),
                             w[j:], at, bt, per_img=g.per_img, state0=head)
    for a, b in zip(banked, tail):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_argument_errors(tiny_dataset):
    imgs, labs = tiny_dataset
    mod = _port(imgs, labs, "bank")
    with pytest.raises(ValueError, match="odd"):
        mod(0.5, _x(1), k=4)
    with pytest.raises(ValueError, match="precision"):
        _port(imgs, labs, "bank", precision="bf16")
    out = _port(imgs, labs, "bank", precision="default")(0.5, _x(1))
    assert out.shape == (1, 8, 8, 1) and torch.isfinite(out).all()
    assert jax.default_backend() == "cpu"  # the JAX reference stays on the CPU


@pytest.mark.parametrize("mode", MODES)
def test_vector_label_is_one_per_seed_sweep_per_chunk(tiny_dataset, monkeypatch, mode):
    """A [b] label vector is one sweep per bank chunk with [b, B] weights
    and rows_per_seed = h * w, banked and streamed: never one call per
    label."""
    imgs, labs = tiny_dataset
    calls = []

    def spy(*args, **kw):
        calls.append((tuple(args[5].shape), kw.get("rows_per_seed")))
        return flash_score_update(*args, **kw)

    from convolutional_diffusion_tpu_torch.ops.flash_score import flash_score_update

    monkeypatch.setattr(tels, "flash_score_update", spy)
    mod = _port(imgs, labs, mode, kernel_size=3, batch_size=5, target_block=100)
    mod(0.3, _x(4), label=np.array([3, 1, 1, 0], np.int32))
    g = bank_geometry(16, 8, 8, 1, 3, 100)
    assert calls == [((4, g.block), 64)] * g.nblk
    with pytest.raises(ValueError, match="one label per seed"):
        mod(0.3, _x(4), label=np.array([3, 1], np.int32))


# 'default' (K3/K4): the port's plain bf16-exp sweep against the JAX module
# driving its Pallas kernel in interpret mode. The c = 1 tiny set at k = 3
# (d = 9) takes 'inbank' on both sides; the RGB set at k = 7 (d = 147,
# padded 256) takes 'vpu'. Tolerance 2e-3 relative to scale, half the
# tier's 4e-3: the JAX kernel re-bases its running max every block_p >= 512
# bank rows where the port re-bases every 128, and XLA's CPU backend drops
# the bf16 rounding of 'vpu's products; worst observed ~4e-4.
DEFAULT_CASES = {
    "plain": (dict(), dict()),
    "label": (dict(), dict(label=2)),
    "vector_label": (dict(max_samples=15), dict(label=np.array([0, 2, 1, 0], np.int32))),
    "rgb_k7": (dict(kernel_size=7), dict()),
    "rgb_k7_vector_label": (dict(kernel_size=7), dict(label=np.array([3, 0], np.int32))),
}


def _rgb_set():
    from convolutional_diffusion_tpu_torch.data import synthetic_dataset

    ds = synthetic_dataset(num_samples=12, image_size=12, num_channels=3,
                           num_classes=4, seed=2)
    return ds.images, ds.labels


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", DEFAULT_CASES)
def test_default_matches_jax_module_interpret(tiny_dataset, monkeypatch, mode, case):
    monkeypatch.setenv("CDT_FLASH_INTERPRET", "1")
    imgs, labs = _rgb_set() if case.startswith("rgb") else tiny_dataset
    ctor, call = DEFAULT_CASES[case]
    b = len(call["label"]) if np.ndim(call.get("label")) else 2
    x = np.random.RandomState(5).normal(size=(b, *imgs.shape[1:])).astype(np.float32)
    kw = dict(kernel_size=3, batch_size=5, precision="default")
    kw.update(ctor)
    jmod = jscores.LocalEquivScoreModule(
        (imgs, labs), schedule=jcos, use_pallas=True, **kw,
        **({"bank_budget_bytes": 0} if mode == "stream" else {}),
    )
    ours = _port(imgs, labs, mode, **kw)
    for t in (0.05, 0.5):
        _check(ours(t, x, **call), np.asarray(jmod(t, jnp.asarray(x), **call)),
               atol=2e-3)


@pytest.mark.parametrize("mode", MODES)
def test_default_value_strategy_rule(tiny_dataset, monkeypatch, mode):
    """At 'default' the sweeps take 'inbank' over the bank's center columns
    where d padded to 128 is at most 128 (values not passed) and the
    'auto' rule elsewhere, banked and streamed, with 1-D and per-seed
    weights; the other tiers never take 'inbank'."""
    from convolutional_diffusion_tpu_torch.ops.flash_score import flash_score_update

    calls = []

    def spy(*args, **kw):
        calls.append((args[4] is None, kw.get("v_strategy", "auto"),
                      kw.get("inbank_cols")))
        return flash_score_update(*args, **kw)

    monkeypatch.setattr(tels, "flash_score_update", spy)
    imgs, labs = tiny_dataset
    mod = _port(imgs, labs, mode, kernel_size=3, batch_size=5, precision="default")
    mod(0.3, _x(2))
    mod(0.3, _x(2), label=np.array([1, 2], np.int32))
    assert set(calls) == {(True, "inbank", (4, 1))}
    calls.clear()
    rgb, rlabs = _rgb_set()
    x = np.zeros((1, 12, 12, 3), np.float32)
    _port(rgb, rlabs, mode, kernel_size=5, precision="default")(0.3, x)
    assert set(calls) == {(True, "inbank", (36, 3))}  # d 75
    calls.clear()
    _port(rgb, rlabs, mode, kernel_size=7, precision="default")(0.3, x)
    _port(imgs, labs, mode, kernel_size=3, precision="high")(0.3, _x(1))
    assert set(calls) == {(False, "auto", None)}  # d 147; 'high'
    assert tels._inbank_max_dp("default") == 128
    assert tels._inbank_max_dp("high") == tels._inbank_max_dp("highest") == 0


@pytest.mark.parametrize("call", [
    dict(), dict(label=1), dict(label=np.array([3, 1], np.int32)),
    dict(label=np.array([0, 2], np.int32), order=np.random.RandomState(7).permutation(16)),
], ids=["plain", "label", "vector_label", "vector_label_order"])
def test_clustered_bank_sweeps_like_the_plain_bank(tiny_dataset, call):
    """A clustered bank (`prune=True`) sweeps with each row's weight taken
    through its image index: the pruned module equals the plain-bank and the
    streamed module to fp32 summation order, with scalar labels (masked
    sweeps), label vectors (per-seed weights gathered per seed, unmasked)
    and a shuffled order (which changes only which weight each image
    gets)."""
    imgs, labs = tiny_dataset
    kw = dict(kernel_size=3, batch_size=5, target_block=100)
    x = _x(2)
    clustered = _port(imgs, labs, "bank", prune=True, **kw)
    out = clustered(0.2, x, **call)
    assert torch.isfinite(out).all()
    from convolutional_diffusion_tpu_torch.scores.bank import ClusteredBank

    assert isinstance(clustered._bank_cache[3], ClusteredBank)
    for mode in MODES:
        _check(out, _port(imgs, labs, mode, **kw)(0.2, x, **call).numpy())
