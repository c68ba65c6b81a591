"""Port vs JAX: online-softmax state and the reference's per-image weights.

Tolerances: `image_weights` is counts and one float32 division on both
sides — bit-equal. The softmax updates are float32 exp/sum/einsum in
another library: rtol 1e-5, atol 1e-6 (the sums hold < 100 terms of O(1))."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutional_diffusion_tpu.scores.common as jc
import convolutional_diffusion_tpu_torch.scores.common as tc

RTOL, ATOL = 1e-5, 1e-6


def _close(ours, want):
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def _state_inputs(S, P, dv, seed):
    rs = np.random.default_rng(seed)
    logits = rs.normal(scale=3.0, size=(*S, P)).astype(np.float32)
    w = rs.uniform(0, 1, size=(*S, P)).astype(np.float32)
    w[w < 0.25] = 0.0
    return logits, w


@pytest.mark.parametrize("values_shape", ["shared", "per_row", "per_query"])
def test_update_state_matches_jax(values_shape):
    S, P, dv = (2, 3, 5), 11, 3
    logits, w = _state_inputs(S, P, dv, seed=1)
    rs = np.random.default_rng(2)
    lead = {"shared": (), "per_row": S[:1], "per_query": S}[values_shape]
    values = rs.normal(size=(*lead, P, dv)).astype(np.float32)
    ts = tc.init_state(S, dv)
    js = jc.init_state(S, dv)
    for step in range(2):  # two folds: the second rescales a live state
        lg = logits + step
        ts = tc.update_state(ts, torch.from_numpy(lg), torch.from_numpy(w),
                             torch.from_numpy(values))
        js = jc.update_state(js, jnp.asarray(lg), jnp.asarray(w), jnp.asarray(values))
    _close(ts, js)


def test_update_state_without_values_and_all_excluded_rows():
    S, P = (4,), 6
    logits, w = _state_inputs(S, P, 1, seed=3)
    w[1] = 0.0  # one row sees only excluded entries: stays empty
    ts = tc.update_state(tc.init_state(S, 2), torch.from_numpy(logits), torch.from_numpy(w))
    js = jc.update_state(jc.init_state(S, 2), jnp.asarray(logits), jnp.asarray(w))
    _close(ts, js)
    assert torch.isneginf(ts.m[1]) and ts.s1[1] == 0


def test_merge_states_matches_jax_and_one_pass():
    S, P, dv = (5,), 16, 3
    logits, w = _state_inputs(S, P, dv, seed=4)
    values = np.random.default_rng(5).normal(size=(P, dv)).astype(np.float32)
    halves = []
    for lo, hi in ((0, 8), (8, 16)):
        halves.append(tc.update_state(
            tc.init_state(S, dv), torch.from_numpy(logits[:, lo:hi]),
            torch.from_numpy(w[:, lo:hi]), torch.from_numpy(values[lo:hi])))
    merged = tc.merge_states(*halves)
    whole = jc.update_state(jc.init_state(S, dv), jnp.asarray(logits),
                            jnp.asarray(w), jnp.asarray(values))
    _close(merged, whole)
    jhalves = [jc.SoftmaxState(*(jnp.asarray(a.numpy()) for a in h)) for h in halves]
    _close(merged, jc.merge_states(*jhalves))


CASES = list(itertools.product(
    list(tc.CutoffRule), list(tc.Weighting), [None, 4, 5, 11], [None, 1],
    [False, True],
))


@pytest.mark.parametrize(
    "cutoff,weighting,max_samples,label,shuffled", CASES,
    ids=[f"{c.value}-{w.value}-max{m}-lab{lab}-{'perm' if s else 'id'}"
         for c, w, m, lab, s in CASES],
)
def test_image_weights_bit_equal(cutoff, weighting, max_samples, label, shuffled):
    rs = np.random.RandomState(7)
    labels = rs.randint(0, 3, size=(12,)).astype(np.int32)
    order = rs.permutation(12) if shuffled else None
    kw = dict(batch_size=5, max_samples=max_samples, per_image_bank=36)
    ours = tc.image_weights(
        torch.from_numpy(labels.astype(np.int64)), label,
        cutoff=cutoff, weighting=weighting,
        order=None if order is None else torch.from_numpy(order), **kw,
    )
    want = jc.image_weights(
        jnp.asarray(labels), None if label is None else jnp.int32(label),
        cutoff=jc.CutoffRule(cutoff.value), weighting=jc.Weighting(weighting.value),
        order=None if order is None else jnp.asarray(order), **kw,
    )
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
