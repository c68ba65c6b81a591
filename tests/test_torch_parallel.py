"""Port vs JAX: the dataset-sharded score modules (`parallel.sharded_score`)
over two gloo ranks on the CPU, mirroring `tests/test_parallel.py` with its
data (48 images of 8x8x3).

One worker pair (`tests/torch_multihost_worker.py`, suite `parallel`)
computes every case once, in a module-scoped fixture; each test holds its
case against the JAX sharded module on the 8-device CPU mesh and the JAX
single-device module at JAX's own tolerances (rtol 2e-4, atol 1e-5), and
against the port's one-process module within 1e-6 relative to scale
(max|a-b| / max(|a|,|b|,1)): a sharded sweep reorders the sums of two
partial states, nothing else."""

import os

import numpy as np
import pytest
import torch

import torch_multihost_worker as W
from convolutional_diffusion_tpu.parallel import mesh as jmesh
from convolutional_diffusion_tpu.parallel import sharded_score as jps
from convolutional_diffusion_tpu.schedules import cosine_noise_schedule as jcosine
from convolutional_diffusion_tpu import scores as jscores
from convolutional_diffusion_tpu_torch.cli.common import build_score_module
from convolutional_diffusion_tpu_torch.parallel import make_mesh
from convolutional_diffusion_tpu_torch.parallel import mesh as pm
from convolutional_diffusion_tpu_torch.parallel import sharded_score as ps
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch import scores as tscores

PORT_TOL = 1e-6
JAX = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.run_pair("parallel", str(tmp_path_factory.mktemp("parallel")))


@pytest.fixture(scope="module")
def data():
    return W.parallel_data()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1.0)


def _both_ranks(ranks, key):
    """The two ranks' results of a case, which must be the same."""
    a, b = ranks[0][key], ranks[1][key]
    for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    return a


def _hold(got, port, jax_single, jax_sharded):
    assert _rel(got, port) <= PORT_TOL
    np.testing.assert_allclose(np.asarray(got), np.asarray(jax_single), **JAX)
    np.testing.assert_allclose(np.asarray(got), np.asarray(jax_sharded), **JAX)


def _jax_pair(single_cls, sharded_cls, dataset, **kw):
    return (single_cls(dataset, **kw),
            sharded_cls(dataset, mesh=jmesh.make_mesh(8), **kw))


def _port(cls, dataset, **kw):
    return cls(dataset, device="cpu", **kw)


def test_sharded_els_matches_single_device(ranks, data):
    images, labels, x = data
    got = _both_ranks(ranks, "els")
    kw = dict(kernel_size=3, batch_size=12)
    js, jsh = _jax_pair(jscores.LocalEquivScoreModule, jps.ShardedLocalEquivScoreModule,
                        (images, labels), schedule=jcosine, **kw)
    port = _port(tscores.LocalEquivScoreModule, (images, labels),
                 schedule=cosine_noise_schedule, **kw)
    assert ranks[0]["shard_rows"] == ranks[1]["shard_rows"] == 24
    for t, g in zip((0.3, 0.7), got):
        _hold(g, port(t, x), js(t, x), jsh(t, x))


def test_sharded_els_label_and_max_samples(ranks, data):
    images, labels, x = data
    (got,) = _both_ranks(ranks, "els_label")
    kw = dict(kernel_size=3, batch_size=10, max_samples=30)
    js, jsh = _jax_pair(jscores.LocalEquivScoreModule, jps.ShardedLocalEquivScoreModule,
                        (images, labels), schedule=jcosine, **kw)
    port = _port(tscores.LocalEquivScoreModule, (images, labels),
                 schedule=cosine_noise_schedule, **kw)
    _hold(got, port(0.5, x, label=1), js(0.5, x, label=1), jsh(0.5, x, label=1))


def test_sharded_bbels_matches_single_device(ranks, data):
    """The center region and the three border families merge across the
    ranks; at k = 9 >= the image height the sharded LS fallback runs."""
    images, labels, x = data
    got = _both_ranks(ranks, "bbels") + _both_ranks(ranks, "bbels_fallback")
    kw = dict(kernel_size=3, batch_size=12)
    js, jsh = _jax_pair(jscores.LocalEquivBordersScoreModule,
                        jps.ShardedLocalEquivBordersScoreModule, (images, labels),
                        schedule=jcosine, **kw)
    port = _port(tscores.LocalEquivBordersScoreModule, (images, labels),
                 schedule=cosine_noise_schedule, **kw)
    for t, g in zip((0.35, 0.8), got):
        _hold(g, port(t, x), js(t, x), jsh(t, x))
    order = np.arange(48)
    _hold(got[2], port(0.5, x, k=9, order=order), js(0.5, x, k=9, order=order),
          jsh(0.5, x, k=9, order=order))


def test_merge_collective_equals_sequential(ranks):
    """Two ranks' merges of 4 partial states each, merged across the ranks,
    equal the sequential merge of all 8 (the JAX package's `merge_states`
    over the same states, and the port's)."""
    from convolutional_diffusion_tpu.scores.common import SoftmaxState as JState
    from convolutional_diffusion_tpu.scores.common import merge_states as jmerge

    (m, s1, s2), _ = W.merge_inputs()
    acc = JState(m[0].numpy(), s1[0].numpy(), s2[0].numpy())
    tacc = tscores.SoftmaxState(m[0], s1[0], s2[0])
    for i in range(1, 8):
        acc = jmerge(acc, JState(m[i].numpy(), s1[i].numpy(), s2[i].numpy()))
        tacc = tscores.merge_states(tacc, tscores.SoftmaxState(m[i], s1[i], s2[i]))
    mg, s1g, s2g = _both_ranks(ranks, "merge")
    np.testing.assert_allclose(mg.numpy(), np.asarray(acc.m), rtol=1e-6)
    mean = (s2g / s1g[:, None]).numpy()
    np.testing.assert_allclose(mean, np.asarray(acc.s2 / acc.s1[:, None]), rtol=1e-5)
    np.testing.assert_allclose(mean, (tacc.s2 / tacc.s1[:, None]).numpy(), rtol=1e-6)


def test_merge_collective_with_an_all_excluded_shard(ranks):
    """Rank 1's shard weighs 0 everywhere (m = -inf): the merge is rank 0's
    state, exactly; entries empty on both ranks stay (-inf, 0, 0), no NaN."""
    _, (m, s1, s2) = W.merge_inputs()
    mg, s1g, s2g = _both_ranks(ranks, "merge_excluded")
    assert not any(torch.isnan(a).any() for a in (mg, s1g, s2g))
    np.testing.assert_array_equal(mg.numpy(), m[0].numpy())
    np.testing.assert_array_equal(s1g.numpy(), s1[0].numpy())
    np.testing.assert_array_equal(s2g.numpy(), s2[0].numpy())
    assert torch.isneginf(mg[4:]).all() and (s1g[4:] == 0).all() and (s2g[4:] == 0).all()


def test_shard_dataset_placement(ranks, data):
    """Each rank holds its contiguous span; padded to whole chunks (5 here:
    48 -> 2 x 25) with zero images and label -1; numpy or tensors alike."""
    images, labels, _ = data
    for r in range(2):
        si, sl = ranks[r]["shard_dataset"]
        np.testing.assert_array_equal(si, images[24 * r:24 * (r + 1)])
        np.testing.assert_array_equal(sl, labels[24 * r:24 * (r + 1)])
        ci, cl = ranks[r]["shard_dataset_chunk5"]
        ti, tl = ranks[r]["shard_dataset_tensor"]
        assert ci.shape == (25, 8, 8, 3) and cl.shape == (25,)
        np.testing.assert_array_equal(ti.numpy(), ci)
        np.testing.assert_array_equal(tl.numpy(), cl)
    np.testing.assert_array_equal(ranks[0]["shard_dataset_chunk5"][0], images[:25])
    np.testing.assert_array_equal(ranks[1]["shard_dataset_chunk5"][0][:23], images[25:])
    assert not ranks[1]["shard_dataset_chunk5"][0][23:].any()
    assert (ranks[1]["shard_dataset_chunk5"][1][23:] == -1).all()


def test_sharded_els_rejects_vector_label(ranks):
    for r in range(2):
        assert ranks[r]["supports_vector_label"] is False
        assert "scalar label" in ranks[r]["vector_label"]


def test_sharded_is_matches_single_device(ranks, data):
    images, labels, x = data
    got = _both_ranks(ranks, "is")
    kw = dict(batch_size=10, max_samples=30)
    js, jsh = _jax_pair(jscores.IdealScoreModule, jps.ShardedIdealScoreModule,
                        (images, labels), schedule=jcosine, **kw)
    port = _port(tscores.IdealScoreModule, (images, labels),
                 schedule=cosine_noise_schedule, **kw)
    for (t, lab), g in zip(((0.3, None), (0.6, 1)), got):
        _hold(g, port(t, x, label=lab), js(t, x, label=lab), jsh(t, x, label=lab))


def test_sharded_ls_matches_single_device(ranks, data):
    images, labels, x = data
    (got,) = _both_ranks(ranks, "ls")
    order = np.random.RandomState(7).permutation(48)
    kw = dict(kernel_size=3, batch_size=10, max_samples=25)
    js, jsh = _jax_pair(jscores.LocalScoreModule, jps.ShardedLocalScoreModule,
                        (images, labels), schedule=jcosine, **kw)
    port = _port(tscores.LocalScoreModule, (images, labels),
                 schedule=cosine_noise_schedule, **kw)
    _hold(got, port(0.4, x, order=order), js(0.4, x, order=order),
          jsh(0.4, x, order=order))


def test_build_score_module_mesh_routing(ranks, data):
    """build_score_module(mesh=) returns the sharded class of every kind,
    on the mesh's device, equal to the one-device factory's module."""
    from convolutional_diffusion_tpu.cli.common import build_score_module as jbuild

    images, labels, x = data
    order = np.arange(48)
    for kind in ("IS", "LS", "ELS", "bbELS"):
        name, dev, got = ranks[0]["routing"][kind]
        assert name == "Sharded" + type(build_score_module(
            kind, (images, labels), batch_size=12, image_size=8, channels=3,
            schedule=cosine_noise_schedule, device="cpu")).__name__, kind
        assert dev == "cpu" and ranks[1]["routing"][kind][0] == name
        np.testing.assert_array_equal(got.numpy(), ranks[1]["routing"][kind][2].numpy())
        kw = dict(batch_size=12, image_size=8, channels=3)
        port = build_score_module(kind, (images, labels), schedule=cosine_noise_schedule,
                                  device="cpu", **kw)
        js = jbuild(kind, (images, labels), schedule=jcosine, **kw)
        jsh = jbuild(kind, (images, labels), schedule=jcosine, mesh=jmesh.make_mesh(8), **kw)
        _hold(got, port(0.5, x, order=order), js(0.5, x, order=order),
              jsh(0.5, x, order=order))


def test_sharded_els_large_d_regime(ranks):
    """k = 27 (d = 2187) on 48x48 images: sharded == single. Here |m| and
    ||q||^2 / (2 beta^2) reach ~5e3, where float32 rounds a state's m by
    ~3e-4, and that moves the posterior mean wherever two partial states
    meet (a merge, or a sweep carried into the next chunk) by ~1e-5 of
    scale: one process sweeping its 12 images as one chunk or as two
    chunks of 6 differs by 6.9e-6. So the two ranks are held within twice
    that own distance (not 1e-6) of both; and to JAX at the port's rule,
    2e-4 relative to scale (`tests/test_torch_els.py`), which the one-process
    module meets here (2.6e-5) and JAX's rtol 2e-4 / atol 1e-5 does not."""
    images, labels, x = W.large_d_data()
    got = _both_ranks(ranks, "large_d")
    kw = dict(kernel_size=27, batch_size=4)
    js, jsh = _jax_pair(jscores.LocalEquivScoreModule, jps.ShardedLocalEquivScoreModule,
                        (images, labels), schedule=jcosine, **kw)
    one = _port(tscores.LocalEquivScoreModule, (images, labels),
                schedule=cosine_noise_schedule, **kw)(0.5, x)
    two = _port(tscores.LocalEquivScoreModule, (images, labels),
                schedule=cosine_noise_schedule, target_block=6 * 22 * 22, **kw)(0.5, x)
    own = _rel(one, two)
    assert PORT_TOL < own < 1e-4
    assert _rel(got, one) <= 2 * own and _rel(got, two) <= 2 * own
    for ref in (np.asarray(js(0.5, x)), np.asarray(jsh(0.5, x))):
        assert _rel(got, ref) <= 2e-4 and _rel(one, ref) <= 2e-4


def test_one_merge_per_call(ranks):
    """An ELS call merges with two all-reduces (MAX of m, SUM of s1 and s2)
    of M = 2 x 64 query rows: 4 M bytes, then 4 (M + 3 M) bytes."""
    per_call = ranks[0]["collectives_per_call"]
    M = 2 * 8 * 8
    assert per_call["all_reduce"] == 2
    assert per_call["all_reduce_bytes"] == 4 * M + 4 * (M + 3 * M)
    assert per_call["all_gather"] == per_call["broadcast"] == 0


@pytest.mark.parametrize("kind", ["ELS", "bbELS", "IS", "LS"])
def test_world_of_one_is_bit_equal(data, kind):
    """A mesh of one outside any group: every sharded kind equals the
    one-device module bit for bit (the merge of one state is exact)."""
    images, labels, x = data
    mesh = make_mesh(1, device="cpu")
    assert mesh.shape == {"data": 1} and mesh.group() is None
    kw = dict(batch_size=12, image_size=8, channels=3, schedule=cosine_noise_schedule)
    one = build_score_module(kind, (images, labels), device="cpu", **kw)
    sharded = build_score_module(kind, (images, labels), mesh=mesh, **kw)
    assert type(sharded).__name__.startswith("Sharded")
    order = np.arange(48)
    for t in (0.3, 0.8):
        np.testing.assert_array_equal(sharded(t, x, order=order).numpy(),
                                      one(t, x, order=order).numpy())


def test_shard_span_pads_to_whole_chunks():
    """JAX pads the set to n_ranks * chunk images; the spans are equal and
    contiguous, and the last may be all padding."""
    mesh = pm.Mesh({"data": 4}, {"data": 0}, {"data": None}, torch.device("cpu"))
    spans = []
    for r in range(4):
        mesh.coords = {"data": r}
        spans.append(ps.shard_span(10, mesh, chunk=2))
    assert spans == [ps.Shard(0, 4, 4), ps.Shard(4, 8, 4), ps.Shard(8, 10, 4),
                     ps.Shard(10, 10, 4)]
    assert ps.shard_span(48, pm.make_mesh(1, device="cpu")) == ps.Shard(0, 48, 48)
    assert not os.environ.get("WORLD_SIZE")  # the suite runs outside any group
