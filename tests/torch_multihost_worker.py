"""Worker of the port's two-rank tests (not a test file; imports no JAX).

    python tests/torch_multihost_worker.py SUITE RANK WORLD STORE OUT [INPUTS] [DEVICE]

Each rank joins one gloo group through a file store (`init_distributed`),
builds a 'data' mesh on DEVICE (default cpu) and computes every case of
SUITE: `parallel` (the sharded score modules, `tests/test_torch_parallel.py`)
or `multihost` (data-parallel training, `sample_sharded` and the CLIs in a
group, `tests/test_torch_multihost.py`; INPUTS is the torch file of weights,
batches and draws the parent prepared, and holds the directories the CLIs
write to). Rank r writes its results to OUT.r with torch.save; the parent
compares them with JAX and with the port's one-process results.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from convolutional_diffusion_tpu_torch.parallel import mesh as pm  # noqa: E402
from convolutional_diffusion_tpu_torch.parallel import sharded_score as ps  # noqa: E402
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule  # noqa: E402


def parallel_data():
    """tests/test_parallel.py's data: 48 images of 8x8x3, 3 classes, 2 seeds."""
    rs = np.random.RandomState(0)
    images = rs.uniform(-1, 1, size=(48, 8, 8, 3)).astype(np.float32)
    labels = rs.randint(0, 3, size=(48,)).astype(np.int32)
    x = rs.normal(size=(2, 8, 8, 3)).astype(np.float32)
    return images, labels, x


def large_d_data():
    """tests/test_parallel.py's large-d case: k = 27 on 48x48x3."""
    rs = np.random.RandomState(7)
    images = rs.uniform(-1, 1, size=(12, 48, 48, 3)).astype(np.float32)
    labels = rs.randint(0, 2, size=(12,)).astype(np.int32)
    x = rs.normal(size=(1, 48, 48, 3)).astype(np.float32)
    return images, labels, x


def merge_inputs():
    """tests/test_parallel.py's 8 partial states (RandomState(1)), plus a
    pair with entries empty (-inf) on one rank or on both."""
    rs = np.random.RandomState(1)
    m = rs.normal(size=(8, 4)) * 5
    s1 = rs.uniform(0.5, 2, size=(8, 4))
    s2 = rs.normal(size=(8, 4, 2))
    em = rs.normal(size=(2, 6)) * 5
    es1 = rs.uniform(0.5, 2, size=(2, 6))
    es2 = rs.normal(size=(2, 6, 2))
    em[1, :] = -np.inf  # rank 1's shard weighs 0 everywhere but ...
    em[0, 4:] = -np.inf  # ... entries 4, 5 are empty on both ranks
    es1[em == -np.inf] = 0.0
    es2[em == -np.inf] = 0.0
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (f(m), f(s1), f(s2)), (f(em), f(es1), f(es2))


def suite_parallel(mesh, out):
    from convolutional_diffusion_tpu_torch.cli.common import build_score_module
    from convolutional_diffusion_tpu_torch.scores.common import SoftmaxState, merge_states

    images, labels, x = parallel_data()
    r = mesh.axis_rank()
    dev = mesh.device

    def run(mod, *calls):
        return [mod(t, x, **kw).cpu() for t, kw in calls]

    mod = ps.ShardedLocalEquivScoreModule((images, labels), mesh=mesh, kernel_size=3,
                                          batch_size=12, schedule=cosine_noise_schedule)
    out["shard_rows"] = mod.images.shape[0]
    pm.reset_collectives()
    out["els"] = run(mod, (0.3, {}), (0.7, {}))
    out["collectives_per_call"] = {k: v / 2 for k, v in pm.COLLECTIVES.items()}
    mod = ps.ShardedLocalEquivScoreModule((images, labels), mesh=mesh, kernel_size=3,
                                          batch_size=10, max_samples=30,
                                          schedule=cosine_noise_schedule)
    out["els_label"] = run(mod, (0.5, {"label": 1}))
    try:
        mod(0.5, x, label=np.array([0, 1]))
        out["vector_label"] = None
    except ValueError as e:
        out["vector_label"] = str(e)
    out["supports_vector_label"] = mod.supports_vector_label
    mod = ps.ShardedLocalEquivBordersScoreModule((images, labels), mesh=mesh, kernel_size=3,
                                                 batch_size=12,
                                                 schedule=cosine_noise_schedule)
    out["bbels"] = run(mod, (0.35, {}), (0.8, {}))
    # k >= the image height: the sharded LS fallback, its order pinned
    out["bbels_fallback"] = run(mod, (0.5, {"k": 9, "order": np.arange(48)}))
    mod = ps.ShardedIdealScoreModule((images, labels), mesh=mesh, batch_size=10,
                                     max_samples=30, schedule=cosine_noise_schedule)
    out["is"] = run(mod, (0.3, {}), (0.6, {"label": 1}))
    order = np.random.RandomState(7).permutation(48)
    mod = ps.ShardedLocalScoreModule((images, labels), mesh=mesh, kernel_size=3,
                                     batch_size=10, max_samples=25,
                                     schedule=cosine_noise_schedule)
    out["ls"] = run(mod, (0.4, {"order": order}))
    out["routing"] = {}
    for kind in ("IS", "LS", "ELS", "bbELS"):
        mod = build_score_module(kind, (images, labels), batch_size=12, image_size=8,
                                 channels=3, schedule=cosine_noise_schedule, mesh=mesh)
        out["routing"][kind] = (type(mod).__name__, mod.device.type,
                                mod(0.5, x, order=np.arange(48)).cpu())
    li, ll, lx = large_d_data()
    mod = ps.ShardedLocalEquivScoreModule((li, ll), mesh=mesh, kernel_size=27, batch_size=4,
                                          schedule=cosine_noise_schedule)
    out["large_d"] = mod(0.5, lx).cpu()

    # merge_collective: each rank folds its 4 of the 8 states sequentially,
    # then the two merge across the ranks
    (m, s1, s2), excluded = merge_inputs()
    acc = SoftmaxState(m[4 * r], s1[4 * r], s2[4 * r])
    for i in range(4 * r + 1, 4 * r + 4):
        acc = merge_states(acc, SoftmaxState(m[i], s1[i], s2[i]))
    out["merge"] = [a.cpu() for a in ps.merge_collective(*(a.to(dev) for a in acc))]
    out["merge_excluded"] = [a.cpu() for a in ps.merge_collective(
        *(a[r].to(dev) for a in excluded))]

    out["shard_dataset"] = [a.copy() for a in ps.shard_dataset(images, labels, mesh)]
    out["shard_dataset_chunk5"] = [a.copy() for a in ps.shard_dataset(images, labels, mesh,
                                                                       chunk=5)]
    ti, tl = ps.shard_dataset(torch.from_numpy(images), torch.from_numpy(labels), mesh,
                              chunk=5)
    out["shard_dataset_tensor"] = [ti, tl]


def _tiny_model(kind, dev, seed=0):
    from convolutional_diffusion_tpu_torch import models

    if kind == "bn":
        net = models.MinimalUNet(channels=1, fsizes=(8, 16), emb_dim=16, mode="zeros",
                                 normalization="BatchNorm")
    else:
        net = models.MinimalUNet(channels=1, fsizes=(8, 16), emb_dim=16, mode="zeros",
                                 conditional=True, num_classes=4)
    return models.DiffusionModel(net, in_channels=1, default_imsize=8, seed=seed, device=dev)


def train_data():
    rs = np.random.RandomState(5)
    return (rs.uniform(-1, 1, (16, 8, 8, 1)).astype(np.float32),
            rs.randint(0, 4, 16).astype(np.int64))


def suite_multihost(mesh, out, inp):
    from convolutional_diffusion_tpu_torch import models, training
    from convolutional_diffusion_tpu_torch import sampling
    from convolutional_diffusion_tpu_torch.utils import checkpoint

    r = mesh.axis_rank()
    dev = mesh.device
    out["world"] = torch.distributed.get_world_size()
    out["mesh_shape"] = dict(mesh.shape)
    out["mesh2_shape"] = dict(pm.make_mesh(2, ("data", "model"), device=dev).shape)

    # --- DP train steps against JAX's (the parent's) and one process's ---
    for name in ("dp_resnet", "dp_bn"):
        case = inp[name]
        net = (models.MinimalResNet if case["kind"] == "resnet" else models.MinimalUNet)(
            **case["cfg"])
        model = models.DiffusionModel(net, in_channels=1, default_imsize=8, device=dev)
        model.backbone.load_state_dict(case["sd"], strict=True)
        state = training.TrainState(model, training.TrainConfig(**case["config"]))
        trail, losses = [], []
        for (img, lab), (t, eps) in zip(case["batches"], case["draws"]):
            loss = training.step_with_noise(
                state, torch.from_numpy(img).to(dev), torch.from_numpy(lab).long().to(dev),
                torch.from_numpy(t).to(dev), torch.from_numpy(eps).to(dev),
                conditional=case["conditional"], mesh=mesh)
            losses.append(float(training.global_loss(loss, mesh)))
            trail.append({k: v.detach().cpu().clone()
                          for k, v in model.backbone.state_dict().items()})
        out[name] = {"losses": losses, "trail": trail}

    # --- sharded ELS across the process boundary (tests/test_multihost.py) ---
    rs = np.random.RandomState(11)
    rs.uniform(-1, 1, size=(8, 8, 8, 3))
    imgs = rs.uniform(-1, 1, size=(16, 8, 8, 3)).astype(np.float32)
    labs = rs.randint(0, 3, size=(16,)).astype(np.int32)
    x = rs.normal(size=(2, 8, 8, 3)).astype(np.float32)
    mod = ps.ShardedLocalEquivScoreModule((imgs, labs), mesh=mesh, kernel_size=3,
                                          batch_size=8, schedule=cosine_noise_schedule)
    out["sharded_els"] = mod(0.5, x).cpu()

    # --- train_diffusion(mesh=): a few steps, the ragged tail, checkpoints ---
    saves = []
    real_save = checkpoint.save_checkpoint

    def spy(*a, **kw):
        saves.append(kw.get("step"))
        return real_save(*a, **kw)

    checkpoint.save_checkpoint = spy
    images, labels = train_data()
    for kind in ("unet", "bn"):
        model = _tiny_model(kind, dev)
        cfg = training.TrainConfig(epochs=2, batch_size=4, lr=1e-3, log_every=1, seed=3)
        state, hist = training.train_diffusion(model, (images, labels), cfg, mesh=mesh,
                                               conditional=kind == "unet",
                                               log_fn=lambda s: None)
        out[f"train_{kind}"] = {"history": hist, "step": state.step,
                                "sd": {k: v.cpu() for k, v in
                                       model.backbone.state_dict().items()}}
    model = _tiny_model("unet", dev)
    cfg = training.TrainConfig(epochs=1, batch_size=4, lr=1e-3, log_every=1, seed=3,
                               drop_last=False)
    state, hist = training.train_diffusion(model, (images[:9], labels[:9]), cfg, mesh=mesh,
                                           conditional=True, log_fn=lambda s: None)
    out["train_ragged"] = {"history": hist, "step": state.step,
                           "sd": {k: v.cpu() for k, v in model.backbone.state_dict().items()}}
    ck = inp["checkpoint_dir"]
    cfg = dict(batch_size=4, lr=1e-3, seed=3, save_interval=1, log_every=1)
    whole, _ = training.train_diffusion(_tiny_model("bn", dev), (images, labels),
                                        training.TrainConfig(epochs=2, **cfg), mesh=mesh,
                                        log_fn=lambda s: None)
    training.train_diffusion(_tiny_model("bn", dev), (images, labels),
                             training.TrainConfig(epochs=1, **cfg), mesh=mesh,
                             checkpoint_dir=ck, log_fn=lambda s: None)
    resumed, _ = training.train_diffusion(_tiny_model("bn", dev, seed=1), (images, labels),
                                          training.TrainConfig(epochs=1, **cfg), mesh=mesh,
                                          resume_from=ck, log_fn=lambda s: None)
    a, b = resumed.model.backbone.state_dict(), whole.model.backbone.state_dict()
    out["resume_equal"] = all(torch.equal(a[k], b[k]) for k in a)
    out["resume_step"] = resumed.step
    out["saves"] = list(saves)
    checkpoint.save_checkpoint = real_save

    # --- sample_sharded: 4 seeds over the ranks ---
    model = _tiny_model("unet", dev, seed=2)
    label = torch.tensor([0, 3, 1, 2])
    for ddpm in (False, True):
        g = torch.Generator(device=dev).manual_seed(4)
        out[f"sample_ddpm{int(ddpm)}"] = sampling.sample_sharded(
            model, mesh, batch_size=4, nsteps=3, label=label, generator=g, ddpm=ddpm).cpu()

    # --- the CLIs in the group (the torchrun path), rank 0 writing ---
    from convolutional_diffusion_tpu_torch import pipeline
    from convolutional_diffusion_tpu_torch.cli import els, sample, train
    from convolutional_diffusion_tpu_torch.utils import visualize

    writes = {"save_array": 0, "save_image_grid": 0, "save_checkpoint": 0}

    def counted(mod_, name):
        real = getattr(mod_, name)

        def f(*a, **kw):
            writes[name] += 1
            return real(*a, **kw)

        setattr(mod_, name, f)

    counted(pipeline, "save_array")
    counted(visualize, "save_image_grid")
    counted(checkpoint, "save_checkpoint")
    cli = inp["cli"]
    out["cli_els"] = els.main(cli["els"] + ["--ndevices", "2"])
    out["cli_sample"] = sample.main(cli["sample"] + ["--ndevices", "2"])
    out["cli_train_step"] = train.main(cli["train"] + ["--ndevices", "2"]).step
    out["writes"] = writes
    try:  # in a group of 2, --ndevices must say 2
        els.main(cli["els"] + ["--ndevices", "3"])
        out["cli_mismatch"] = None
    except ValueError as e:
        out["cli_mismatch"] = str(e)
    out["rank"] = r


def run_pair(suite, tmp, inputs=None, device="cpu", timeout=600):
    """Start the two ranks of SUITE (this file, one process each) with a
    file store under `tmp`; wait for both and return their result dicts.
    A rank that fails or outlives `timeout` seconds fails the caller."""
    import subprocess

    store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    args = [suite, None, "2", store, out, inputs or "-", device]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *[str(r) if a is None else a for a in args]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rcs = [p.returncode for p in procs]
    if rcs != [0, 0]:
        raise RuntimeError(f"ranks exited {rcs}\n--- rank 0 ---\n{logs[0][1][-3000:]}"
                           f"\n--- rank 1 ---\n{logs[1][1][-3000:]}")
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]


def main(suite, rank, world, store, out_path, inputs="-", device="cpu"):
    rank, world = int(rank), int(world)
    pm.init_distributed("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    mesh = pm.make_mesh(world, device=device)
    out = {}
    if suite == "parallel":
        suite_parallel(mesh, out)
    else:
        suite_multihost(mesh, out, torch.load(inputs, weights_only=False))
    torch.save(out, f"{out_path}.{rank}")
    pm.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
