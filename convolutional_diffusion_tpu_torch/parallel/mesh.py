"""Process groups and meshes: the port's distributed backbone.

Counterpart of `convolutional_diffusion_tpu/parallel/mesh.py`. JAX runs one
program over a `Mesh` of devices; PyTorch runs one process per device, joined
into a `torch.distributed` group, and this module gives that group JAX's
vocabulary:

 - `init_distributed` joins the group a launcher (`torchrun`) describes, or
   the one a caller names (`init_method`, `world_size`, `rank`); without
   either it is a no-op that returns 1;
 - `make_mesh` lays the group's ranks out over named axes, with JAX's
   factoring of n over several axes, and gives each axis its process group
   and each rank its device (`cuda:LOCAL_RANK` unless the caller names one);
 - `shard_batch` takes a rank's slice of dim 0, `replicate` broadcasts from
   rank 0; `spawn` starts n ranks itself (the CLIs' `--ndevices N` outside
   a launcher).

Within a group the mesh's process groups are those of a
`torch.distributed.device_mesh.DeviceMesh` with the same axis names (it
takes two gloo ranks sharing one card too); `Mesh` adds this rank's device,
named apart from the rank (two ranks on `cuda:0`), and stands for a world
of one outside any group, where collectives are the identity.

Every collective the port issues goes through `all_reduce`, `all_gather`
or `broadcast` here, which count their calls and bytes in `COLLECTIVES`;
BatchNorm's differentiable all-reduce counts its forward with
`count_collective`.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVES",
    "Mesh",
    "all_gather",
    "all_reduce",
    "barrier",
    "broadcast",
    "count_collective",
    "data_spec",
    "init_distributed",
    "is_writer",
    "make_mesh",
    "mesh_shape",
    "rank_device",
    "replicate",
    "reset_collectives",
    "shard_batch",
    "spawn",
]

# calls and bytes of each collective kind since the last reset_collectives()
COLLECTIVES = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
               "all_gather_bytes": 0, "broadcast": 0, "broadcast_bytes": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_collectives() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


def count_collective(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES[kind + "_bytes"] += t.numel() * t.element_size()


def init_distributed(backend: Optional[str] = None, *, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> int:
    """Join the process group and return its size. Without `init_method`
    the group is the one `torchrun` describes (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK; LOCAL_RANK picks the card); where that environment is
    absent this is a no-op that returns 1, as the JAX package's is. A group
    already joined is kept. The backend is NCCL where a card is visible and
    gloo on the CPU; a caller may name gloo (two ranks on one card)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return 1
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return dist.get_world_size()


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` where given (`cuda` without an index is
    the current card), else `cuda:LOCAL_RANK`. A local rank past the visible
    cards is an error that names their count."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                               "the plain PyTorch path on the CPU")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise ValueError(f"local rank {local} needs a card of its own, but only "
                         f"{torch.cuda.device_count()} CUDA device(s) are visible")
    return torch.device("cuda", local)


def mesh_shape(n: int, axis_names: Sequence[str]) -> tuple:
    """JAX's factoring of n over the axes (`parallel/mesh.py:76-99` there):
    as evenly as possible, the larger factors first (axis 0 is 'data'):
    8 over 2 axes (4, 2), 4 over 2 (2, 2), 8 over 3 (2, 2, 2); primes
    degrade to (n, 1, ...)."""
    if len(axis_names) == 1:
        return (n,)
    sizes, rem = [], n
    for axes_left in range(len(axis_names), 1, -1):
        target = int(round(rem ** (1.0 / axes_left)))
        d = max(dd for dd in range(1, max(target, 1) + 1) if rem % dd == 0)
        sizes.append(d)
        rem //= d
    return (rem, *reversed(sizes))


class Mesh:
    """The group's ranks laid out over named axes (rank-major, as
    `np.arange(n).reshape(shape)`). `shape` maps each axis to its size, as
    JAX's `Mesh.shape` does; `group(axis)` is the process group of the
    ranks that share this rank's other coordinates (None: a world of one
    outside any group, where collectives are the identity); `device` is this
    rank's device; `device_mesh` the DeviceMesh within a group."""

    def __init__(self, shape: dict, coords: dict, groups: dict, device: torch.device,
                 device_mesh=None):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.coords = coords
        self.groups = groups
        self.device = device
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axis: str = "data"):
        return self.groups[axis]

    def axis_size(self, axis: str = "data") -> int:
        return self.shape[axis]

    def axis_rank(self, axis: str = "data") -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",), *,
              device=None) -> Mesh:
    """A mesh over the joined group (`init_distributed`), of n_devices ranks
    (default: all of them; a world of one outside any group). The group must
    hold exactly n_devices ranks: each rank is one device. Every rank must
    call this, in the same order (a mesh of several axes creates one process
    group per row of each axis)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs a group of {n} processes, one per device; this "
            f"one has {world} (run under `torchrun --nproc_per_node {n}`, or join a group "
            "with init_distributed)")
    shape = mesh_shape(n, axis_names)
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh(dict(zip(axis_names, shape)), dict.fromkeys(axis_names, 0),
                    dict.fromkeys(axis_names), dev)
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))
    coords = {name: int(c) for name, c in zip(axis_names, dm.get_coordinate())}
    groups = {name: dm.get_group(name) for name in axis_names}
    return Mesh(dict(zip(axis_names, shape)), coords, groups, dev, dm)


def data_spec(ndim: int, axis: str = "data") -> tuple:
    """dim 0 over `axis`, the rest whole: JAX's PartitionSpec as a tuple."""
    return (axis, *([None] * (ndim - 1)))


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's slice of dim 0 of every tensor in `batch` (a tensor, or
    a list, tuple or dict of them): rows [r * b / n, (r + 1) * b / n) for
    axis rank r of n. A dim 0 that does not divide over the axis is an
    error."""
    n, r = mesh.axis_size(axis), mesh.axis_rank(axis)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of size {x.shape[0]} does not divide over the "
                             f"{n} ranks of mesh axis {axis!r}")
        per = x.shape[0] // n
        return x[r * per:(r + 1) * per]

    return _tree_map(take, batch)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all-reduce (op 'sum' or 'max') over `group`; the identity
    outside any group."""
    if dist.is_initialized():
        count_collective("all_reduce", t)
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0, in rank order, on every
    rank; `t` itself outside any group."""
    if not dist.is_initialized():
        return t
    t = t.contiguous()
    count_collective("all_gather", t)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place, `t` of rank `src` on every rank; the identity outside any
    group."""
    if dist.is_initialized():
        count_collective("broadcast", t)
        dist.broadcast(t, src=src, group=group)
    return t


def replicate(tree, mesh: Mesh):
    """Rank 0's values of every tensor in `tree` (a module's parameters and
    buffers, a tensor, or a list, tuple or dict of them) on every rank, in
    place; returns `tree`."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in [*tree.parameters(), *tree.buffers()]:
                broadcast(t.data)
        return tree
    with torch.no_grad():
        _tree_map(lambda t: broadcast(t), tree)
    return tree


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def is_writer() -> bool:
    """Whether this process writes artifacts: rank 0, or a process outside
    any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _spawned(rank, fn, args, world, init_method, backend, out):
    os.environ["LOCAL_RANK"] = str(rank)
    init_distributed(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        result = fn(*args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, cpu: bool = False):
    """Run `fn(*args)` in `nprocs` new processes joined into one group (a
    file store in a temporary directory, so concurrent runs never collide),
    one per card over NCCL, or gloo ranks on the CPU with `cpu`; returns
    rank 0's result. Fails if any rank fails. More ranks than visible cards
    is an error that names their count."""
    import torch.multiprocessing as mp

    if not cpu and nprocs > torch.cuda.device_count():
        raise ValueError(f"{nprocs} ranks need {nprocs} CUDA devices, one each; "
                         f"{torch.cuda.device_count()} visible (pass --cpu for gloo "
                         "ranks on the CPU)")
    with tempfile.TemporaryDirectory(prefix="cdt_group_") as tmp:
        out = os.path.join(tmp, "result.pkl")
        mp.spawn(_spawned, args=(fn, args, nprocs, f"file://{tmp}/store",
                                 "gloo" if cpu else "nccl", out),
                 nprocs=nprocs, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)
