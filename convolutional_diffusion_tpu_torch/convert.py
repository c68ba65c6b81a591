"""Carrying state across from the JAX package and from the reference.

Counterpart of `convolutional_diffusion_tpu/convert.py` (and of the scales
loader in its `cli/els.py`): the cached patch banks (plain and clustered),
the calibrated scales files (`.json`, `.npy`, `.pt`), the reference's whole
`backbone_*.pt` pickles (unpickled without its code), the JAX package's
flax params and its optax AdamW state. Everything crosses as numpy arrays
or CPU tensors.

Layouts: the port's backbones keep the reference's torch layout, so a
reference state_dict loads as it is; flax params cross through
`resnet_state_dict_from_jax_params` / `unet_state_dict_from_jax_params`:
 - flax Conv kernel [kh, kw, I, O]          -> torch Conv2d [O, I, kh, kw]
 - flax Dense kernel [I, O]                 -> torch Linear [O, I]
 - flax ConvTranspose (transpose_kernel=True) [kh, kw, O, I]
                                            -> torch ConvTranspose2d [I, O, kh, kw]
 - flax GroupNorm / BatchNorm scale, bias   -> weight, bias; batch_stats
   mean, var -> running_mean, running_var
 - flax Embed embedding                     -> Embedding weight
"""

from __future__ import annotations

import json
import pickle
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .ops.prune import BankBlockStats
from .scores.bank import Bank, BankGeometry, ClusteredBank
from .scores.base import resolve_device


def bank_from_jax_numpy(bank, centers, pn, geometry: BankGeometry, device=None) -> Bank:
    """The JAX package's compact cached bank (`build_bank` output as numpy:
    bank [nblk, B*d], centers [nblk, B*c], pn [nblk, B]) -> this package's
    Bank ([nblk, B, d], [nblk, B, c], [nblk, B]) on `device` (default cuda)."""
    dev = resolve_device(device)
    g = geometry
    bank = np.asarray(bank, np.float32)
    centers = np.asarray(centers, np.float32)
    pn = np.asarray(pn, np.float32)
    if bank.shape != (g.nblk, g.block * g.d) or pn.shape != (g.nblk, g.block):
        raise ValueError(
            f"bank {bank.shape} / pn {pn.shape} do not match geometry {g}"
        )
    c = centers.shape[1] // g.block
    if centers.shape != (g.nblk, g.block * c):
        raise ValueError(f"centers {centers.shape} do not match geometry {g}")
    return Bank(
        torch.from_numpy(bank.reshape(g.nblk, g.block, g.d)).to(dev),
        torch.from_numpy(centers.reshape(g.nblk, g.block, c)).to(dev),
        torch.from_numpy(pn).to(dev),
    )


def clustered_bank_from_jax_numpy(bank, centers, pn, img_idx, centroids, radii,
                                  valid, geometry: BankGeometry,
                                  device=None) -> ClusteredBank:
    """The JAX package's `ClusteredBank` as numpy (bank [nblk, B*d], centers
    [nblk, B*c], pn and img_idx [nblk, B], and its stats flattened over
    (chunk, block): centroids [J, d], radii [J], valid [J]) -> this
    package's ClusteredBank on `device` (default cuda): the same rows in the
    same order, whatever k-means did with ties."""
    g = geometry
    plain = bank_from_jax_numpy(bank, centers, pn, g, device=device)
    dev = plain.bank.device
    img_idx = np.asarray(img_idx, np.int32)
    centroids = np.asarray(centroids, np.float32)
    J = centroids.shape[0]
    if img_idx.shape != (g.nblk, g.block) or centroids.shape != (J, g.d) \
            or np.shape(radii) != (J,) or np.shape(valid) != (J,):
        raise ValueError(
            f"img_idx {img_idx.shape} / stats {centroids.shape} do not match "
            f"geometry {g}"
        )
    stats = BankBlockStats(
        torch.from_numpy(centroids).to(dev),
        torch.from_numpy(np.asarray(radii, np.float32)).to(dev),
        torch.from_numpy(np.asarray(valid, bool)).to(dev),
    )
    return ClusteredBank(*plain, torch.from_numpy(img_idx).to(dev), stats)


def load_pt(path: str):
    """A `torch.save`'d object, on the CPU: read with `weights_only=True`,
    and with a full unpickle only where that refuses the file."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_scales(path: str) -> list:
    """Per-step kernel sizes from a `.json` list, a `.npy` array, or a
    `.pt` file (the reference's `scales_*.pt`: a `torch.save`'d list of
    ints or a tensor, read by `load_pt`)."""
    if path.endswith(".json"):
        with open(path) as f:
            return [int(s) for s in json.load(f)]
    if path.endswith(".npy"):
        return [int(s) for s in np.load(path)]
    scales = load_pt(path)
    if isinstance(scales, torch.Tensor):
        scales = scales.reshape(-1).tolist()
    return [int(s.item() if hasattr(s, "item") else s) for s in scales]


# ---------------------------------------------------------------------------
# Reference whole pickles (backbone_*.pt), read without the reference's code
# ---------------------------------------------------------------------------


class _StubModule:
    """Stand-in for a pickled class of the reference's own (src.models.*).
    torch.nn classes unpickle as real torch modules, so the tree is mixed:
    the helpers below read both through `__dict__`."""

    _stub_classname: str = "?"

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


def module_children(m) -> Dict[str, Any]:
    return dict(m.__dict__.get("_modules") or {})


def module_attr(m, name, default=None):
    return m.__dict__.get(name, default)


def module_child(m, name):
    return module_children(m).get(name)


def module_state_dict(m, prefix="") -> Dict[str, torch.Tensor]:
    """Flat state_dict of a mixed tree of stubs and torch modules."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in (m.__dict__.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = p
    for name, b in (m.__dict__.get("_buffers") or {}).items():
        if b is not None:
            out[prefix + name] = b
    for name, c in module_children(m).items():
        if c is not None:
            out.update(module_state_dict(c, prefix + name + "."))
    return out


_REAL_MODULES = ("collections", "builtins", "__builtin__", "numpy",
                 "numpy._core.multiarray", "numpy.core.multiarray")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        # exactly 'torch' or 'torch.*': a bare startswith('torch') would also
        # take torchvision and bypass the stubs
        if module == "torch" or module.startswith("torch.") or module in _REAL_MODULES:
            return super().find_class(module, name)
        return type(name, (_StubModule,), {"_stub_classname": f"{module}.{name}"})


class _PickleShim:
    """The pickle-module interface torch.load reads, around `_Unpickler`."""

    __name__ = "pickle_stub_shim"
    Unpickler = _Unpickler

    @staticmethod
    def load(f, **kw):
        return _Unpickler(f, **kw).load()


def load_torch_pickle(path: str):
    """Unpickle a reference `backbone_*.pt` (or any torch.save'd module) on
    the CPU without the reference's code: every class outside torch, numpy,
    collections and builtins resolves to a `_StubModule`, so no module of
    the reference is imported or run. torch refuses an explicit pickle
    module under weights_only=True, hence weights_only=False here, with
    the stub resolver in its place."""
    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu", pickle_module=_PickleShim,
                          weights_only=False)


def _resnet_from_stub(backbone, sd, in_channels, precision):
    from .models import MinimalResNet

    num_layers = int(module_attr(backbone, "num_layers", 6))
    normalization = module_attr(backbone, "normalization", None)
    down = sd["down_projection.weight" if normalization is None
              else "down_projection.1.weight"]
    return MinimalResNet(
        channels=in_channels,
        emb_dim=int(module_attr(backbone, "emb_dim", sd["up_projection.weight"].shape[0])),
        mode=module_attr(backbone, "mode", "circular"),
        normalization=normalization,
        conditional=bool(module_attr(backbone, "conditional", False)),
        num_classes=module_attr(backbone, "num_classes"),
        kernel_size=int(sd["up_projection.weight"].shape[-1]),
        num_layers=num_layers,
        lastksize=int(down.shape[-1]),
        add_one=len(module_children(module_child(backbone, "embs"))) > num_layers,
        precision=precision,
    )


def _unet_from_stub(backbone, sd, in_channels, precision):
    from .models import MinimalUNet

    fsizes = tuple(int(f) for f in module_attr(backbone, "fsizes", (32, 64, 128, 256)))
    # MinimalUNet stores no normalization: a 1-D `model.N.weight` in a
    # feature block is a norm, BatchNorm when it has running statistics
    has_norm = any(
        re.match(r"feature_blocks\.\d+\.model\.\d+\.weight$", k) and v.ndim == 1
        for k, v in sd.items()
    )
    has_bn = any(k.endswith(".running_mean") for k in sd)
    normalization = ("BatchNorm" if has_bn else "GroupNorm") if has_norm else None
    conditional = bool(module_attr(backbone, "conditional", False))
    # nor its mode: read the padding_mode of its first conv
    mode = "circular"
    blocks = module_child(backbone, "feature_blocks")
    first = module_child(blocks, "0") if blocks is not None else None
    if first is not None:
        mode = module_attr(module_child(module_child(first, "model"), "0"),
                           "padding_mode", "circular")
    return MinimalUNet(
        channels=in_channels, fsizes=fsizes, mode=mode, conditional=conditional,
        num_classes=(int(sd["embedding.class_embeddings.weight"].shape[0])
                     if conditional else None),
        emb_dim=int(module_attr(backbone, "emb_dim", 256)),
        normalization=normalization,
        last_norm=(bool(module_attr(backbone, "last_norm", False))
                   and "last_normalizer.weight" in sd),
        kernel_size=int(module_attr(backbone, "kernel_size", 3)),
        lastksize=int(module_attr(backbone, "lastksize", 1)),
        precision=precision,
    )


def diffusion_model_from_torch_pickle(path: str, device=None, precision="highest"):
    """A reference `backbone_*.pt` (a whole pickled DDIM module, or a bare
    backbone) -> `models.DiffusionModel` on `device` (default cuda) with the
    pickle's weights, in eval() mode. The architecture is read from the
    pickled attributes as the JAX package reads it: the ResNet's add_one
    from its number of `embs`, its kernel sizes from the conv weights; the
    UNet's normalization from the 1-D `model.N.weight`s (BatchNorm from
    `running_mean`), its mode from the first conv's `padding_mode`."""
    from .models import DiffusionModel
    from .schedules import cosine_noise_schedule

    dev = resolve_device(device)
    stub = load_torch_pickle(path)
    if getattr(stub, "_stub_classname", "").endswith("DDIM"):
        backbone = module_child(stub, "backbone")
        in_channels = module_attr(stub, "in_channels", 3)
        default_imsize = module_attr(stub, "default_imsize", 32)
    else:
        backbone, default_imsize = stub, 32
        in_channels = module_attr(stub, "channels", 3)
    if backbone is None:
        raise ValueError(f"no backbone module found in {path}")
    bcls = getattr(backbone, "_stub_classname", "")
    sd = module_state_dict(backbone)
    if bcls.endswith("MinimalResNet"):
        net = _resnet_from_stub(backbone, sd, in_channels, precision)
    elif bcls.endswith("MinimalUNet"):
        net = _unet_from_stub(backbone, sd, in_channels, precision)
    else:
        raise ValueError(f"unsupported backbone class {bcls!r} in {path}")
    model = DiffusionModel(net, noise_schedule=cosine_noise_schedule,
                           in_channels=int(in_channels),
                           default_imsize=int(default_imsize), device=dev)
    model.backbone.load_state_dict(sd, strict=True)
    return model


# ---------------------------------------------------------------------------
# JAX (flax) params -> the port's state_dict
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    """A float32 CPU tensor in C order: a transposed view's strides would
    otherwise carry over, and the fused optimizer takes its moments
    contiguous."""
    return torch.from_numpy(np.array(a, np.float32, copy=True, order="C"))


def _put_conv(sd, prefix, entry):
    """flax Conv [kh, kw, I, O] -> Conv2d [O, I, kh, kw]."""
    sd[prefix + ".weight"] = _t(np.asarray(entry["kernel"]).transpose(3, 2, 0, 1))
    sd[prefix + ".bias"] = _t(entry["bias"])


def _put_dense(sd, prefix, entry):
    """flax Dense [I, O] -> Linear [O, I]."""
    sd[prefix + ".weight"] = _t(np.asarray(entry["kernel"]).T)
    sd[prefix + ".bias"] = _t(entry["bias"])


def _put_norm(sd, prefix, entry, stats=None):
    sd[prefix + ".weight"] = _t(entry["scale"])
    sd[prefix + ".bias"] = _t(entry["bias"])
    if stats is not None:  # BatchNorm running statistics
        sd[prefix + ".running_mean"] = _t(stats["mean"])
        sd[prefix + ".running_var"] = _t(stats["var"])
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def resnet_state_dict_from_jax_params(
    params: Mapping[str, Any], *, num_layers: int,
    normalization: Optional[str] = None, add_one: bool = True,
    conditional: bool = False,
) -> Dict[str, torch.Tensor]:
    """The JAX package's MinimalResNet params (as numpy) -> a state_dict of
    the port's MinimalResNet (the reference's layout)."""
    sd: Dict[str, torch.Tensor] = {}
    if conditional:
        sd["embedding.class_embeddings.weight"] = _t(
            params["embedding"]["class_embeddings"]["embedding"])
    _put_conv(sd, "up_projection", params["up_projection"]["conv"])
    for i in range(num_layers + int(add_one)):
        _put_dense(sd, f"embs.{i}.0", params[f"emb_{i}"]["dense"])
        _put_norm(sd, f"embs.{i}.1", params[f"emb_{i}"]["norm"])
    for i in range(num_layers):
        _put_conv(sd, f"convs.{i}.0", params[f"conv_{i}"]["conv"])
        if normalization is not None:
            _put_norm(sd, f"convs.{i}.1", params[f"conv_norm_{i}"])
    if normalization is None:
        _put_conv(sd, "down_projection", params["down_projection"]["conv"])
    else:
        _put_norm(sd, "down_projection.0", params["down_norm"])
        _put_conv(sd, "down_projection.1", params["down_projection"]["conv"])
    return sd


def _put_ublock(sd, prefix, block, stats, *, normalization, depth):
    """A UBlock's `emb.1` and `model` = depth x [Conv, (Norm), ReLU]."""
    _put_dense(sd, f"{prefix}.emb.1", block["emb_dense"])
    stride = 3 if normalization is not None else 2
    for i in range(depth):
        _put_conv(sd, f"{prefix}.model.{i * stride}", block[f"conv_{i}"]["conv"])
        if normalization is not None:
            _put_norm(sd, f"{prefix}.model.{i * stride + 1}", block[f"norm_{i}"],
                      stats.get(f"norm_{i}") if stats else None)


def unet_state_dict_from_jax_params(
    variables: Mapping[str, Any], *, n_feature_blocks: int,
    normalization: Optional[str] = None, conditional: bool = False,
    last_norm: bool = False, depth: int = 2,
) -> Dict[str, torch.Tensor]:
    """The JAX package's MinimalUNet params, or its variables dict
    ({'params', 'batch_stats'}: BatchNorm running statistics cross too), as
    numpy -> a state_dict of the port's MinimalUNet."""
    if "params" in variables:
        params, bstats = variables["params"], variables.get("batch_stats", {})
    else:
        params, bstats = variables, {}
    blk = dict(normalization=normalization, depth=depth)
    sd: Dict[str, torch.Tensor] = {}
    if conditional:
        sd["embedding.class_embeddings.weight"] = _t(
            params["embedding"]["class_embeddings"]["embedding"])
    for i in range(n_feature_blocks):
        _put_ublock(sd, f"feature_blocks.{i}", params[f"feature_block_{i}"],
                    bstats.get(f"feature_block_{i}"), **blk)
    _put_ublock(sd, "bottleneck", params["bottleneck"], bstats.get("bottleneck"), **blk)
    for j in range(n_feature_blocks):
        up = params[f"upsample_{j}"]
        # flax transpose_kernel=True [kh, kw, O, I] -> torch [I, O, kh, kw]
        sd[f"upsamples.{j}.weight"] = _t(np.asarray(up["kernel"]).transpose(3, 2, 0, 1))
        sd[f"upsamples.{j}.bias"] = _t(up["bias"])
        _put_ublock(sd, f"output_blocks.{j}", params[f"output_block_{j}"],
                    bstats.get(f"output_block_{j}"), **blk)
    _put_dense(sd, "last_emb.1", params["last_emb_dense"])
    _put_conv(sd, "output_conv", params["output_conv"]["conv"])
    if last_norm and "last_normalizer" in params:
        _put_norm(sd, "last_normalizer", params["last_normalizer"],
                  bstats.get("last_normalizer"))
    return sd


# ---------------------------------------------------------------------------
# JAX (optax) optimizer state -> the port's AdamW and ExponentialLR
# ---------------------------------------------------------------------------


def _entries(tree):
    """The parts of an optax chain state: a tuple of namedtuples, or what
    Orbax restores without a target (lists, dicts keyed '0', '1', ...)."""
    if isinstance(tree, Mapping):
        return [tree[k] for k in sorted(tree, key=int)]
    return list(tree)


def _field(entry, name):
    if isinstance(entry, Mapping):
        return entry.get(name)
    return getattr(entry, name, None)


def adamw_state_from_jax(opt_state, optimizer, scheduler, backbone,
                         to_state_dict) -> int:
    """Load the JAX package's optimizer state (optax `adamw` with an
    exponential schedule, `training.make_optimizer`; leaves as numpy
    arrays) into the port's AdamW `optimizer` over `backbone`'s parameters
    and its ExponentialLR `scheduler` (both from the port's
    `training.make_optimizer`), so that a JAX run resumes in the port.
    `to_state_dict` maps a tree shaped like the flax params to the port's
    state_dict, e.g. `functools.partial(resnet_state_dict_from_jax_params,
    num_layers=8, conditional=True)`: the moments mu and nu take the
    params' layout moves (conv and dense transposes, the ConvTranspose
    flip). The schedule moves to lr * gamma^count. Returns count, the step."""
    adam = next((e for e in _entries(opt_state)
                 if _field(e, "mu") is not None and _field(e, "nu") is not None), None)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in the optimizer state")
    count = int(np.asarray(_field(adam, "count")))
    mu, nu = to_state_dict(_field(adam, "mu")), to_state_dict(_field(adam, "nu"))
    names = {id(p): n for n, p in backbone.named_parameters()}
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if set(names) != {id(p) for p in params}:
        raise ValueError("the optimizer does not hold exactly the backbone's parameters")
    sd["state"] = {
        i: {"step": torch.tensor(float(count)), "exp_avg": mu[names[id(p)]].reshape(p.shape),
            "exp_avg_sq": nu[names[id(p)]].reshape(p.shape)}
        for i, p in enumerate(params)
    }
    optimizer.load_state_dict(sd)
    gamma = scheduler.gamma
    lrs = [base * gamma ** count for base in scheduler.base_lrs]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    sched = scheduler.state_dict()
    sched.update(last_epoch=count, _last_lr=lrs)
    scheduler.load_state_dict(sched)
    return count
