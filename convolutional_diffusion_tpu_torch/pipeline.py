"""ELS sample generation and evaluation pipelines.

Counterpart of `convolutional_diffusion_tpu/pipeline.py`: the reference's
`els_script.py` artifact layout with resume and `--fill`, and the normalized
correlation metrics of its `eval_script.py`.

Artifact layout (the reference's):
    <out_dir>/seeds/%04d.<ext>
    <out_dir>/<idealname>/%04d.<ext>
    <out_dir>/labels/%04d.<ext>      (conditional)
Arrays are written as .npy (or .pt with fmt='pt') and read from either, so
artifacts written by the reference, by the JAX package or by this package
are interchangeable.

Seeds: index j's seed and label come from their own generator,
`np.random.default_rng([seed, j])`, so a resume reproduces the samples it
did not write yet. They are not the JAX package's seeds (its `fold_in` keys
have no torch or numpy counterpart); the two packages meet through `--fill`
over the same saved seeds.

Under a profiler the host's parts of a call are named ranges: the resume
scan (`pipeline.resume_scan`), the seed draws (`pipeline.draw`), each copy
of a machine output back to the host (`pipeline.copy_back`, which also
waits for the machine's last kernels) and a batch's writes
(`pipeline.write`).
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, Optional

import numpy as np

from .convert import load_pt
from .utils.profiling import annotate

__all__ = [
    "save_array",
    "load_array",
    "generate_els_samples",
    "evaluate_correlations",
    "auto_detect_scales",
]


def _to_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor, on any device
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_array(path_noext: str, arr, fmt: str = "npy"):
    arr = _to_numpy(arr)
    if fmt == "pt":
        import torch

        torch.save(torch.from_numpy(np.ascontiguousarray(arr)), path_noext + ".pt")
    else:
        np.save(path_noext + ".npy", arr)


def load_array(path_noext: str) -> Optional[np.ndarray]:
    """Load `%s.npy` or `%s.pt` (whichever exists); None if neither."""
    if os.path.exists(path_noext + ".npy"):
        return np.load(path_noext + ".npy")
    if os.path.exists(path_noext + ".pt"):
        return _to_numpy(load_pt(path_noext + ".pt"))
    return None


def _exists(path_noext: str) -> bool:
    return os.path.exists(path_noext + ".npy") or os.path.exists(path_noext + ".pt")


def _nchw_to_nhwc_if_needed(a: np.ndarray, channels: int) -> np.ndarray:
    """Reference artifacts are NCHW; ours NHWC. Disambiguate by channel axis."""
    if a.ndim == 4 and a.shape[1] == channels and a.shape[-1] != channels:
        return a.transpose(0, 2, 3, 1)
    return a


def auto_detect_scales(checkpoints_dir: str, dataset_name: str) -> str:
    """The reference's scales-file search order (conditional ResNet first),
    accepting .npy and .json exports of the same names."""
    up = dataset_name.upper()
    candidates = [
        f"scales_{up}_ResNet_zeros_conditional.pt",
        f"scales_{up}_ResNet_zeros.pt",
        f"scales_{up}_UNet_zeros_conditional.pt",
        f"scales_{up}_UNet_zeros.pt",
    ]
    for c in candidates:
        for name in (c, c.replace(".pt", ".npy"), c.replace(".pt", ".json")):
            p = os.path.join(checkpoints_dir, name)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(
        f"no scales file for {dataset_name} in {checkpoints_dir} "
        f"(looked for {candidates})"
    )


def _copy_back(out) -> np.ndarray:
    with annotate("pipeline.copy_back"):
        return _to_numpy(out)


def _run(machine, xs, labels):
    """Machine outputs as numpy for seeds `xs` (each [1, h, w, c]) with
    `labels` (None, or one int per seed): unconditional in one call; with
    labels one call if the module takes a label vector (one per-seed sweep),
    else one call per distinct label. Returns [len(xs), h, w, c]."""
    x = np.concatenate(xs, axis=0)
    if labels is None:
        return _copy_back(machine(x))
    if getattr(machine.backbone, "supports_vector_label", False):
        return _copy_back(machine(x, label=np.asarray(labels, np.int64)))
    out = np.empty(x.shape, np.float32)
    for lab in dict.fromkeys(labels):  # distinct labels, first-seen order
        rows = [i for i, l in enumerate(labels) if l == lab]
        out[rows] = _copy_back(machine(x[rows], label=lab))
    return out


def generate_els_samples(
    machine,
    out_dir: str,
    *,
    numiters: int = 100,
    in_channels: int = 3,
    image_size: int = 32,
    conditional: bool = False,
    nlabels: int = 10,
    idealname: str = "els_outputs",
    fill: bool = False,
    force_overwrite: bool = False,
    batch: int = 1,
    fmt: str = "npy",
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    writer: bool = True,
) -> int:
    """Generate machine outputs under `out_dir` in the reference layout,
    `batch` seeds per machine call; returns the number of NEW samples.

    Resume: generation restarts at the first index missing its seed or its
    output. Fill: reuse the seeds (and labels) already saved to produce
    outputs under `idealname` for another score module. force_overwrite
    deletes `out_dir` first. Conditional runs draw one label per seed from
    [0, nlabels); see `_run` for how labels reach the machine. Every rank of
    a sharded machine runs this with the same calls; only the one with
    `writer` (rank 0) writes or deletes anything."""
    seed_dir = os.path.join(out_dir, "seeds")
    out_path = os.path.join(out_dir, idealname)
    lab_dir = os.path.join(out_dir, "labels")
    bsz = max(batch, 1)

    if fill:
        if not os.path.isdir(out_dir) or not os.path.isdir(seed_dir):
            raise FileNotFoundError(f"required directories missing: {seed_dir}")
        if writer:
            os.makedirs(out_path, exist_ok=True)
        todo = []
        i = 0
        while _exists(os.path.join(seed_dir, f"{i:04d}")):
            if not _exists(os.path.join(out_path, f"{i:04d}")):
                s = _nchw_to_nhwc_if_needed(
                    load_array(os.path.join(seed_dir, f"{i:04d}")), in_channels
                )
                label = None
                if conditional:
                    lab_raw = load_array(os.path.join(lab_dir, f"{i:04d}"))
                    if lab_raw is None:
                        raise FileNotFoundError(
                            f"labels/{i:04d} missing for conditional --fill "
                            f"under {out_dir}"
                        )
                    label = int(np.asarray(lab_raw).reshape(-1)[0])
                todo.append((i, s.reshape(1, *s.shape[-3:]).astype(np.float32), label))
            i += 1
        for start in range(0, len(todo), bsz):
            chunk = todo[start : start + bsz]
            out = _run(machine, [s for _, s, _ in chunk],
                       [l for _, _, l in chunk] if conditional else None)
            with annotate("pipeline.write"):
                for row, (j, _, _) in enumerate(chunk):
                    if writer:
                        save_array(os.path.join(out_path, f"{j:04d}"), out[row : row + 1], fmt)
        return len(todo)

    min_iter = 0
    if os.path.isdir(out_dir) and not force_overwrite:
        with annotate("pipeline.resume_scan"):
            for i in range(numiters):
                if not (_exists(os.path.join(seed_dir, f"{i:04d}"))
                        and _exists(os.path.join(out_path, f"{i:04d}"))):
                    min_iter = i
                    break
            else:
                min_iter = numiters
    elif os.path.isdir(out_dir) and writer:
        shutil.rmtree(out_dir)
    if writer:
        os.makedirs(seed_dir, exist_ok=True)
        os.makedirs(out_path, exist_ok=True)
        if conditional:
            os.makedirs(lab_dir, exist_ok=True)

    def draw(j):
        rng = np.random.default_rng([seed, j])
        x = rng.standard_normal((1, image_size, image_size, in_channels)).astype(np.float32)
        return x, (int(rng.integers(0, nlabels)) if conditional else None)

    produced = 0
    idx = min_iter
    while idx < numiters:
        n = min(bsz, numiters - idx)
        with annotate("pipeline.draw"):
            drawn = [draw(j) for j in range(idx, idx + n)]
        labels = [lab for _, lab in drawn] if conditional else None
        out = _run(machine, [s for s, _ in drawn], labels)
        with annotate("pipeline.write"):
            for o, (x, lab) in enumerate(drawn if writer else ()):
                j = idx + o
                save_array(os.path.join(seed_dir, f"{j:04d}"), x, fmt)
                save_array(os.path.join(out_path, f"{j:04d}"), out[o : o + 1], fmt)
                if conditional:
                    save_array(os.path.join(lab_dir, f"{j:04d}"),
                               np.asarray([lab], np.int64), fmt)
        produced += n
        idx += n
        if idx % max(1, 10 * n) == 0:
            log_fn(f"generated {idx}/{numiters}")
    return produced


def evaluate_correlations(
    exp_dir: str,
    sample_fn: Callable,  # (x [n,h,w,c], labels [n] or None) -> samples
    *,
    outputname: str = "els_outputs",
    conditional: bool = False,
    channels: int = 3,
) -> Dict[str, object]:
    """Normalized-correlation evaluation (the reference's eval_script).

    For the complete prefix of saved seeds (seed, output and `ideal/`
    output present): run `sample_fn` on all of them in one batch, then
    compare r(sample, machine output) against r(sample, ideal output), each
    array mean-centered and L2-normalized and r their inner product.
    Returns the per-seed correlations, their medians and the fraction of
    seeds where the machine beats the ideal score."""
    seed_dir = os.path.join(exp_dir, "seeds")
    out_dir = os.path.join(exp_dir, outputname)
    ideal_dir = os.path.join(exp_dir, "ideal")
    lab_dir = os.path.join(exp_dir, "labels")

    seeds, labels, theo, ideal = [], [], [], []
    n = 0
    while _exists(os.path.join(seed_dir, f"{n:04d}")):
        s_raw = load_array(os.path.join(seed_dir, f"{n:04d}"))
        th_raw = load_array(os.path.join(out_dir, f"{n:04d}"))
        idl_raw = load_array(os.path.join(ideal_dir, f"{n:04d}"))
        if th_raw is None or idl_raw is None:
            break
        s = _nchw_to_nhwc_if_needed(s_raw, channels)
        seeds.append(s.reshape(s.shape[-3:]) if s.ndim == 4 else s)
        theo.append(_nchw_to_nhwc_if_needed(th_raw, channels))
        ideal.append(_nchw_to_nhwc_if_needed(idl_raw, channels))
        if conditional:
            lab_raw = load_array(os.path.join(lab_dir, f"{n:04d}"))
            if lab_raw is None:
                raise FileNotFoundError(
                    f"labels/{n:04d} missing for --conditional evaluation "
                    f"under {exp_dir}"
                )
            labels.append(int(np.asarray(lab_raw).reshape(-1)[0]))
        n += 1
    if n == 0:
        raise FileNotFoundError(f"no complete sample set under {exp_dir}")

    x = np.stack(seeds).astype(np.float32)
    labs = np.asarray(labels, np.int32) if conditional else None
    outputs = _to_numpy(sample_fn(x, labs))

    def normalize(a):
        a = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(1, -1)
        a = a - a.mean(axis=1, keepdims=True)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    no = normalize(outputs)
    nt = normalize(np.stack([t.reshape(-1) for t in theo]))
    ni = normalize(np.stack([t.reshape(-1) for t in ideal]))
    ideal_corrs = np.sum(ni * no, axis=1)
    target_corrs = np.sum(nt * no, axis=1)
    return {
        "ideal_corrs": ideal_corrs,
        "target_corrs": target_corrs,
        "median_ideal": float(np.median(ideal_corrs)),
        "median_target": float(np.median(target_corrs)),
        "frac_els_beats_is": float(np.mean(target_corrs > ideal_corrs)),
        "n": n,
    }
