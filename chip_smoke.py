#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--n IMAGES] [--seed SEED]

Phases, each printing its own lines; any failure exits non-zero:

1. device   — the card's name and power limit (nvidia-smi) and torch's view.
2. build    — compiles both flash-score kernels from the sources in this
              checkout (one nvcc per source, started together, sm_90a) and
              prints ptxas registers, shared memory and spills, and the
              build times.
3. kernel   — each kernel against its plain PyTorch version on the card at
              the main path's shapes: M = 8192 query rows (8 seeds x 32x32),
              one full CIFAR10 bank chunk, c = 3: K1 ('highest', fp32) and
              K2 ('high', bf16x3 on the tensor cores) at k in {3, 9, 17},
              t in {0.05, 0.5, 0.95}, K2 also at the bbELS center's shape
              (its valid windows, M = 8 (33 - k)^2, 7200 at k = 3: a
              partial last block); plus a two-call chain against one call
              and a carried state holding sentinel rows. Every chunk has
              zero-weight rows. Compared on m + log s1 and s2/s1 at
              max|a-b| / max(|a|,|b|,1) <= 1e-3. For every k of the
              schedule: each kernel's time, its plain version's time and its
              bound, and K2's time at the bbELS center's query count. K2
              against K1 (the tier gap) is printed as information only.
4. k5       — per-seed weights, kernel variant K5, in both kernels:
              M = 8192 (8 seeds x 1024 rows) against one full CIFAR10
              chunk, w [8, P] from label-filtered image weights (one class
              per seed, one seed of a class with no image in the chunk),
              k in {3, 9, 17}, t in {0.05, 0.5, 0.95}, against
              the plain version at 1e-3; at t = 0.5 also chained, with
              sentinel rows, at rows_per_seed = 784 (a partial last block per
              seed), and against 8 one-seed 1-D launches (gate 1e-6); K5's
              time against the 1-D kernel's on the same inputs, and the
              grouped alternative's (8 launches at M = 1024, information).
5. main     — one 20-step ScheduledScoreMachine(LocalEquivScoreModule) call,
              fp32 ('highest'), CIFAR10 scales, 8 seeds of 32x32x3, over N
              synthetic bank images (default 50000, the JAX bench's
              els_20step_50kbank workload; a smaller --n is printed as
              `reduced`). K1's launch count must equal the sum of bank
              chunks over the 19 steps, K2's must be 0; the output finite.
6. bbels    — the same for LocalEquivBordersScoreModule at 'high' (the JAX
              bench's bbels_20step_50kbank_images_per_sec_bf16x3): K2's
              launch count must equal the sum of center-bank chunks over the
              19 steps (banked or streamed), K1's must be 0.
7. els_high — the same for LocalEquivScoreModule at 'high' (the JAX bench's
              els_20step_50kbank_images_per_sec_bf16x3).
8. cond     — conditional generation through pipeline.generate_els_samples:
              the CLI's default machine (cli.common.build_score_module
              ("ELS"), 20 steps, 'highest'), 8 seeds of 8 labels in one
              batch over the N bank images. K1's per-seed launch count must
              equal the sum of bank chunks over the 19 steps and no 1-D
              launch may run; the seeds, labels and outputs must be written
              in the artifact layout, finite. Then, as information, one
              module call at k = 3 as one K5 sweep against the seeds grouped
              by label.
9. cli      — cli.els.main on the card over --dataset synthetic (256
              images) with the CIFAR10 scales: conditional ELS at 'high'
              (K2's per-seed count must rise), IS --fill, conditional bbELS
              (grouped by label); the layout checked after each.
10. devices — small machines on cuda and on cpu (plain versions), compared at
              1e-3 relative to scale: ELS at 'highest', bbELS at 'high' with
              scales that reach k >= image size (its LS fallback), ELS with
              a 2-seed label vector at 'highest' and 'high', and IS.

Artifacts of phases 8 and 9 go to build/chip_smoke/ (git-ignored). The
card's name and power limit print as the first line, the kernels JSON
record as the second-to-last, and {"ok": true, "device": {...}} as the
last. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from convolutional_diffusion_tpu_torch.cli import els as cli_els
from convolutional_diffusion_tpu_torch.cli.common import build_score_module
from convolutional_diffusion_tpu_torch.data import synthetic_dataset
from convolutional_diffusion_tpu_torch.ops import _build
from convolutional_diffusion_tpu_torch.ops import flash_score as fs
from convolutional_diffusion_tpu_torch.ops.patches import extract_patches, pad_image
from convolutional_diffusion_tpu_torch.pipeline import generate_els_samples, load_array
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import (
    IdealScoreModule,
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)
from convolutional_diffusion_tpu_torch.scores.bank import bank_geometry, chunk_patches
from convolutional_diffusion_tpu_torch.scores.common import (
    CutoffRule,
    Weighting,
    image_weights,
)

CIFAR10_SCALES = [3, 3, 3, 3, 5, 5, 5, 7, 7, 7, 7, 9, 9, 11, 11, 13, 15, 17, 17, 17]
FULL_N = 50000
SEEDS = 8
TARGET_BLOCK = 65536
MODULE_BATCH = 256  # the JAX bench's ELS module batch size
CHECKED_K = (3, 9, 17)  # kernels held against the plain version at these k
TOL = 1e-3
# artifacts of the pipeline and CLI phases (git-ignored build/ of the checkout)
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
PEAK_FP32 = 67e12  # H100 SXM, fp32 outside the tensor cores (published)
PEAK_BF16 = 989e12  # H100 SXM, dense bf16 on the tensor cores (published)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (published)
# the flash-score kernels (ops._build names), each with its precision tier
TIER_OF = {name: prec for prec, name in fs.KERNEL_OF.items()}
# kernel -> the TPU kernel variant it ports
REPLACES = {
    "flash_score": "convolutional_diffusion_tpu/ops/flash_score.py:113",
    "flash_score_bf16x3": "convolutional_diffusion_tpu/ops/flash_score.py:174",
    "flash_score" + fs.PER_SEED: "convolutional_diffusion_tpu/ops/flash_score.py:399",
    "flash_score_bf16x3" + fs.PER_SEED: "convolutional_diffusion_tpu/ops/flash_score.py:399",
}


def source(name: str) -> str:
    """Kernel `name`'s CUDA source, as a path in the repo."""
    src = _build.CSRC / _build.KERNELS[name][0]
    return str(src.relative_to(_build.CSRC.parents[2]))


def kernel_record(name: str, rec: dict, launches: int) -> dict:
    """The kernels-line entry of launch-count key `name` (a kernel of
    ops._build, with fs.PER_SEED appended for its K5 variant)."""
    kernel, sep, variant = name.partition("/")
    return {
        "name": _build.KERNELS[kernel][1] + sep + variant,  # the C symbol
        "route": "cuda",
        "source": source(kernel),
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a-b| / max(|a|,|b|,1) over finite entries (same finite mask)."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)):
        return float("inf")
    a, b = a[fin], b[fin]
    scale = max(a.abs().max().item(), b.abs().max().item(), 1.0)
    return (a - b).abs().max().item() / scale


def compare(got, want):
    """(lse rel, mean rel, mean max abs) on the offset-invariant quantities;
    rows with no admitted patch (s1 = 0: an excluded seed) have no mean and
    are left out of the max abs."""
    lse = [s[0] + torch.log(s[1]) for s in (got, want)]
    mean = [s[2] / s[1][:, None] for s in (got, want)]
    diff = (mean[0] - mean[1]).abs()
    diff = diff[torch.isfinite(diff)]
    return rel(*lse), rel(*mean), diff.max().item() if diff.numel() else 0.0


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(M: int, P: int, d: int, c: int, precision: str, S: int = 1):
    """Least time on the card: the larger of the operations over their
    peaks and the bytes over the memory rate (each input read once, each
    output written once). 'highest': 2 M P d for the fp32 dots plus
    (6 + 2c) per pair for logit, max, exp2 and the sums, all at the fp32
    peak. 'high': the three bf16 products, 3 * 2 M P d_pad (d padded to 16),
    at the bf16 tensor-core peak, against the per-pair work at the fp32
    peak (the two units run side by side). Per-seed weights (K5, S seeds)
    change only the weight bytes, S * P instead of P."""
    elem = (6 + 2 * c) * M * P
    if precision == "highest":
        t_ops = (2 * M * P * d + elem) / PEAK_FP32 * 1e3
    else:
        d_pad = -(-d // 16) * 16
        t_ops = max(3 * 2 * M * P * d_pad / PEAK_BF16, elem / PEAK_FP32) * 1e3
    nbytes = 4 * (M * d + M + P * d + P + S * P + P * c + 2 * M * (2 + c))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def reset_launches():
    for name in fs.flash_score_update.launches:
        fs.flash_score_update.launches[name] = 0


def empty_state(M, c):
    return (torch.full((M,), fs.NEG_INF, device="cuda"),
            torch.zeros(M, device="cuda"), torch.zeros(M, c, device="cuda"))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)  # name, power limit: as nvidia-smi gives them
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}, {torch.cuda.device_count()} device(s)", flush=True)
    return smi[0], name


def phase_build():
    for name, built in _build.build_all(list(TIER_OF)).items():
        for line in built.log.splitlines():
            if any(t in line for t in ("registers", "spill", "smem", "Compiling entry")):
                print(f"[build] {name}: {line.strip()}", flush=True)
        how = f"built in {built.seconds:.1f} s" if built.seconds else "reused an identical build"
        print(f"[build] {source(name)}: {how}", flush=True)
        _build.load(name)


def phase_kernel(images_dev, n_bank, gen):
    """Each kernel against its plain version at the main path's shapes for k
    in CHECKED_K (K2 also at the bbELS center's shape: the valid windows,
    M = 8 (33 - k)^2); each kernel's, its plain version's and its bound's
    time for every k of the schedule; K2's time at the bbELS center's shape.
    Returns per kernel the JSON numbers (of the largest k) and the per-launch
    times by k."""
    recs = {name: {"max_abs_err": 0.0, "ms_by_k": {}} for name in TIER_OF}
    ms_center = {}
    for k in sorted(set(CIFAR10_SCALES)):
        checked = k in CHECKED_K
        g = bank_geometry(n_bank, 32, 32, 3, k, TARGET_BLOCK)
        imgs = images_dev[: g.cs]
        p, ctr, pn = chunk_patches(imgs, k)
        w_img = torch.full((g.cs,), 1.0 / (MODULE_BATCH * g.per_img), device="cuda")
        w_img[-max(1, g.cs // 8):] = 0.0  # zero-weight rows, as chunk padding has
        w = w_img.repeat_interleave(g.per_img)
        M, P, c = SEEDS * 32 * 32, p.shape[0], 3
        for t in (0.05, 0.5, 0.95) if checked else (0.5,):
            beta = cosine_noise_schedule(t)
            at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
            x = at.item() * imgs[:SEEDS] + bt.item() * torch.randn(
                imgs[:SEEDS].shape, generator=gen, device="cuda")
            xq = extract_patches(pad_image(x, k // 2, "circular"), k).reshape(M, g.d)
            qn = (xq * xq).sum(-1)
            args = (xq, qn, p, pn, ctr, w, at, bt)
            # the bbELS center's queries: the valid windows, no padding
            xc = extract_patches(x, k).reshape(-1, g.d).contiguous()
            mc = xc.shape[0]
            cargs = (xc, (xc * xc).sum(-1), *args[2:])
            outs = {}
            for name, prec in TIER_OF.items():
                rec = recs[name]
                kw = dict(precision=prec)
                if checked:
                    got = fs.flash_score_update(*args, empty_state(M, c), **kw)
                    want = fs.flash_score_update_plain(*args, empty_state(M, c), **kw)
                    torch.cuda.synchronize()
                    outs[name] = got
                    cases = {"one call": (got, want)}
                    if prec == "high":
                        cases[f"bbELS center M={mc}"] = (
                            fs.flash_score_update(*cargs, empty_state(mc, c), **kw),
                            fs.flash_score_update_plain(*cargs, empty_state(mc, c), **kw))
                    if t == 0.5:
                        h = P // 2 + 37  # not a tile multiple
                        half = fs.flash_score_update(
                            xq, qn, p[:h], pn[:h], ctr[:h], w[:h], at, bt,
                            empty_state(M, c), **kw)
                        chained = fs.flash_score_update(
                            xq, qn, p[h:], pn[h:], ctr[h:], w[h:], at, bt, half, **kw)
                        cases["two calls vs one"] = (chained, got)
                        st = tuple(s.clone() for s in want)
                        st[0][::7], st[1][::7], st[2][::7] = fs.NEG_INF, 0.0, 0.0
                        cases["sentinel rows in state"] = (
                            fs.flash_score_update(*args, st, **kw),
                            fs.flash_score_update_plain(*args, st, **kw))
                    for what, (a, b) in cases.items():
                        e_lse, e_mean, e_abs = compare(a, b)
                        rec["max_abs_err"] = max(rec["max_abs_err"], e_abs)
                        print(f"[kernel] {name} k={k} t={t} {what}: lse rel {e_lse:.2e}, "
                              f"mean rel {e_mean:.2e} (tol {TOL:g})", flush=True)
                        if not (e_lse <= TOL and e_mean <= TOL):
                            fail(f"{name} disagrees with its plain version at k={k} "
                                 f"t={t} ({what})")
                if t != 0.5:
                    continue
                ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
                plain_ms = cuda_ms(
                    lambda: fs.flash_score_update_plain(*args, empty_state(M, c), **kw), 3)
                b_ms, b_by = bound(M, P, g.d, c, prec)
                line = (f"[kernel] {name} k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, "
                        f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
                        f"{b_ms / ms:.1%} of bound")
                if prec == "highest":
                    prev = torch.backends.cuda.matmul.allow_tf32
                    torch.backends.cuda.matmul.allow_tf32 = False
                    try:
                        mm_ms = cuda_ms(lambda: torch.matmul(xq, p.T), 5)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = prev
                    line += f", fp32 matmul Q.K^T alone (partial yardstick) {mm_ms:.3f} ms"
                else:
                    ms_center[k] = cuda_ms(
                        lambda: fs.flash_score_update(*cargs, empty_state(mc, c), **kw), 5)
                    line += f"; at the bbELS center's M={mc}: {ms_center[k]:.3f} ms"
                print(line, flush=True)
                rec["ms_by_k"][k] = ms
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k)
            if checked:
                e_lse, e_mean, _ = compare(outs["flash_score_bf16x3"], outs["flash_score"])
                print(f"[kernel] tier gap k={k} t={t}, K2 'high' vs K1 'highest' "
                      f"(information, not a gate): lse rel {e_lse:.2e}, mean rel "
                      f"{e_mean:.2e}", flush=True)
        del p, ctr, pn
    return recs, ms_center


def per_seed_weights(labels, lab_of_seed, g):
    """[S, P] per-seed patch weights of one chunk: each seed's label-filtered
    image weights (the ELS module's rule) repeated over the image's
    patches."""
    rows = [image_weights(labels, lab, batch_size=MODULE_BATCH, max_samples=None,
                          cutoff=CutoffRule.UNFILTERED, weighting=Weighting.MEAN,
                          per_image_bank=g.per_img) for lab in lab_of_seed]
    return torch.stack(rows).repeat_interleave(g.per_img, dim=1).contiguous()


def phase_kernel_per_seed(images_dev, labels_dev, n_bank, gen):
    """K5, per-seed weights, in both kernels at the conditional path's
    shapes: M = 8192 query rows (8 seeds x 1024), rows_per_seed 1024, one
    full CIFAR10 chunk, w [8, P] from label-filtered image weights, one
    class per seed and one seed of a class with no image in the chunk (its
    whole bias row excluded), at k in CHECKED_K and t in {0.05, 0.5, 0.95},
    against the plain version; at t = 0.5 also a two-call chain, sentinel
    rows in the carried state, rows_per_seed = 784 (a partial last block
    per seed), and one K5 launch against the 8 one-seed 1-D launches on
    each seed's rows (gated at 1e-6). Times at t = 0.5: K5, the plain
    version, the bound, the 1-D kernel on the same inputs with seed 0's
    weights, and (information) the grouped alternative, 8 launches at
    M = 1024. Returns per K5 variant the JSON numbers (of the largest k)."""
    recs = {name + fs.PER_SEED: {"max_abs_err": 0.0} for name in TIER_OF}
    for k in CHECKED_K:
        g = bank_geometry(n_bank, 32, 32, 3, k, TARGET_BLOCK)
        imgs = images_dev[: g.cs]
        labels = labels_dev[: g.cs]
        p, ctr, pn = chunk_patches(imgs, k)
        present = sorted(set(labels.tolist()))
        absent = next((c for c in range(10) if c not in present), 10)
        lab_of_seed = [present[i % len(present)] for i in range(SEEDS - 1)] + [absent]
        w = per_seed_weights(labels, lab_of_seed, g)
        M, P, c, rps = SEEDS * 32 * 32, p.shape[0], 3, 32 * 32
        print(f"[k5] k={k} P={P}: seed labels {lab_of_seed} (class {absent} has no "
              f"image in the chunk), {(w == 0).float().mean().item():.1%} of the "
              "weights excluded", flush=True)
        for t in (0.05, 0.5, 0.95):
            beta = cosine_noise_schedule(t)
            at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
            x = at.item() * imgs[:SEEDS] + bt.item() * torch.randn(
                imgs[:SEEDS].shape, generator=gen, device="cuda")
            xq = extract_patches(pad_image(x, k // 2, "circular"), k).reshape(M, g.d)
            qn = (xq * xq).sum(-1)
            args = (xq, qn, p, pn, ctr, w, at, bt)
            for name, prec in TIER_OF.items():
                rec = recs[name + fs.PER_SEED]
                kw = dict(precision=prec, rows_per_seed=rps)
                got = fs.flash_score_update(*args, empty_state(M, c), **kw)
                want = fs.flash_score_update_plain(*args, empty_state(M, c), **kw)
                torch.cuda.synchronize()
                cases = {"one call": (got, want)}
                if t == 0.5:
                    h = P // 2 + 37  # not a tile multiple
                    half = fs.flash_score_update(
                        xq, qn, p[:h], pn[:h], ctr[:h], w[:, :h].contiguous(), at, bt,
                        empty_state(M, c), **kw)
                    cases["two calls vs one"] = (fs.flash_score_update(
                        xq, qn, p[h:], pn[h:], ctr[h:], w[:, h:].contiguous(), at, bt,
                        half, **kw), got)
                    st = tuple(s.clone() for s in want)
                    st[0][::7], st[1][::7], st[2][::7] = fs.NEG_INF, 0.0, 0.0
                    cases["sentinel rows in state"] = (
                        fs.flash_score_update(*args, st, **kw),
                        fs.flash_score_update_plain(*args, st, **kw))
                    q7 = xq.view(SEEDS, rps, g.d)[:, :784].reshape(-1, g.d)
                    a7 = (q7, (q7 * q7).sum(-1), *args[2:])
                    kw7 = dict(precision=prec, rows_per_seed=784)
                    cases["rows_per_seed 784"] = (
                        fs.flash_score_update(*a7, empty_state(q7.shape[0], c), **kw7),
                        fs.flash_score_update_plain(*a7, empty_state(q7.shape[0], c), **kw7))
                for what, (a, b) in cases.items():
                    e_lse, e_mean, e_abs = compare(a, b)
                    rec["max_abs_err"] = max(rec["max_abs_err"], e_abs)
                    print(f"[k5] {name} per-seed k={k} t={t} {what}: lse rel {e_lse:.2e}, "
                          f"mean rel {e_mean:.2e} (tol {TOL:g})", flush=True)
                    if not (e_lse <= TOL and e_mean <= TOL):
                        fail(f"{name} per-seed disagrees with its plain version at "
                             f"k={k} t={t} ({what})")
                # the excluded seed's rows: every logit excluded, state empty
                dead = slice((SEEDS - 1) * rps, SEEDS * rps)
                if not ((got[0][dead] <= fs.NEG_INF / 2).all() and (got[1][dead] == 0).all()):
                    fail(f"{name} per-seed: the all-excluded seed's rows are not empty")
                if t != 0.5:
                    continue
                diff = 0.0
                for s in range(SEEDS):
                    r = slice(s * rps, (s + 1) * rps)
                    one = fs.flash_score_update(
                        xq[r], qn[r], p, pn, ctr, w[s].contiguous(), at, bt,
                        empty_state(rps, c), precision=prec)
                    live = (one[0] > fs.NEG_INF / 2)
                    one_lse = torch.where(live, one[0] + torch.log(one[1]), 0.0)
                    got_lse = torch.where(live, got[0][r] + torch.log(got[1][r]), 0.0)
                    diff = max(diff, rel(got_lse, one_lse), rel(got[2][r], one[2]),
                               rel(got[1][r], one[1]))
                print(f"[k5] {name} per-seed k={k}: one K5 launch vs 8 one-seed 1-D "
                      f"launches, max rel difference {diff:.2e} (gate 1e-6)", flush=True)
                if diff > 1e-6:
                    fail(f"{name} per-seed differs from the one-seed launches at k={k}")
                ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
                plain_ms = cuda_ms(
                    lambda: fs.flash_score_update_plain(*args, empty_state(M, c), **kw), 3)
                one_d_ms = cuda_ms(lambda: fs.flash_score_update(
                    xq, qn, p, pn, ctr, w[0].contiguous(), at, bt, empty_state(M, c),
                    precision=prec), 5)

                def grouped():
                    for s in range(SEEDS):
                        r = slice(s * rps, (s + 1) * rps)
                        fs.flash_score_update(xq[r], qn[r], p, pn, ctr, w[s], at, bt,
                                              empty_state(rps, c), precision=prec)

                grouped_ms = cuda_ms(grouped, 3)
                b_ms, b_by = bound(M, P, g.d, c, prec, S=SEEDS)
                print(f"[k5] {name} per-seed k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
                      f"{b_ms / ms:.1%} of bound; 1-D kernel on the same inputs "
                      f"{one_d_ms:.3f} ms; grouped alternative (information): 8 "
                      f"launches at M={rps} {grouped_ms:.3f} ms", flush=True)
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k)
        del p, ctr, pn
    return recs


def phase_machine(tag, cls, precision, ds, n_bank, gen, ms_by_k):
    """One 20-step machine call at full width; the tier's kernel must carry
    every sweep (one launch per bank chunk per step), the other none."""
    kernel = fs.KERNEL_OF[precision]
    if n_bank < FULL_N:
        print(f"[{tag}] reduced: {n_bank} of {FULL_N} bank images (depth cut; "
              "widths, scales and seeds as published)", flush=True)
    mod = cls((ds.images[:n_bank], ds.labels[:n_bank]), batch_size=MODULE_BATCH,
              target_block=TARGET_BLOCK, precision=precision, device="cuda")
    machine = ScheduledScoreMachine(mod, in_channels=3, imsize=32,
                                    scales=CIFAR10_SCALES)
    x = torch.randn((SEEDS, 32, 32, 3), generator=gen, device="cuda")
    steps = range(len(CIFAR10_SCALES) - 1, 0, -1)
    nblk = [bank_geometry(n_bank, 32, 32, 3, CIFAR10_SCALES[i], TARGET_BLOCK).nblk
            for i in steps]
    expected = sum(nblk)
    kernel_s = sum(n * ms_by_k[CIFAR10_SCALES[i]] for n, i in zip(nblk, steps)) / 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = machine(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fs.flash_score_update.launches)
    banked = sorted(mod._bank_cache)
    streamed = sorted(set(CIFAR10_SCALES[1:]) - set(banked))
    print(f"[{tag}] {cls.__name__} precision={precision!r}: {len(steps)} steps, "
          f"N={n_bank}, b={SEEDS}: wall {wall:.2f} s (bank builds included), "
          f"{SEEDS / wall:.4f} images/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"[{tag}] banked k={banked} streamed k={streamed}; launches {launches} "
          f"({kernel}: sum of chunks over the steps {expected})", flush=True)
    print(f"[{tag}] {kernel} time at the phase-3 per-launch times: {kernel_s:.2f} s "
          f"({100 * kernel_s / wall:.1f}% of the wall)", flush=True)
    if launches[kernel] != expected:
        fail(f"{tag}: {launches[kernel]} {kernel} launches, expected {expected}")
    if any(n for name, n in launches.items() if name != kernel):
        fail(f"{tag}: another kernel than {kernel} ran: {launches}")
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail(f"{tag}: output is not a finite [8, 32, 32, 3] tensor")
    del mod, machine
    torch.cuda.empty_cache()
    return launches[kernel], wall


def expect_layout(out_dir, subs, n, tag):
    """`n` artifacts %04d.npy in each of `subs` under `out_dir`."""
    want = [f"{i:04d}.npy" for i in range(n)]
    for sub in subs:
        got = sorted(os.listdir(os.path.join(out_dir, sub)))
        if got != want:
            fail(f"{tag}: {out_dir}/{sub} holds {got}, expected {want}")


def phase_cond(ds, n_bank, main_wall):
    """The slice's path: conditional generation through
    pipeline.generate_els_samples, 8 seeds of 8 labels in one batch, with
    the CLI's default machine (20-step ELS at 'highest', built by
    cli.common.build_score_module). Every bank chunk of every step must be
    one K5 launch of K1 (per-seed weights), and no 1-D launch may run.
    Returns (launches by key, the module)."""
    if n_bank < FULL_N:
        print(f"[cond] reduced: {n_bank} of {FULL_N} bank images", flush=True)
    mod = build_score_module(
        "ELS", (ds.images[:n_bank], ds.labels[:n_bank]), batch_size=MODULE_BATCH,
        image_size=32, channels=3, schedule=cosine_noise_schedule,
        max_samples=100000, target_block=TARGET_BLOCK)
    machine = ScheduledScoreMachine(mod, in_channels=3, imsize=32,
                                    noise_schedule=cosine_noise_schedule,
                                    scales=CIFAR10_SCALES)
    out_dir = str(SCRATCH / "cond")
    steps = range(len(CIFAR10_SCALES) - 1, 0, -1)
    expected = sum(bank_geometry(n_bank, 32, 32, 3, CIFAR10_SCALES[i], TARGET_BLOCK).nblk
                   for i in steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    n = generate_els_samples(machine, out_dir, numiters=SEEDS, batch=SEEDS,
                             conditional=True, nlabels=10, force_overwrite=True,
                             log_fn=lambda s: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fs.flash_score_update.launches)
    key = "flash_score" + fs.PER_SEED
    labels = [int(load_array(os.path.join(out_dir, "labels", f"{i:04d}"))[0])
              for i in range(SEEDS)]
    print(f"[cond] pipeline.generate_els_samples, ELS 'highest', {len(steps)} steps, "
          f"N={n_bank}, {SEEDS} seeds, labels {labels}, one batch: wall {wall:.2f} s "
          f"(bank builds and artifact writes included), {SEEDS / wall:.4f} images/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{wall / main_wall:.3f}x the unconditional main phase's wall", flush=True)
    print(f"[cond] banked k={sorted(mod._bank_cache)}; launches {launches} ({key}: sum "
          f"of chunks over the steps {expected})", flush=True)
    if n != SEEDS:
        fail(f"cond: {n} samples generated, expected {SEEDS}")
    if launches[key] != expected:
        fail(f"cond: {launches[key]} {key} launches, expected {expected}")
    if any(v for k_, v in launches.items() if k_ != key):
        fail(f"cond: a 1-D or another kernel's launch ran: {launches}")
    expect_layout(out_dir, ("seeds", "els_outputs", "labels"), SEEDS, "cond")
    out = np.concatenate([load_array(os.path.join(out_dir, "els_outputs", f"{i:04d}"))
                          for i in range(SEEDS)])
    if out.shape != (SEEDS, 32, 32, 3) or not np.isfinite(out).all():
        fail("cond: the outputs are not finite [1, 32, 32, 3] arrays")
    return launches, mod


def phase_grouped(mod, gen):
    """Information: one ELS module call at k = 3 with 8 distinct labels, as
    one K5 sweep against seeds grouped by label (one scalar-label call,
    M = 1024, per seed)."""
    x = torch.randn((SEEDS, 32, 32, 3), generator=gen, device="cuda")
    labels = np.arange(SEEDS)
    nblk = bank_geometry(mod.images.shape[0], 32, 32, 3, 3, TARGET_BLOCK).nblk
    mod(0.5, x, label=labels, k=3)  # warm-up (the k = 3 bank is cached)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = mod(0.5, x, label=labels, k=3)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grouped = torch.cat([mod(0.5, x[i : i + 1], label=int(labels[i]), k=3)
                         for i in range(SEEDS)])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[grouped] ELS k=3 banked ({nblk} chunks), labels {labels.tolist()}: one K5 "
          f"sweep {t1 - t0:.3f} s ({nblk} launches at M={SEEDS * 1024}), grouped by "
          f"label {t2 - t1:.3f} s ({SEEDS * nblk} launches at M=1024), "
          f"{(t2 - t1) / (t1 - t0):.2f}x; rel difference {rel(one, grouped):.2e} "
          "(information)", flush=True)


def phase_cli():
    """The port's CLI on the card over the synthetic dataset (256 images)
    with the CIFAR10 scales: conditional ELS at 'high' (K2's per-seed
    count must rise), IS --fill over its seeds and labels, and conditional
    bbELS (grouped by label: 1-D K1 launches only)."""
    ck = SCRATCH / "checkpoints"
    ck.mkdir(parents=True, exist_ok=True)
    scales = ck / "scales_cifar10.json"
    scales.write_text(json.dumps(CIFAR10_SCALES))
    results = SCRATCH / "results"
    shutil.rmtree(results, ignore_errors=True)
    common = ["--dataset", "synthetic", "--scalesfile", str(scales),
              "--results", str(results), "--checkpoints", str(ck), "--conditional",
              "--batch", "4", "--numiters", "4"]
    runs = [
        ("ELS 'high'", ["--scoremoduletype", "ELS", "--precision", "high",
                        "--expname", "els"], "els", "els_outputs",
         "flash_score_bf16x3" + fs.PER_SEED),
        ("IS --fill", ["--scoremoduletype", "IS", "--idealname", "ideal", "--fill",
                       "--expname", "els"], "els", "ideal", None),
        ("bbELS", ["--scoremoduletype", "bbELS", "--expname", "bbels"], "bbels",
         "els_outputs", "flash_score"),
    ]
    launches = {}
    for what, extra, exp, sub, kernel in runs:
        reset_launches()
        t0 = time.perf_counter()
        n = cli_els.main(common + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(fs.flash_score_update.launches)
        print(f"[cli] cli.els {what}: {n} samples in {wall:.2f} s; launches {got}",
              flush=True)
        if n != 4:
            fail(f"cli {what}: {n} samples generated, expected 4")
        expect_layout(str(results / exp), ("seeds", "labels", sub), 4, f"cli {what}")
        out = load_array(str(results / exp / sub / "0003"))
        if out.shape != (1, 32, 32, 3) or not np.isfinite(out).all():
            fail(f"cli {what}: output 0003 is not a finite [1, 32, 32, 3] array")
        ran = {k_ for k_, v in got.items() if v}
        if ran != ({kernel} if kernel else set()):
            fail(f"cli {what}: expected launches of {kernel} only, got {got}")
        for k_, v in got.items():
            launches[k_] = launches.get(k_, 0) + v
    return launches


def phase_devices(seed):
    small = synthetic_dataset(num_samples=64, image_size=16, num_channels=3, seed=seed + 1)
    x = np.random.RandomState(seed).normal(size=(2, 16, 16, 3)).astype(np.float32)
    # bbELS: k = 17 >= the 16-pixel image runs the LS fallback; N is a
    # multiple of the batch, so its shuffled order cannot change the weights
    # conditional ELS: a 2-seed label vector, one K5 sweep per chunk
    vec = np.array([1, 3])
    els_scales = [3, 3, 3, 3, 5, 5, 5, 7, 7, 9]
    cases = [
        ("ELS 'highest'", LocalEquivScoreModule, "highest", els_scales, None),
        ("bbELS 'high'", LocalEquivBordersScoreModule, "high",
         [3, 3, 3, 5, 5, 7, 9, 11, 13, 17], None),
        ("conditional ELS 'highest'", LocalEquivScoreModule, "highest", els_scales, vec),
        ("conditional ELS 'high'", LocalEquivScoreModule, "high", els_scales, vec),
        ("IS", IdealScoreModule, "highest", els_scales, None),
    ]
    for what, cls, precision, scales, label in cases:
        outs = {}
        for dev in ("cuda", "cpu"):
            mod = cls((small.images, small.labels), batch_size=16,
                      precision=precision, device=dev)
            outs[dev] = ScheduledScoreMachine(mod, imsize=16, scales=scales)(
                x, label=label).cpu()
        e = rel(outs["cuda"], outs["cpu"])
        print(f"[devices] {what} 10-step machine, scales {scales}, N=64 16x16x3, "
              f"b=2{'' if label is None else f', labels {label.tolist()}'}: cuda vs "
              f"cpu rel {e:.2e} (tol {TOL:g})", flush=True)
        if not e <= TOL:
            fail(f"card and CPU disagree on the small {what} machine")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=FULL_N, help="bank images (depth)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    _, kind = phase_device()
    phase_build()
    ds = synthetic_dataset(num_samples=args.n, image_size=32, num_channels=3,
                           seed=args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    images_dev = torch.from_numpy(ds.images).cuda()
    recs, ms_center = phase_kernel(images_dev, args.n, gen)
    recs.update(phase_kernel_per_seed(
        images_dev, torch.from_numpy(ds.labels.astype(np.int64)).cuda(), args.n, gen))
    del images_dev
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    launches = {name: 0 for name in recs}
    walls = {}
    for tag, cls, precision, ms_by_k in (
        ("main", LocalEquivScoreModule, "highest", recs["flash_score"]["ms_by_k"]),
        ("bbels", LocalEquivBordersScoreModule, "high", ms_center),
        ("els_high", LocalEquivScoreModule, "high",
         recs["flash_score_bf16x3"]["ms_by_k"]),
    ):
        n, walls[tag] = phase_machine(tag, cls, precision, ds, args.n, gen, ms_by_k)
        launches[fs.KERNEL_OF[precision]] += n
        print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    got, mod = phase_cond(ds, args.n, walls["main"])
    phase_grouped(mod, gen)
    del mod
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    for key, n in phase_cli().items():
        got[key] += n
    for key in launches:
        launches[key] += got[key]
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_devices(args.seed)
    print(f"[time] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    if not all(launches.values()):
        fail(f"a kernel of the paths was never launched there: {launches}")
    print(json.dumps({"kernels": [
        kernel_record(name, rec, launches[name]) for name, rec in recs.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
