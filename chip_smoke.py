#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--n IMAGES] [--seed SEED]

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's view.
2. build   — compiles the flash-score kernel from the sources in this
             checkout (nvcc, sm_90a) and prints ptxas registers, shared
             memory and spills, and the build time.
3. kernel  — the kernel against its plain PyTorch version on the card at the
             main path's shapes: M = 8192 query rows (8 seeds x 32x32), one
             full CIFAR10 bank chunk, c = 3, k in {3, 9, 17},
             t in {0.05, 0.5, 0.95}; plus a two-call chain against one call
             and a carried state holding sentinel rows. Every chunk has
             zero-weight rows. Compared on m + log s1 and s2/s1 at
             max|a-b| / max(|a|,|b|,1) <= 1e-3. Per k: kernel, plain-version
             and bound times, and the fp32 Q.K^T product alone as a partial
             yardstick.
4. main    — one 20-step ScheduledScoreMachine(LocalEquivScoreModule) call,
             fp32 ('highest'), CIFAR10 scales, 8 seeds of 32x32x3, over N
             synthetic bank images (default 50000, the JAX bench's
             els_20step_50kbank workload; a smaller --n is printed as
             `reduced`). The kernel's launch count must equal the sum of
             bank chunks over the 19 steps; the output must be finite.
5. devices — the same machine at a small size on cuda and on cpu (plain
             version), compared at 1e-3 relative to scale.

The second-to-last line is the kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from convolutional_diffusion_tpu_torch.data import synthetic_dataset
from convolutional_diffusion_tpu_torch.ops import _build
from convolutional_diffusion_tpu_torch.ops import flash_score as fs
from convolutional_diffusion_tpu_torch.ops.patches import extract_patches, pad_image
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import (
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)
from convolutional_diffusion_tpu_torch.scores.bank import bank_geometry, chunk_patches

CIFAR10_SCALES = [3, 3, 3, 3, 5, 5, 5, 7, 7, 7, 7, 9, 9, 11, 11, 13, 15, 17, 17, 17]
FULL_N = 50000
SEEDS = 8
TARGET_BLOCK = 65536
MODULE_BATCH = 256  # the JAX bench's ELS module batch size
CHECKED_K = (3, 9, 17)  # kernel held against the plain version at these k
TOL = 1e-3
PEAK_FP32 = 67e12  # H100 SXM, fp32 outside the tensor cores (published)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (published)


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
    """(lse rel, mean rel, mean max abs) on the offset-invariant quantities."""
    lse = [s[0] + torch.log(s[1]) for s in (got, want)]
    mean = [s[2] / s[1][:, None] for s in (got, want)]
    return rel(*lse), rel(*mean), (mean[0] - mean[1]).abs().max().item()


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(M: int, P: int, d: int, c: int):
    """Least time on the card: the larger of operations over the fp32 peak
    (2 M P d for the dots + (6 + 2c) per pair for logit, max, exp2 and the
    sums) and bytes over the memory rate (each input read once, each output
    written once)."""
    ops = 2 * M * P * d + (6 + 2 * c) * M * P
    nbytes = 4 * (M * d + M + P * d + 2 * P + P * c + 2 * M * (2 + c))
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    built = _build.build("flash_score")
    for line in built.log.splitlines():
        if any(s in line for s in ("registers", "spill", "smem", "Compiling entry")):
            print(f"[build] {line.strip()}", flush=True)
    how = f"built in {built.seconds:.1f} s" if built.seconds else "reused an identical build"
    print(f"[build] flash_score.cu: {how}", flush=True)
    _build.load("flash_score")


def phase_kernel(images_dev, n_bank, gen):
    """Kernel vs plain at the main path's shapes for k in CHECKED_K; the
    kernel's time alone for the other k's of the schedule. Returns the JSON
    numbers (of the largest k) and the per-launch time of every k."""
    rec = {"max_abs_err": 0.0, "ms_by_k": {}}
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
            if not checked:
                ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c)), 5)
                rec["ms_by_k"][k] = ms
                print(f"[kernel] k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms", flush=True)
                continue
            got = fs.flash_score_update(*args, empty_state(M, c))
            want = fs.flash_score_update_plain(*args, empty_state(M, c))
            torch.cuda.synchronize()
            cases = {"one call": (got, want)}
            if t == 0.5:
                h = P // 2 + 37  # not a tile multiple
                half = fs.flash_score_update(xq, qn, p[:h], pn[:h], ctr[:h], w[:h],
                                             at, bt, empty_state(M, c))
                chained = fs.flash_score_update(xq, qn, p[h:], pn[h:], ctr[h:], w[h:],
                                                at, bt, half)
                cases["two calls vs one"] = (chained, got)
                st = tuple(s.clone() for s in want)
                st[0][::7], st[1][::7], st[2][::7] = fs.NEG_INF, 0.0, 0.0
                cases["sentinel rows in state"] = (
                    fs.flash_score_update(*args, st),
                    fs.flash_score_update_plain(*args, st))
            for what, (a, b) in cases.items():
                e_lse, e_mean, e_abs = compare(a, b)
                rec["max_abs_err"] = max(rec["max_abs_err"], e_abs)
                print(f"[kernel] k={k} t={t} {what}: lse rel {e_lse:.2e}, "
                      f"mean rel {e_mean:.2e} (tol {TOL:g})", flush=True)
                if not (e_lse <= TOL and e_mean <= TOL):
                    fail(f"kernel disagrees with plain version at k={k} t={t} ({what})")
            if t == 0.5:
                ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c)), 5)
                plain_ms = cuda_ms(
                    lambda: fs.flash_score_update_plain(*args, empty_state(M, c)), 3)
                prev = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
                try:
                    mm_ms = cuda_ms(lambda: torch.matmul(xq, p.T), 5)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = prev
                b_ms, b_by = bound(M, P, g.d, c)
                tflops = 2 * M * P * g.d / (ms * 1e-3) / 1e12
                print(f"[kernel] k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms "
                      f"({tflops:.1f} TFLOP/s on the dots), plain {plain_ms:.3f} ms, "
                      f"bound {b_ms:.3f} ms ({b_by}), fp32 matmul Q.K^T alone "
                      f"(partial yardstick) {mm_ms:.3f} ms", flush=True)
                rec["ms_by_k"][k] = ms
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k)
        del p, ctr, pn
    return rec


def phase_main(ds, n_bank, gen, ms_by_k):
    if n_bank < FULL_N:
        print(f"[main] reduced: {n_bank} of {FULL_N} bank images (depth cut; "
              "widths, scales and seeds as published)", flush=True)
    mod = LocalEquivScoreModule((ds.images[:n_bank], ds.labels[:n_bank]),
                                batch_size=MODULE_BATCH, target_block=TARGET_BLOCK,
                                precision="highest", device="cuda")
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
    fs.flash_score_update.launches = 0
    t0 = time.perf_counter()
    out = machine(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fs.flash_score_update.launches
    banked = sorted(mod._bank_cache)
    streamed = sorted(set(CIFAR10_SCALES[1:]) - set(banked))
    print(f"[main] {len(steps)} steps, N={n_bank}, b={SEEDS}: wall {wall:.2f} s "
          f"(bank builds included), {SEEDS / wall:.4f} images/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"[main] banked k={banked} streamed k={streamed}; kernel launches "
          f"{launches} (sum of chunks over the steps: {expected})", flush=True)
    print(f"[main] kernel time at the phase-3 per-launch times: {kernel_s:.2f} s "
          f"({100 * kernel_s / wall:.1f}% of the wall)", flush=True)
    if launches != expected:
        fail(f"main path made {launches} kernel launches, expected {expected}")
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail("main-path output is not a finite [8, 32, 32, 3] tensor")
    del mod, machine
    torch.cuda.empty_cache()
    return launches


def phase_devices(seed):
    small = synthetic_dataset(num_samples=64, image_size=16, num_channels=3, seed=seed + 1)
    scales = [3, 3, 3, 3, 5, 5, 5, 7, 7, 9]
    x = np.random.RandomState(seed).normal(size=(2, 16, 16, 3)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        mod = LocalEquivScoreModule((small.images, small.labels), batch_size=16,
                                    device=dev)
        outs[dev] = ScheduledScoreMachine(mod, imsize=16, scales=scales)(x).cpu()
    e = rel(outs["cuda"], outs["cpu"])
    print(f"[devices] 10-step machine, N=64 16x16x3, b=2: cuda vs cpu rel {e:.2e} "
          f"(tol {TOL:g})", flush=True)
    if not e <= TOL:
        fail("card and CPU disagree on the small machine")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=FULL_N, help="bank images (depth)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    _, name = phase_device()
    phase_build()
    ds = synthetic_dataset(num_samples=args.n, image_size=32, num_channels=3,
                           seed=args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    images_dev = torch.from_numpy(ds.images).cuda()
    rec = phase_kernel(images_dev, args.n, gen)
    del images_dev
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    launches = phase_main(ds, args.n, gen, rec["ms_by_k"])
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_devices(args.seed)
    print(f"[time] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_score_f32",
        "route": "cuda",
        "source": "convolutional_diffusion_tpu_torch/ops/csrc/flash_score.cu",
        "replaces": "convolutional_diffusion_tpu/ops/flash_score.py:113",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
