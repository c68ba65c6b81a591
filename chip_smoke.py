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
4. main     — one 20-step ScheduledScoreMachine(LocalEquivScoreModule) call,
              fp32 ('highest'), CIFAR10 scales, 8 seeds of 32x32x3, over N
              synthetic bank images (default 50000, the JAX bench's
              els_20step_50kbank workload; a smaller --n is printed as
              `reduced`). K1's launch count must equal the sum of bank
              chunks over the 19 steps, K2's must be 0; the output finite.
5. bbels    — the same for LocalEquivBordersScoreModule at 'high' (the JAX
              bench's bbels_20step_50kbank_images_per_sec_bf16x3): K2's
              launch count must equal the sum of center-bank chunks over the
              19 steps (banked or streamed), K1's must be 0.
6. els_high — the same for LocalEquivScoreModule at 'high' (the JAX bench's
              els_20step_50kbank_images_per_sec_bf16x3).
7. devices  — small machines on cuda and on cpu (plain versions), compared at
              1e-3 relative to scale: ELS at 'highest', and bbELS at 'high'
              with scales that reach k >= image size, so its LS fallback
              runs on the card too.

The second-to-last line is the kernels JSON record; the last line is
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
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)
from convolutional_diffusion_tpu_torch.scores.bank import bank_geometry, chunk_patches

CIFAR10_SCALES = [3, 3, 3, 3, 5, 5, 5, 7, 7, 7, 7, 9, 9, 11, 11, 13, 15, 17, 17, 17]
FULL_N = 50000
SEEDS = 8
TARGET_BLOCK = 65536
MODULE_BATCH = 256  # the JAX bench's ELS module batch size
CHECKED_K = (3, 9, 17)  # kernels held against the plain version at these k
TOL = 1e-3
PEAK_FP32 = 67e12  # H100 SXM, fp32 outside the tensor cores (published)
PEAK_BF16 = 989e12  # H100 SXM, dense bf16 on the tensor cores (published)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (published)
# the flash-score kernels (ops._build names), each with its precision tier
TIER_OF = {name: prec for prec, name in fs.KERNEL_OF.items()}
# kernel -> the TPU kernel variant it ports
REPLACES = {
    "flash_score": "convolutional_diffusion_tpu/ops/flash_score.py:113",
    "flash_score_bf16x3": "convolutional_diffusion_tpu/ops/flash_score.py:174",
}


def source(name: str) -> str:
    """Kernel `name`'s CUDA source, as a path in the repo."""
    src = _build.CSRC / _build.KERNELS[name][0]
    return str(src.relative_to(_build.CSRC.parents[2]))


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


def bound(M: int, P: int, d: int, c: int, precision: str):
    """Least time on the card: the larger of the operations over their
    peaks and the bytes over the memory rate (each input read once, each
    output written once). 'highest': 2 M P d for the fp32 dots plus
    (6 + 2c) per pair for logit, max, exp2 and the sums, all at the fp32
    peak. 'high': the three bf16 products, 3 * 2 M P d_pad (d padded to 16),
    at the bf16 tensor-core peak, against the per-pair work at the fp32
    peak (the two units run side by side)."""
    elem = (6 + 2 * c) * M * P
    if precision == "highest":
        t_ops = (2 * M * P * d + elem) / PEAK_FP32 * 1e3
    else:
        d_pad = -(-d // 16) * 16
        t_ops = max(3 * 2 * M * P * d_pad / PEAK_BF16, elem / PEAK_FP32) * 1e3
    nbytes = 4 * (M * d + M + P * d + 2 * P + P * c + 2 * M * (2 + c))
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
    return launches[kernel]


def phase_devices(seed):
    small = synthetic_dataset(num_samples=64, image_size=16, num_channels=3, seed=seed + 1)
    x = np.random.RandomState(seed).normal(size=(2, 16, 16, 3)).astype(np.float32)
    # bbELS: k = 17 >= the 16-pixel image runs the LS fallback; N is a
    # multiple of the batch, so its shuffled order cannot change the weights
    cases = [
        ("ELS 'highest'", LocalEquivScoreModule, "highest",
         [3, 3, 3, 3, 5, 5, 5, 7, 7, 9]),
        ("bbELS 'high'", LocalEquivBordersScoreModule, "high",
         [3, 3, 3, 5, 5, 7, 9, 11, 13, 17]),
    ]
    for what, cls, precision, scales in cases:
        outs = {}
        for dev in ("cuda", "cpu"):
            mod = cls((small.images, small.labels), batch_size=16,
                      precision=precision, device=dev)
            outs[dev] = ScheduledScoreMachine(mod, imsize=16, scales=scales)(x).cpu()
        e = rel(outs["cuda"], outs["cpu"])
        print(f"[devices] {what} 10-step machine, scales {scales}, N=64 16x16x3, "
              f"b=2: cuda vs cpu rel {e:.2e} (tol {TOL:g})", flush=True)
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
    del images_dev
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    launches = {}
    for tag, cls, precision, ms_by_k in (
        ("main", LocalEquivScoreModule, "highest", recs["flash_score"]["ms_by_k"]),
        ("bbels", LocalEquivBordersScoreModule, "high", ms_center),
        ("els_high", LocalEquivScoreModule, "high",
         recs["flash_score_bf16x3"]["ms_by_k"]),
    ):
        kernel = fs.KERNEL_OF[precision]
        launches[kernel] = launches.get(kernel, 0) + phase_machine(
            tag, cls, precision, ds, args.n, gen, ms_by_k)
        print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_devices(args.seed)
    print(f"[time] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [{
        "name": _build.KERNELS[name][1],  # the kernel's C symbol
        "route": "cuda",
        "source": source(name),
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": recs[name]["max_abs_err"],
        "ms": recs[name]["ms"],
        "plain_ms": recs[name]["plain_ms"],
        "bound_ms": recs[name]["bound_ms"],
        "bound_by": recs[name]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    } for name in TIER_OF]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
