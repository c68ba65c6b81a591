#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--n IMAGES] [--seed SEED]

Phases, each printing its own lines; any failure exits non-zero:

1. device   — the card's name and power limit (nvidia-smi), torch's view, and
              the SFU's exp2 rate (16 per clock per SM x SMs x max SM clock).
2. build    — compiles the three flash-score kernels from the sources in this
              checkout (one nvcc per source, started together, sm_90a) and
              prints ptxas registers, shared memory and spills, and the
              build times.
3. kernel   — each kernel against its plain PyTorch version on the card at
              the main path's shapes: M = 8192 query rows (8 seeds x 32x32),
              one full CIFAR10 bank chunk, c = 3: K1 ('highest', fp32) and
              K2 ('high', bf16x3 on the tensor cores) at k in {3, 9, 17},
              the 'default' kernel (K3/K4: bf16 exp) in 'inbank' at k = 3, 5
              and 'vpu' at k = 3, 9, 17; t in {0.05, 0.5, 0.95}; the
              tensor-core tiers also at the bbELS center's shape (its valid
              windows, M = 8 (33 - k)^2, 7200 at k = 3: a partial last
              block); plus a two-call chain (against one call; at 'default',
              whose result depends on where m is re-based, against the plain
              version's chain) and a carried state holding sentinel rows.
              Every chunk has zero-weight rows. Compared on m + log s1 and
              s2/s1 at max|a-b| / max(|a|,|b|,1) <= 1e-3. The tensor-core
              tiers' one call is also held against the plain version over
              the exact float64 sum of the bf16x3 split, apart from the
              card's step-by-step rounding: 'default' gated at the tier's
              4e-3, K2 printed (also in phases mxu1 and k5; the worst per
              variant prints after k5). For every k of
              the schedule: each kernel's time in the variant the ELS module
              takes there, its plain version's time and its bound, and the
              tensor-core tiers' time at the bbELS center's query count.
              Tier gaps are printed as information only. Then 'mxu1' once,
              where 'auto' takes it: k = 9, one call over 5 chunks (P >= 2^18).
4. k5       — per-seed weights, kernel variant K5, in every kernel (at
              'default' in the ELS module's variant: 'inbank' at k = 3):
              M = 8192 (8 seeds x 1024 rows) against one full CIFAR10
              chunk, w [8, P] from label-filtered image weights (one class
              per seed, one seed of a class with no image in the chunk),
              k in {3, 9, 17}, t in {0.05, 0.5, 0.95}, against
              the plain version at 1e-3; at t = 0.5 also chained, with
              sentinel rows, at rows_per_seed = 784 (a partial last block per
              seed), and against 8 one-seed 1-D launches (gate 1e-6); K5's
              time against the 1-D kernel's on the same inputs, and the
              grouped alternative's (8 launches at M = 1024, information).
   prune    — the prune skip bit, kernel variant K6, in K1, K2 and the
              'default' kernel (in the variant the ELS module takes at k):
              one full CIFAR10 chunk clustered by the port's k-means
              (`build_clustered_bank`), M = 8192, k in {3, 9, 17}, t in
              {0.05, 0.5, 0.95}. (a) Sound masks from `sweep_masks`: the
              skip fraction; kernel + mask against plain + mask at 1e-3 and
              against the unmasked kernel at 1e-5. (b) At t = 0.5 a forced
              mask (every other stats block, the first and the last, all
              blocks of two query blocks) over a carried state with
              sentinel rows: against plain + mask at 1e-3, and the kernel's
              state of the all-skipped query blocks bit-equal to its input.
              (c) The clustered stress problem (8 tight clusters, M = 8192,
              P = 65536, d = 27, a_t = 0.99, b_t = 0.08): more than 50%
              skipped, both gates; masked against unmasked ms beside
              1 - skip. Times at t = 0.05 with the bound of the unskipped
              work (`bound()` x (1 - skip)).
5. machines — one 20-step ScheduledScoreMachine call each, CIFAR10 scales,
              8 seeds of 32x32x3 (the same seeds for all), over N synthetic
              bank images (default 50000; a smaller --n is printed as
              `reduced`): main = ELS 'highest' (the JAX bench's
              els_20step_50kbank fp32 key), bbels = bbELS 'high', els_high =
              ELS 'high', els_default = ELS 'default' (the JAX bench's
              els_20step_50kbank_images_per_sec_fast), bbels_default = bbELS
              'default', els_prune = ELS 'highest' with prune=True (clustered
              cached banks, K6 masks). Each kernel variant's launch count
              must equal the sum of bank chunks over the steps where the
              ELS rule takes it (at 'default': 'inbank' at k <= 5, 'vpu'
              above; els_prune: '/prune' at the k's the 48 GiB ledger
              caches, 17 and 3), and nothing else may run; the output
              finite. els_prune also prints each clustered build's parts
              and peak memory (which must stay under the card, within one
              bank plus 4 GB above what was held before: no second copy),
              each step's skip fraction and mask-building ms, and
              its output's distance to main's; its gate is one k = 3,
              t = 0.05 call against the same clustered bank unmasked, at
              1e-5. The 'default' outputs are compared with the 'high' ones
              (information).
6. mxu1     — one ELS 'default' module call at k = 9 with a target block
              of 2^19 patches: every sweep must be one 'mxu1' launch.
7. cond     — conditional generation through pipeline.generate_els_samples:
              the CLI's default machine (cli.common.build_score_module
              ("ELS"), 20 steps, 'highest'), 8 seeds of 8 labels in one
              batch over the N bank images. K1's per-seed launch count must
              equal the sum of bank chunks over the 19 steps and no 1-D
              launch may run; the seeds, labels and outputs must be written
              in the artifact layout, finite. Then, as information, one
              module call at k = 3 as one K5 sweep against the seeds grouped
              by label.
8. cli      — cli.els.main on the card over --dataset synthetic (256
              images) with the CIFAR10 scales: conditional ELS at 'high'
              (K2's per-seed count must rise), IS --fill, conditional bbELS
              (grouped by label), and with --precision default conditional
              ELS (per-seed 'inbank' and 'vpu' launches) and conditional
              bbELS; the layout checked after each.
9. devices  — small machines on cuda and on cpu (plain versions), compared at
              1e-3 relative to scale: ELS at 'highest', bbELS at 'high' with
              scales that reach k >= image size (its LS fallback), ELS with
              a 2-seed label vector at 'highest' and 'high', IS, and at
              'default' ELS banked and streamed, bbELS and ELS with the
              label vector (a 'default' case past 1e-3 is held at 2.5e-3,
              with the reason printed, and its gap to the CPU's 'high'
              machine prints beside it); ELS prune=True at 'highest' and
              'high' over prototype images (a few flat colours plus small
              noise, where the masks skip: the skip fraction must be above
              0 on both devices), and one label-vector call on the
              clustered bank (K5, unmasked).

Artifacts of phases 7 and 8 go to build/chip_smoke/ (git-ignored). The
card's name and power limit print as the first line, the kernels JSON
record as the second-to-last, and {"ok": true, "device": {...}} as the
last. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import itertools
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
from convolutional_diffusion_tpu_torch.ops import prune as pr
from convolutional_diffusion_tpu_torch.ops.fp32 import true_fp32
from convolutional_diffusion_tpu_torch.ops.patches import (
    center_index,
    extract_patches,
    pad_image,
)
from convolutional_diffusion_tpu_torch.pipeline import generate_els_samples, load_array
from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
from convolutional_diffusion_tpu_torch.scores import (
    IdealScoreModule,
    LocalEquivBordersScoreModule,
    LocalEquivScoreModule,
    ScheduledScoreMachine,
)
from convolutional_diffusion_tpu_torch.scores import els as tels
from convolutional_diffusion_tpu_torch.scores.bank import (
    bank_cache_nbytes,
    bank_geometry,
    build_clustered_bank,
    chunk_patches,
)
from convolutional_diffusion_tpu_torch.scores.common import (
    CutoffRule,
    Weighting,
    image_weights,
)
from convolutional_diffusion_tpu_torch.scores.els import _value_kw as els_value_kw

CIFAR10_SCALES = [3, 3, 3, 3, 5, 5, 5, 7, 7, 7, 7, 9, 9, 11, 11, 13, 15, 17, 17, 17]
FULL_N = 50000
SEEDS = 8
TARGET_BLOCK = 65536
MODULE_BATCH = 256  # the JAX bench's ELS module batch size
CHECKED_K = (3, 9, 17)  # kernels held against the plain version at these k
TOL = 1e-3
DEFAULT_TOL = 4e-3  # the 'default' tier's own (tests/test_flash_score.py:407)
# card vs CPU on the small 'default' machines: above the readings (up to
# 1.81e-3 on an H100), below the upper range of one sweep's gap between the
# 'default' and 'high' tiers (6.7e-4 to 3.7e-3); the gap on the same machine
# prints beside it
DEVICES_DEFAULT_TOL = 2.5e-3
# artifacts of the pipeline and CLI phases (git-ignored build/ of the checkout)
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
PEAK_FP32 = 67e12  # H100 SXM, fp32 outside the tensor cores (published)
PEAK_BF16 = 989e12  # H100 SXM, dense bf16 on the tensor cores (published)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (published)
SFU_PER_CLOCK = 16  # exp2 per clock per SM on sm_90 (the SFU, MUFU.EX2)
SFU_RATE = None  # exp2/s of this card: SFU_PER_CLOCK x SMs x max SM clock (phase_device)
# the flash-score kernels (ops._build names), each with its precision tier
TIER_OF = {name: prec for prec, name in fs.KERNEL_OF.items()}
FAST = fs.KERNEL_OF["default"]
# launch-count key -> the TPU kernel variant it ports
_TPU = "convolutional_diffusion_tpu/ops/flash_score.py:"
REPLACES = {
    "flash_score": _TPU + "113",
    "flash_score_bf16x3": _TPU + "174",
    FAST: _TPU + "215",
    FAST + "/inbank": _TPU + "240",
    FAST + "/mxu1": _TPU + "225",
    **{name + fs.PER_SEED: _TPU + "399"
       for name in ("flash_score", "flash_score_bf16x3", FAST, FAST + "/inbank")},
    # K6, `_kernel`'s prune branch; the 'default' kernel's K6 is checked in
    # phase prune but reached by no path (the ELS gate keeps 'default'
    # unmasked), so it has no entry in the kernels line
    **{name + fs.PRUNE: _TPU + "122" for name in ("flash_score", "flash_score_bf16x3")},
}
PRUNE_T = (0.05, 0.5, 0.95)  # t of phase prune; times at the first
STRESS_AT_BT = (0.99, 0.08)  # the stress problem's low-noise step
# a clustered build may hold one bank plus this much (k-means sample and
# distance blocks, the sort's ids): a second copy of the bank would not fit
BUILD_TRANSIENT = 4e9


def source(name: str) -> str:
    """Kernel `name`'s CUDA source, as a path in the repo."""
    src = _build.CSRC / _build.KERNELS[name][0]
    return str(src.relative_to(_build.CSRC.parents[2]))


def value_kw(precision: str, k: int, c: int = 3) -> dict:
    """The value-strategy keywords the ELS module's sweeps take at k."""
    return els_value_kw(precision, k * k * c, center_index(k, c).start, c)


def launch_key(precision: str, k: int, per_seed: bool = False,
               prune: bool = False) -> str:
    """The launch-count key of a module sweep at k (kernel, strategy,
    per-seed or prune suffix)."""
    strategy = value_kw(precision, k).get("v_strategy", "vpu")
    return (fs.KERNEL_OF[precision] + fs.STRATEGY_SUFFIX[strategy]
            + (fs.PER_SEED if per_seed else fs.PRUNE if prune else ""))


def kernel_record(name: str, rec: dict, launches: int) -> dict:
    """The kernels-line entry of launch-count key `name` (a kernel of
    ops._build, then its value strategy and fs.PER_SEED where they apply)."""
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


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """ms per call of fn over reps calls, after one warm-up call if warm."""
    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_time(precision: str, fn) -> float:
    """ms per call of a plain version: 3 calls after a warm-up at
    'highest'; one call at the tensor-core tiers, whose plain versions
    repeat the kernel's dot step by step in float64 (up to ~2.6 s a call
    at k = 17) and have no warm-up to do."""
    if precision == "highest":
        return cuda_ms(fn, 3)
    return cuda_ms(fn, 1, warm=False)


def bound(M: int, P: int, d: int, c: int, precision: str, S: int = 1,
          strategy: str = "vpu"):
    """Least time on the card: the larger of the operations over their
    peaks and the bytes over the memory rate (each input read once, each
    output written once). Three units run side by side, and the busiest
    sets the bound: the fp32 pipe, the tensor cores and the SFU, which
    takes one exponential per pair (M P exp2 at SFU_RATE). Only the work the
    function needs is counted, never the padding a kernel's tiles add.
    'highest': 2 M P d for the fp32 dots plus (6 + 2c) per pair for logit,
    max, exp2 and the sums at the fp32 peak. 'high': the three bf16
    products, 3 * 2 M P d, at the bf16 tensor-core peak, and the per-pair
    work at the fp32 peak. 'default': as 'high', plus the ln 2 multiply per
    pair; 'mxu1' and 'inbank' move s1 and s2 to the tensor cores (the
    product e @ [V | 1], 2 M P (c + 1)) and read no values ('inbank').
    Per-seed weights (K5, S seeds) change only the weight bytes, S * P
    instead of P."""
    elem = (6 + 2 * c) * M * P
    t_sfu = M * P / SFU_RATE * 1e3
    if precision == "highest":
        t_ops = max((2 * M * P * d + elem) / PEAK_FP32 * 1e3, t_sfu)
    else:
        tc = 3 * 2 * M * P * d
        if precision == "default":
            elem += M * P
            if strategy != "vpu":
                elem -= (1 + 2 * c) * M * P
                tc += 2 * M * P * (c + 1)
        t_ops = max(tc / PEAK_BF16 * 1e3, elem / PEAK_FP32 * 1e3, t_sfu)
    values = 0 if strategy == "inbank" else P * c
    nbytes = 4 * (M * d + M + P * d + P + S * P + values + 2 * M * (2 + c))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def reset_launches():
    for name in fs.flash_score_update.launches:
        fs.flash_score_update.launches[name] = 0


def empty_state(M, c):
    return (torch.full((M,), fs.NEG_INF, device="cuda"),
            torch.zeros(M, device="cuda"), torch.zeros(M, c, device="cuda"))


def phase_device():
    global SFU_RATE
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)  # name, power limit: as nvidia-smi gives them
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_RATE = SFU_PER_CLOCK * sms * float(clock) * 1e6
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}, {torch.cuda.device_count()} device(s), {sms} SMs, max SM clock "
          f"{clock} MHz: SFU {SFU_RATE / 1e12:.3f} T exp2/s", flush=True)
    return smi[0], name


def phase_build():
    for name, built in _build.build_all(list(TIER_OF)).items():
        regs, spills = [], 0
        for line in built.log.splitlines():
            if any(t in line for t in ("registers", "spill", "smem", "Compiling entry")):
                print(f"[build] {name}: {line.strip()}", flush=True)
            words = line.split()
            if "registers," in words:
                regs.append(int(words[words.index("registers,") - 1]))
            if "spill" in words and "stores," in words:
                spills += int(words[words.index("spill") - 2])
        how = f"built in {built.seconds:.1f} s" if built.seconds else "reused an identical build"
        regs = f"{min(regs)}-{max(regs)}" if regs else "not in the log"
        print(f"[build] {source(name)}: {how}; registers {regs}, "
              f"spill stores {spills} bytes", flush=True)
        _build.load(name)


def check_cases(tag, name, k, t, cases, rec, tol=TOL):
    """Gate each (kernel, plain) pair of `cases` at `tol`; fold the worst
    mean error into `rec`."""
    for what, (a, b) in cases.items():
        e_lse, e_mean, e_abs = compare(a, b)
        rec["max_abs_err"] = max(rec["max_abs_err"], e_abs)
        print(f"[{tag}] {name} k={k} t={t} {what}: lse rel {e_lse:.2e}, "
              f"mean rel {e_mean:.2e} (tol {tol:g})", flush=True)
        if not (e_lse <= tol and e_mean <= tol):
            fail(f"{name} disagrees with its plain version at k={k} t={t} ({what})")


def exact_split_dot(qh64, ql64, kh, kl) -> torch.Tensor:
    """The bf16x3 split dot qh.kh + qh.kl + ql.kh summed exactly (float64),
    rounded once to float32."""
    kh64 = kh.double()
    return (qh64 @ kh64.T + qh64 @ kl.double().T + ql64 @ kh64.T).float()


def plain_exact(*args, **kw):
    """`fs.flash_score_update_plain` over the exact split sum: the TPU
    kernel's dot as the JAX package states it, independent of how the
    tensor cores accumulate. The plain version proper (`fs._split_dot`)
    repeats the card's step-by-step rounding; this one stands apart from
    it."""
    step = fs._split_dot
    fs._split_dot = exact_split_dot
    try:
        return fs.flash_score_update_plain(*args, **kw)
    finally:
        fs._split_dot = step


EXACT_WORST = {}  # launch key -> worst rel of the kernel vs plain_exact


def check_exact(tag, key, k, t, got, args, state, kw):
    """A tensor-core kernel's call against `plain_exact` on the same inputs:
    the 'default' kernel gated at the tier's DEFAULT_TOL, K2 printed as
    information (its gate is the plain version's 1e-3). The worst reading
    per launch key goes to EXACT_WORST."""
    gated = kw["precision"] == "default"
    want = plain_exact(*args, state, **kw)
    e_lse, e_mean, _ = compare(got, want)
    EXACT_WORST[key] = max(EXACT_WORST.get(key, 0.0), e_lse, e_mean)
    print(f"[{tag}] {key} k={k} t={t} vs the exact split sum (float64): lse rel "
          f"{e_lse:.2e}, mean rel {e_mean:.2e} "
          f"({f'tol {DEFAULT_TOL:g}' if gated else 'information'})", flush=True)
    if gated and not (e_lse <= DEFAULT_TOL and e_mean <= DEFAULT_TOL):
        fail(f"{key} is past the tier's {DEFAULT_TOL:g} from the exact split sum "
             f"at k={k} t={t}")


# 'default' variants held against the plain version, by k: 'inbank' where
# the ELS rule takes it (k <= 5 on RGB), 'vpu' also at k = 3
FAST_CHECKED = {3: ("inbank", "vpu"), 5: ("inbank",), 9: ("vpu",), 17: ("vpu",)}


def phase_kernel(images_dev, n_bank, gen):
    """Each kernel against its plain version at the main path's shapes (K1,
    K2 at k in CHECKED_K; the 'default' kernel at FAST_CHECKED), also at
    the bbELS center's shape (M = 8 (33 - k)^2) for the tensor-core tiers;
    for every k of the schedule each kernel's time in the variant the ELS
    module takes there, its plain version's time and its bound, and the
    tensor-core tiers' time at the bbELS center's shape. Returns the JSON
    numbers by launch-count key (of the largest k where the variant runs),
    and per kernel the per-launch times by k at M = 8192 and at the bbELS
    center's M."""
    recs = {}
    ms_by_k = {name: {} for name in TIER_OF}
    ms_center = {name: {} for name in TIER_OF}
    for k in sorted(set(CIFAR10_SCALES)):
        g = bank_geometry(n_bank, 32, 32, 3, k, TARGET_BLOCK)
        imgs = images_dev[: g.cs]
        p, ctr, pn = chunk_patches(imgs, k)
        w_img = torch.full((g.cs,), 1.0 / (MODULE_BATCH * g.per_img), device="cuda")
        w_img[-max(1, g.cs // 8):] = 0.0  # zero-weight rows, as chunk padding has
        w = w_img.repeat_interleave(g.per_img)
        M, P, c = SEEDS * 32 * 32, p.shape[0], 3
        variants = {name: [value_kw(prec, k)] for name, prec in TIER_OF.items()}
        for strategy in FAST_CHECKED.get(k, ()):
            if strategy not in [v.get("v_strategy", "vpu") for v in variants[FAST]]:
                variants[FAST].append({} if strategy == "vpu" else value_kw("default", k))
        checked = {name: k in CHECKED_K for name in TIER_OF}
        checked[FAST] = k in FAST_CHECKED
        for t in (0.05, 0.5, 0.95) if any(checked.values()) else (0.5,):
            beta = cosine_noise_schedule(t)
            at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
            x = at.item() * imgs[:SEEDS] + bt.item() * torch.randn(
                imgs[:SEEDS].shape, generator=gen, device="cuda")
            xq = extract_patches(pad_image(x, k // 2, "circular"), k).reshape(M, g.d)
            qn = (xq * xq).sum(-1)
            # the bbELS center's queries: the valid windows, no padding
            xc = extract_patches(x, k).reshape(-1, g.d).contiguous()
            mc = xc.shape[0]
            outs = {}
            for name, prec in TIER_OF.items():
                for vkw in variants[name]:
                    strategy = vkw.get("v_strategy", "vpu")
                    key = name + fs.STRATEGY_SUFFIX[strategy]
                    rec = recs.setdefault(key, {"max_abs_err": 0.0})
                    vals = None if strategy == "inbank" else ctr
                    args = (xq, qn, p, pn, vals, w, at, bt)
                    cargs = (xc, (xc * xc).sum(-1), *args[2:])
                    kw = dict(precision=prec, **vkw)
                    if checked[name]:
                        got = fs.flash_score_update(*args, empty_state(M, c), **kw)
                        want = fs.flash_score_update_plain(*args, empty_state(M, c), **kw)
                        torch.cuda.synchronize()
                        outs[key] = got
                        if prec != "highest":
                            check_exact("kernel", key, k, t, got, args, empty_state(M, c), kw)
                        cases = {"one call": (got, want)}
                        if prec != "highest":
                            cases[f"bbELS center M={mc}"] = (
                                fs.flash_score_update(*cargs, empty_state(mc, c), **kw),
                                fs.flash_score_update_plain(*cargs, empty_state(mc, c), **kw))
                        if t == 0.5:
                            h = P // 2 + 37  # not a tile multiple
                            v = (lambda a, b: None) if vals is None else (lambda a, b: vals[a:b])
                            chain = []
                            for fn in (fs.flash_score_update, fs.flash_score_update_plain):
                                half = fn(xq, qn, p[:h], pn[:h], v(0, h), w[:h], at, bt,
                                          empty_state(M, c), **kw)
                                chain.append(fn(xq, qn, p[h:], pn[h:], v(h, P), w[h:], at,
                                                bt, half, **kw))
                            if prec == "default":
                                # one call re-bases m at other rows than two
                                cases["two calls, kernel vs plain"] = tuple(chain)
                            else:
                                cases["two calls vs one"] = (chain[0], got)
                            st = tuple(s_.clone() for s_ in want)
                            st[0][::7], st[1][::7], st[2][::7] = fs.NEG_INF, 0.0, 0.0
                            cases["sentinel rows in state"] = (
                                fs.flash_score_update(*args, st, **kw),
                                fs.flash_score_update_plain(*args, st, **kw))
                        check_cases("kernel", key, k, t, cases, rec)
                    if t != 0.5 or vkw != variants[name][0]:
                        continue
                    # timing: the variant the ELS module takes at this k
                    ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
                    plain_ms = plain_time(
                        prec, lambda: fs.flash_score_update_plain(*args, empty_state(M, c), **kw))
                    b_ms, b_by = bound(M, P, g.d, c, prec, strategy=strategy)
                    line = (f"[kernel] {key} k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, "
                            f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
                            f"{b_ms / ms:.1%} of bound")
                    if prec == "highest":
                        with true_fp32():
                            mm_ms = cuda_ms(lambda: torch.matmul(xq, p.T), 5)
                        line += f", fp32 matmul Q.K^T alone (partial yardstick) {mm_ms:.3f} ms"
                    else:
                        ms_center[name][k] = cuda_ms(
                            lambda: fs.flash_score_update(*cargs, empty_state(mc, c), **kw), 5)
                        line += f"; at the bbELS center's M={mc}: {ms_center[name][k]:.3f} ms"
                    if prec == "default":
                        k2 = ms_by_k["flash_score_bf16x3"][k]
                        line += (f"; K2 on the same inputs (information) {k2:.3f} ms, "
                                 f"{ms / k2:.3f}x")
                    print(line, flush=True)
                    ms_by_k[name][k] = ms
                    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k)
            if "flash_score" in outs:  # k in CHECKED_K
                e_lse, e_mean, _ = compare(outs["flash_score_bf16x3"], outs["flash_score"])
                print(f"[kernel] tier gap k={k} t={t}, K2 'high' vs K1 'highest' "
                      f"(information, not a gate): lse rel {e_lse:.2e}, mean rel "
                      f"{e_mean:.2e}", flush=True)
                fast = outs.get(launch_key("default", k))
                if fast is not None:
                    e_lse, e_mean, _ = compare(fast, outs["flash_score_bf16x3"])
                    print(f"[kernel] tier gap k={k} t={t}, 'default' vs K2 'high' "
                          f"(information, not a gate): lse rel {e_lse:.2e}, mean rel "
                          f"{e_mean:.2e}", flush=True)
        del p, ctr, pn
    return recs, ms_by_k, ms_center


def phase_mxu1_kernel(images_dev, n_bank, gen, recs):
    """'mxu1' (variant K3's e @ [V | 1]) against its plain version where
    'auto' takes it: one sweep over P >= 2^18 bank rows, five CIFAR10
    chunks at k = 9 (four are 260352 rows, under 2^18), M = 8192, zero-weight
    rows, t = 0.5; its time, plain time and bound."""
    k, t = 9, 0.5
    g = bank_geometry(n_bank, 32, 32, 3, k, TARGET_BLOCK)
    imgs = images_dev[: 5 * g.cs]
    p, ctr, pn = chunk_patches(imgs, k)
    w_img = torch.full((imgs.shape[0],), 1.0 / (MODULE_BATCH * g.per_img), device="cuda")
    w_img[::9] = 0.0
    w = w_img.repeat_interleave(g.per_img)
    M, P, c = SEEDS * 32 * 32, p.shape[0], 3
    beta = cosine_noise_schedule(t)
    at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
    x = at.item() * imgs[:SEEDS] + bt.item() * torch.randn(
        imgs[:SEEDS].shape, generator=gen, device="cuda")
    xq = extract_patches(pad_image(x, k // 2, "circular"), k).reshape(M, g.d)
    args = (xq, (xq * xq).sum(-1), p, pn, ctr, w, at, bt)
    key = FAST + "/mxu1"
    rec = recs.setdefault(key, {"max_abs_err": 0.0})
    before = fs.flash_score_update.launches[key]
    got = fs.flash_score_update(*args, empty_state(M, c), precision="default")
    torch.cuda.synchronize()
    if fs.flash_score_update.launches[key] != before + 1:
        fail(f"'auto' did not take 'mxu1' over P={P} bank rows")
    want = fs.flash_score_update_plain(*args, empty_state(M, c), precision="default")
    check_cases("mxu1", key, k, t, {f"one call over P={P}": (got, want)}, rec)
    check_exact("mxu1", key, k, t, got, args, empty_state(M, c), dict(precision="default"))
    ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), precision="default"), 5)
    plain_ms = plain_time(
        "default", lambda: fs.flash_score_update_plain(*args, empty_state(M, c),
                                                       precision="default"))
    vpu_ms = cuda_ms(lambda: fs.flash_score_update(
        *args, empty_state(M, c), precision="default", v_strategy="vpu"), 5)
    b_ms, b_by = bound(M, P, g.d, c, "default", strategy="mxu1")
    print(f"[mxu1] {key} k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound; "
          f"'vpu' on the same inputs (information) {vpu_ms:.3f} ms", flush=True)
    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k)


def per_seed_weights(labels, lab_of_seed, g):
    """[S, P] per-seed patch weights of one chunk: each seed's label-filtered
    image weights (the ELS module's rule) repeated over the image's
    patches."""
    rows = [image_weights(labels, lab, batch_size=MODULE_BATCH, max_samples=None,
                          cutoff=CutoffRule.UNFILTERED, weighting=Weighting.MEAN,
                          per_image_bank=g.per_img) for lab in lab_of_seed]
    return torch.stack(rows).repeat_interleave(g.per_img, dim=1).contiguous()


def phase_kernel_per_seed(images_dev, labels_dev, n_bank, gen):
    """K5, per-seed weights, in every kernel at the conditional path's
    shapes, in the variant the ELS module takes at each k ('inbank' at
    k = 3 at 'default'): M = 8192 query rows (8 seeds x 1024),
    rows_per_seed 1024, one full CIFAR10 chunk, w [8, P] from label-filtered
    image weights, one class per seed and one seed of a class with no image
    in the chunk (its whole bias row excluded), at k in CHECKED_K and t in
    {0.05, 0.5, 0.95}, against the plain version; at t = 0.5 also a two-call
    chain (against one call, or at 'default' against the plain version's
    chain), sentinel rows in the carried state, rows_per_seed = 784 (a
    partial last block per seed), and one K5 launch against the 8 one-seed
    1-D launches on each seed's rows (gated at 1e-6). Times at t = 0.5: K5,
    the plain version, the bound, the 1-D kernel on the same inputs with
    seed 0's weights, and (information) the grouped alternative, 8 launches
    at M = 1024. Returns per K5 variant the JSON numbers (of the largest
    k)."""
    recs = {}
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
            for name, prec in TIER_OF.items():
                vkw = value_kw(prec, k)
                key = launch_key(prec, k, per_seed=True)
                vals = None if vkw else ctr
                v = (lambda a, b: None) if vals is None else (lambda a, b: vals[a:b])
                args = (xq, qn, p, pn, vals, w, at, bt)
                rec = recs.setdefault(key, {"max_abs_err": 0.0})
                kw = dict(precision=prec, rows_per_seed=rps, **vkw)
                got = fs.flash_score_update(*args, empty_state(M, c), **kw)
                want = fs.flash_score_update_plain(*args, empty_state(M, c), **kw)
                torch.cuda.synchronize()
                if prec != "highest":
                    check_exact("k5", key, k, t, got, args, empty_state(M, c), kw)
                cases = {"one call": (got, want)}
                if t == 0.5:
                    h = P // 2 + 37  # not a tile multiple
                    chain = []
                    for fn in (fs.flash_score_update, fs.flash_score_update_plain):
                        half = fn(xq, qn, p[:h], pn[:h], v(0, h), w[:, :h].contiguous(),
                                  at, bt, empty_state(M, c), **kw)
                        chain.append(fn(xq, qn, p[h:], pn[h:], v(h, P),
                                        w[:, h:].contiguous(), at, bt, half, **kw))
                    if prec == "default":
                        cases["two calls, kernel vs plain"] = tuple(chain)
                    else:
                        cases["two calls vs one"] = (chain[0], got)
                    st = tuple(s_.clone() for s_ in want)
                    st[0][::7], st[1][::7], st[2][::7] = fs.NEG_INF, 0.0, 0.0
                    cases["sentinel rows in state"] = (
                        fs.flash_score_update(*args, st, **kw),
                        fs.flash_score_update_plain(*args, st, **kw))
                    q7 = xq.view(SEEDS, rps, g.d)[:, :784].reshape(-1, g.d)
                    a7 = (q7, (q7 * q7).sum(-1), *args[2:])
                    kw7 = dict(kw, rows_per_seed=784)
                    cases["rows_per_seed 784"] = (
                        fs.flash_score_update(*a7, empty_state(q7.shape[0], c), **kw7),
                        fs.flash_score_update_plain(*a7, empty_state(q7.shape[0], c), **kw7))
                check_cases("k5", key, k, t, cases, rec)
                # the excluded seed's rows: every logit excluded, state empty
                dead = slice((SEEDS - 1) * rps, SEEDS * rps)
                if not ((got[0][dead] <= fs.NEG_INF / 2).all() and (got[1][dead] == 0).all()):
                    fail(f"{key}: the all-excluded seed's rows are not empty")
                if t != 0.5:
                    continue
                kw1 = dict(precision=prec, **vkw)
                diff = 0.0
                for s in range(SEEDS):
                    r = slice(s * rps, (s + 1) * rps)
                    one = fs.flash_score_update(
                        xq[r], qn[r], p, pn, vals, w[s].contiguous(), at, bt,
                        empty_state(rps, c), **kw1)
                    live = (one[0] > fs.NEG_INF / 2)
                    one_lse = torch.where(live, one[0] + torch.log(one[1]), 0.0)
                    got_lse = torch.where(live, got[0][r] + torch.log(got[1][r]), 0.0)
                    diff = max(diff, rel(got_lse, one_lse), rel(got[2][r], one[2]),
                               rel(got[1][r], one[1]))
                print(f"[k5] {key} k={k}: one K5 launch vs 8 one-seed 1-D "
                      f"launches, max rel difference {diff:.2e} (gate 1e-6)", flush=True)
                if diff > 1e-6:
                    fail(f"{key} differs from the one-seed launches at k={k}")
                ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
                plain_ms = plain_time(
                    prec, lambda: fs.flash_score_update_plain(*args, empty_state(M, c), **kw))
                one_d_ms = cuda_ms(lambda: fs.flash_score_update(
                    xq, qn, p, pn, vals, w[0].contiguous(), at, bt, empty_state(M, c),
                    **kw1), 5)

                def grouped():
                    for s in range(SEEDS):
                        r = slice(s * rps, (s + 1) * rps)
                        fs.flash_score_update(xq[r], qn[r], p, pn, vals, w[s], at, bt,
                                              empty_state(rps, c), **kw1)

                grouped_ms = cuda_ms(grouped, 3)
                b_ms, b_by = bound(M, P, g.d, c, prec, S=SEEDS,
                                   strategy=vkw.get("v_strategy", "vpu"))
                print(f"[k5] {key} k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
                      f"{b_ms / ms:.1%} of bound; 1-D kernel on the same inputs "
                      f"{one_d_ms:.3f} ms; grouped alternative (information): 8 "
                      f"launches at M={rps} {grouped_ms:.3f} ms", flush=True)
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k)
        del p, ctr, pn
    return recs


def prune_variants(k: int):
    """(launch key, keywords) of each kernel with a prune mask at k: K1, K2
    and the 'default' kernel in the variant the ELS module takes at k."""
    return [(launch_key(prec, k, prune=True), dict(precision=prec, **value_kw(prec, k)))
            for prec in ("highest", "high", "default")]


def forced_mask(M: int, P: int):
    """A mask that tests the mechanism, not the bound: every other stats
    block (so the first), the last, and every block of two query blocks
    (the first and one in the middle). Returns (mask, the all-skipped
    query rows)."""
    mask = torch.zeros(fs.prune_grid(M, P), dtype=torch.int32, device="cuda")
    mask[:, ::2] = 1
    mask[:, -1] = 1
    full = [0, mask.shape[0] // 2]
    mask[full] = 1
    rows = torch.cat([torch.arange(b * fs.PRUNE_ROWS, min(M, (b + 1) * fs.PRUNE_ROWS))
                      for b in full]).cuda()
    return mask, rows


def kernel_state_io(*args, **kw):
    """One `fs.flash_score_update` call on the card; returns (its result,
    the state the kernel was given, the state it returned), the last two in
    the kernel's own convention (before the wrapper moves m out of it)."""
    seen = []
    inner = fs.sweep_kernel

    def spy(*a, **k):
        out = inner(*a, **k)
        seen.append((a[5:8], out))
        return out

    fs.sweep_kernel = spy
    try:
        got = fs.flash_score_update(*args, **kw)
    finally:
        fs.sweep_kernel = inner
    return (got, *seen[0])


def check_masked(tag, key, k, t, what, args, state, mask, kw, rec):
    """Kernel + mask against plain + mask at TOL (folded into `rec`) and
    against the unmasked kernel at 1e-5; returns the masked result."""
    got = fs.flash_score_update(*args, state, prune_mask=mask, **kw)
    want = fs.flash_score_update_plain(*args, state, prune_mask=mask, **kw)
    unmasked = fs.flash_score_update(*args, state, **kw)
    torch.cuda.synchronize()
    check_cases(tag, key, k, t, {what: (got, want)}, rec)
    check_cases(tag, key, k, t, {f"{what}, vs the unmasked kernel": (got, unmasked)},
                {"max_abs_err": 0.0}, tol=1e-5)
    return got


def time_masked(tag, key, k, what, args, M, P, d, mask, kw, rec):
    """ms per launch with the mask and without, the plain version's with
    the mask, and the bound of the unskipped work; into `rec`."""
    c = 3
    skip = mask.float().mean().item()
    ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), prune_mask=mask,
                                               **kw), 5)
    ms_full = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
    plain_ms = plain_time(kw["precision"], lambda: fs.flash_score_update_plain(
        *args, empty_state(M, c), prune_mask=mask, **kw))
    b_ms, b_by = bound(M, P, d, c, kw["precision"], strategy=kw.get("v_strategy", "vpu"))
    b_ms *= 1.0 - skip
    print(f"[{tag}] {key} k={k} d={d} M={M} P={P} {what}: {skip:.2%} skipped; kernel "
          f"{ms:.3f} ms with the mask, {ms_full:.3f} ms without ({ms / ms_full:.3f}x; "
          f"1 - skip {1.0 - skip:.3f}); plain {plain_ms:.3f} ms; bound of the unskipped "
          f"work {b_ms:.3f} ms ({b_by})", flush=True)
    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k, skip=skip)


def phase_prune_kernel(images_dev, n_bank, gen):
    """K6 in K1, K2 and the 'default' kernel (see the module docstring,
    phase prune). Returns per K6 launch key the JSON numbers, timed on the
    sound masks at t = 0.05 of the largest k."""
    recs = {}
    for k in CHECKED_K:
        g = bank_geometry(n_bank, 32, 32, 3, k, TARGET_BLOCK)
        t0 = time.perf_counter()
        cb = build_clustered_bank(images_dev[: g.cs], k, TARGET_BLOCK)
        torch.cuda.synchronize()
        p, ctr, pn = cb.bank[0], cb.centers[0], cb.pn[0]
        w_img = torch.full((g.cs,), 1.0 / (MODULE_BATCH * g.per_img), device="cuda")
        w_img[-max(1, g.cs // 8):] = 0.0  # zero-weight rows, as chunk padding has
        w = tels._row_weights(cb, w_img, 0, g.per_img)
        M, P, c = SEEDS * 32 * 32, p.shape[0], 3
        print(f"[prune] k={k}: one chunk of P={P} rows ({g.cs} images) clustered "
              f"(4096 k-means centers) in {time.perf_counter() - t0:.2f} s", flush=True)
        imgs = images_dev[: g.cs]
        for t in PRUNE_T:
            beta = cosine_noise_schedule(t)
            at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
            x = at.item() * imgs[:SEEDS] + bt.item() * torch.randn(
                imgs[:SEEDS].shape, generator=gen, device="cuda")
            xq = extract_patches(pad_image(x, k // 2, "circular"), k).reshape(M, g.d)
            qn = (xq * xq).sum(-1)
            t1 = time.perf_counter()
            mask = tels.sweep_masks(cb, w_img, xq, qn, at, bt, per_img=g.per_img)[0]
            torch.cuda.synchronize()
            mask_ms = (time.perf_counter() - t1) * 1e3
            skip = mask.float().mean().item()
            print(f"[prune] k={k} t={t}: sound mask {tuple(mask.shape)}, {skip:.2%} "
                  f"skipped, built in {mask_ms:.1f} ms", flush=True)
            for key, kw in prune_variants(k):
                vals = None if kw.get("v_strategy") == "inbank" else ctr
                args = (xq, qn, p, pn, vals, w, at, bt)
                rec = recs.setdefault(key, {"max_abs_err": 0.0})
                want = check_masked("prune", key, k, t, f"sound mask ({skip:.2%} skipped)",
                                    args, empty_state(M, c), mask, kw, rec)
                if t == 0.5:
                    st = tuple(s_.clone() for s_ in want)
                    st[0][::7], st[1][::7], st[2][::7] = fs.NEG_INF, 0.0, 0.0
                    fmask, rows = forced_mask(M, P)
                    got, k_in, k_out = kernel_state_io(*args, st, prune_mask=fmask, **kw)
                    want_f = fs.flash_score_update_plain(*args, st, prune_mask=fmask, **kw)
                    torch.cuda.synchronize()
                    check_cases("prune", key, k, t, {
                        f"forced mask ({fmask.float().mean().item():.2%} skipped), "
                        "carried state with sentinel rows": (got, want_f)}, rec)
                    same = all(torch.equal(a[rows], b[rows]) for a, b in zip(k_in, k_out))
                    print(f"[prune] {key} k={k}: the kernel's state of the {rows.numel()} "
                          f"all-skipped query rows bit-equal to its input: {same}", flush=True)
                    if not same:
                        fail(f"{key} changed the state of all-skipped query blocks at k={k}")
                if t == PRUNE_T[0]:
                    time_masked("prune", key, k, "sound mask", args, M, P, g.d, mask, kw,
                                rec)
        del cb, p, ctr, pn
    return recs


def phase_prune_stress(recs, M=8192, P=65536):
    """The clustered stress problem: 8 tight clusters of P / 8 bank rows in
    order, queries near one cluster per 256 rows, M = 8192, P = 65536,
    d = 27, uniform weights, at a_t = 0.99, b_t = 0.08. Its mask must skip
    more than half; each kernel with it against the plain version (1e-3)
    and the unmasked kernel (1e-5); ms masked against unmasked."""
    d, c = 27, 3
    rng = np.random.RandomState(0)
    means = rng.normal(0, 2.0, (8, d))
    bank = means[np.repeat(np.arange(8), P // 8)] + rng.normal(0, 0.2, (P, d))
    q = means[np.repeat(rng.randint(0, 8, M // 256), 256)] + rng.normal(0, 0.1, (M, d))
    bank, q = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (bank, q))
    qn, pn = (q * q).sum(-1), (bank * bank).sum(-1)
    w = torch.full((P,), 1.0 / P, device="cuda")
    at, bt = STRESS_AT_BT
    stats = pr.block_stats(bank[None], torch.ones((1, P), dtype=torch.bool, device="cuda"))
    mask = pr.prune_masks(q, qn, at, bt, stats, *pr.logw_block_stats(w[None]))
    skip = mask.float().mean().item()
    print(f"[prune] stress problem M={M} P={P} d={d} a_t={at} b_t={bt}: {skip:.2%} "
          "skipped (must be above 50%)", flush=True)
    if not skip > 0.5:
        fail(f"the stress problem's mask skips only {skip:.2%}")
    vals = bank[:, 12:15].contiguous()  # the k = 3 center columns, as 'inbank' reads
    stress = {}
    for key, kw in prune_variants(3):
        args = (q, qn, bank, pn, None if kw.get("v_strategy") == "inbank" else vals, w,
                at, bt)
        rec = stress.setdefault(key, {"max_abs_err": 0.0})
        check_masked("prune", key, "stress", f"(a_t {at}, b_t {bt})", "stress mask", args,
                     empty_state(M, c), mask, kw, rec)
        time_masked("prune", key, "stress", "stress mask", args, M, P, d, mask, kw, rec)
        recs[key]["max_abs_err"] = max(recs[key]["max_abs_err"], rec["max_abs_err"])
    return stress


def expected_launches(precision, n_bank, per_seed=False, pruned=()):
    """Launch counts of a 20-step CIFAR10 machine over n_bank images: one
    sweep per bank chunk per step, under the key of the variant the ELS
    rule takes at that step's k (with a prune mask at the k's in
    `pruned`)."""
    want = {}
    for i in range(len(CIFAR10_SCALES) - 1, 0, -1):
        k = CIFAR10_SCALES[i]
        key = launch_key(precision, k, per_seed, prune=k in pruned)
        nblk = bank_geometry(n_bank, 32, 32, 3, k, TARGET_BLOCK).nblk
        want[key] = want.get(key, 0) + nblk
    return want


def cached_ks(n_bank: int, prune: bool) -> set:
    """The k's an ELS module caches under its default ledger over a 20-step
    CIFAR10 machine: first come, first served in step order, each bank's
    `bank_cache_nbytes` (a k that misses once misses again)."""
    used, ks = 0, set()
    for k in CIFAR10_SCALES[:0:-1]:
        nbytes = bank_cache_nbytes(n_bank, 32, 32, 3, k, TARGET_BLOCK, prune)
        if k not in ks and used + nbytes <= tels.DEFAULT_BANK_BUDGET:
            used += nbytes
            ks.add(k)
    return ks


def phase_machine(tag, cls, precision, ds, n_bank, x, ms_by_k, prune=False,
                  before=None, after=None):
    """One 20-step machine call at full width from seeds x; the tier's
    kernel must carry every sweep (one launch per bank chunk per step, in
    the variant of the step's k; with `prune`, masked at the cached k's),
    no other kernel may run. `before(module)` runs inside the wall, just
    before the machine call, and returns the device peak it saw;
    `after(module)` runs before the module is dropped. Returns (launches by
    key, wall, output)."""
    if n_bank < FULL_N:
        print(f"[{tag}] reduced: {n_bank} of {FULL_N} bank images (depth cut; "
              "widths, scales and seeds as published)", flush=True)
    mod = cls((ds.images[:n_bank], ds.labels[:n_bank]), batch_size=MODULE_BATCH,
              target_block=TARGET_BLOCK, precision=precision, device="cuda",
              **({"prune": True} if prune else {}))
    machine = ScheduledScoreMachine(mod, in_channels=3, imsize=32,
                                    scales=CIFAR10_SCALES)
    steps = range(len(CIFAR10_SCALES) - 1, 0, -1)
    pruned = cached_ks(n_bank, True) if prune else set()
    expected = expected_launches(precision, n_bank, pruned=pruned)
    kernel_s = sum(
        bank_geometry(n_bank, 32, 32, 3, CIFAR10_SCALES[i], TARGET_BLOCK).nblk
        * ms_by_k[CIFAR10_SCALES[i]] for i in steps) / 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    peak = before(mod) if before is not None else 0
    out = machine(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fs.flash_score_update.launches)
    banked = sorted(mod._bank_cache)
    streamed = sorted(set(CIFAR10_SCALES[1:]) - set(banked))
    peak = max(peak, torch.cuda.max_memory_allocated())
    print(f"[{tag}] {cls.__name__} precision={precision!r}{', prune' if prune else ''}: "
          f"{len(steps)} steps, N={n_bank}, b={SEEDS}: wall {wall:.2f} s (bank builds "
          f"included), {SEEDS / wall:.4f} images/s, peak memory {peak / 1e9:.2f} GB",
          flush=True)
    ran = {key: n for key, n in launches.items() if n}
    print(f"[{tag}] banked k={banked} streamed k={streamed}; launches {ran} "
          f"(expected: the sum of chunks over the steps, {expected})", flush=True)
    print(f"[{tag}] kernel time at the phase-3 per-launch times: {kernel_s:.2f} s "
          f"({100 * kernel_s / wall:.1f}% of the wall); the rest (bbELS: the border "
          f"regions; bank builds, glue) {wall - kernel_s:.2f} s", flush=True)
    if prune and set(banked) != pruned:
        fail(f"{tag}: cached k={banked}, the ledger's rule gives {sorted(pruned)}")
    if ran != expected:
        fail(f"{tag}: launches {ran}, expected {expected}")
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail(f"{tag}: output is not a finite [8, 32, 32, 3] tensor")
    if after is not None:
        after(mod)
    del mod, machine
    torch.cuda.empty_cache()
    return ran, wall, out


class MaskSpy:
    """Within `with`, records each `els.sweep_masks` call: (d, ms with a
    device synchronisation at each end, skip fraction)."""

    def __enter__(self):
        self.calls, self.inner = [], tels.sweep_masks

        def spy(bank, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks = self.inner(bank, *a, **kw)
            torch.cuda.synchronize()
            self.calls.append((bank.bank.shape[-1], (time.perf_counter() - t0) * 1e3,
                               masks.float().mean().item()))
            return masks

        tels.sweep_masks = spy
        return self

    def __exit__(self, *exc):
        tels.sweep_masks = self.inner


def phase_els_prune(ds, n_bank, x, ms_by_k, main_out, main_wall):
    """The pruned ELS 'highest' machine (machine phase els_prune): launch
    counts, the clustered builds' parts and peak memory, each step's skip
    fraction and mask ms, the distance to main's output; gate: one k = 3,
    t = 0.05 call against the same clustered bank unmasked at 1e-5.
    Returns (launches by key, wall)."""
    card = torch.cuda.get_device_properties(0).total_memory
    builds = []  # (k, the parts' seconds, bytes held before, peak during)
    machine_masks = []  # the machine's mask builds (the gate's come after)

    def build_banks(mod):
        """The machine's bank builds ahead of its call, in its step order
        (the ledger's first come, first served, so the same k's are cached),
        each with its own peak; returns the device peak over them."""
        peak = 0
        for k in dict.fromkeys(CIFAR10_SCALES[:0:-1]):
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            bank = mod._bank(k)
            torch.cuda.synchronize()
            if bank is not None:
                builds.append((k, bank.build_seconds, held,
                               torch.cuda.max_memory_allocated()))
        return peak

    def one_call(mod):
        machine_masks.extend(masks.calls)
        masked = mod(0.05, x, k=3)
        mod.prune = False  # the same cached clustered bank, swept unmasked
        unmasked = mod(0.05, x, k=3)
        e = rel(masked, unmasked)
        print(f"[els_prune] one call at k=3 t=0.05 against the same clustered bank "
              f"swept without masks: rel {e:.2e} (tol 1e-05)", flush=True)
        if not e <= 1e-5:
            fail("the pruned k = 3 call differs from the unmasked one")

    with MaskSpy() as masks:
        ran, wall, out = phase_machine("els_prune", LocalEquivScoreModule, "highest", ds,
                                       n_bank, x, ms_by_k, prune=True, before=build_banks,
                                       after=one_call)
    for k, times, held, peak in builds:
        bank = bank_cache_nbytes(n_bank, 32, 32, 3, k, TARGET_BLOCK, True)
        print(f"[els_prune] clustered build k={k}: " + ", ".join(
            f"{part} {s:.2f} s" for part, s in times.items())
            + f"; peak {peak / 1e9:.2f} GB of the card's {card / 1e9:.2f} GB, "
            f"{(peak - held) / 1e9:.2f} GB above the {held / 1e9:.2f} GB held "
            f"before ({(peak - held) / bank:.3f}x the clustered bank's "
            f"{bank / 1e9:.2f} GB)", flush=True)
        if not (peak < card and peak - held < bank + BUILD_TRANSIENT):
            fail(f"the clustered k = {k} build peaked at {peak / 1e9:.2f} GB")
    for step, (d, ms, frac) in enumerate(machine_masks):
        print(f"[els_prune] masked sweep {step}: k={round((d / 3) ** 0.5)}, "
              f"{frac:.4%} of the cells skipped, masks built in {ms:.1f} ms", flush=True)
    print(f"[els_prune] wall {wall / main_wall:.3f}x main's; output vs main's from the "
          f"same seeds (information: the clustered order changes the fp32 summation "
          f"order) rel {rel(out, main_out):.2e}", flush=True)
    return ran, wall


def phase_mxu1_path(ds, n_bank, gen):
    """'mxu1' on a module's path: one ELS 'default' call at k = 9 with a
    target block of 2^19 patches (910 images, 524160 bank rows a chunk,
    where 'auto' takes 'mxu1'), 8 seeds over the N bank images; every sweep
    must be one 'mxu1' launch."""
    k, block = 9, 1 << 19
    mod = LocalEquivScoreModule((ds.images[:n_bank], ds.labels[:n_bank]),
                                batch_size=MODULE_BATCH, target_block=block,
                                precision="default", device="cuda")
    g = bank_geometry(n_bank, 32, 32, 3, k, block)
    x = torch.randn((SEEDS, 32, 32, 3), generator=gen, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = mod(0.5, x, k=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = {key: n for key, n in fs.flash_score_update.launches.items() if n}
    print(f"[mxu1] ELS 'default' k={k} target block {block}: {g.nblk} chunks of "
          f"{g.block} bank rows, {wall:.2f} s (bank build included); launches {ran}",
          flush=True)
    if ran != {FAST + "/mxu1": g.nblk}:
        fail(f"mxu1 path: launches {ran}, expected {g.nblk} 'mxu1' launches")
    if not torch.isfinite(out).all():
        fail("mxu1 path: the score is not finite")
    del mod
    torch.cuda.empty_cache()
    return ran


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
    count must rise), IS --fill over its seeds and labels, conditional
    bbELS (grouped by label: 1-D K1 launches only), and at
    --precision default conditional ELS (per-seed 'inbank' at k <= 5 and
    per-seed 'vpu' above) and conditional bbELS (1-D, both variants)."""
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
         {"flash_score_bf16x3" + fs.PER_SEED}),
        ("IS --fill", ["--scoremoduletype", "IS", "--idealname", "ideal", "--fill",
                       "--expname", "els"], "els", "ideal", set()),
        ("bbELS", ["--scoremoduletype", "bbELS", "--expname", "bbels"], "bbels",
         "els_outputs", {"flash_score"}),
        ("ELS --precision default", ["--scoremoduletype", "ELS", "--precision",
                                     "default", "--expname", "els_default"],
         "els_default", "els_outputs",
         {FAST + "/inbank" + fs.PER_SEED, FAST + fs.PER_SEED}),
        ("bbELS --precision default", ["--scoremoduletype", "bbELS", "--precision",
                                       "default", "--expname", "bbels_default"],
         "bbels_default", "els_outputs", {FAST + "/inbank", FAST}),
    ]
    launches = {}
    for what, extra, exp, sub, keys in runs:
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
        if ran != keys:
            fail(f"cli {what}: expected launches of {sorted(keys)} only, got {got}")
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
    bb_scales = [3, 3, 3, 5, 5, 7, 9, 11, 13, 17]
    stream = {"bank_budget_bytes": 0}
    cases = [
        ("ELS 'highest'", LocalEquivScoreModule, "highest", els_scales, None, {}),
        ("bbELS 'high'", LocalEquivBordersScoreModule, "high", bb_scales, None, {}),
        ("conditional ELS 'highest'", LocalEquivScoreModule, "highest", els_scales,
         vec, {}),
        ("conditional ELS 'high'", LocalEquivScoreModule, "high", els_scales, vec, {}),
        ("IS", IdealScoreModule, "highest", els_scales, None, {}),
        ("ELS 'default' banked", LocalEquivScoreModule, "default", els_scales, None, {}),
        ("ELS 'default' streamed", LocalEquivScoreModule, "default", els_scales, None,
         stream),
        ("bbELS 'default'", LocalEquivBordersScoreModule, "default", bb_scales, None, {}),
        ("conditional ELS 'default'", LocalEquivScoreModule, "default", els_scales,
         vec, {}),
    ]
    for what, cls, precision, scales, label, kw in cases:
        outs = {}
        runs = [("cuda", precision), ("cpu", precision)]
        if precision == "default":
            runs.append(("cpu", "high"))  # the tier gap on the same machine
        for dev, prec in runs:
            mod = cls((small.images, small.labels), batch_size=16,
                      precision=prec, device=dev, **kw)
            outs[dev, prec] = ScheduledScoreMachine(mod, imsize=16, scales=scales)(
                x, label=label).cpu()
        e = rel(outs["cuda", precision], outs["cpu", precision])
        print(f"[devices] {what} 10-step machine, scales {scales}, N=64 16x16x3, "
              f"b=2{'' if label is None else f', labels {label.tolist()}'}: cuda vs "
              f"cpu rel {e:.2e} (tol {TOL:g})", flush=True)
        if precision == "default":
            print(f"[devices] {what}: cuda vs cpu at 'high' (the tier gap, information) "
                  f"rel {rel(outs['cuda', precision], outs['cpu', 'high']):.2e}", flush=True)
        if e > TOL and precision == "default" and e <= DEVICES_DEFAULT_TOL:
            print(f"[devices] {what}: past {TOL:g}, held at {DEVICES_DEFAULT_TOL:g}: "
                  "a last-bit difference of a logit between the card and the CPU "
                  "flips a bf16 rounding of x = logit - m, and the steps amplify "
                  "it", flush=True)
        elif not e <= TOL:
            fail(f"card and CPU disagree on the small {what} machine")


def prototype_set(seed, n=64, protos=4, size=16, noise=0.01):
    """n images in `protos` runs of one flat colour each (distinct corners
    of the colour cube at +-0.8) plus small noise, labelled by colour: the
    clustered bank's stats blocks hold one colour each, so the masks skip
    at the last, low-noise steps (on the synthetic textures they do not)."""
    rs = np.random.RandomState(seed)
    corners = np.array(list(itertools.product([-0.8, 0.8], repeat=3)), np.float32)
    colour = corners[rs.permutation(8)[:protos]].reshape(protos, 1, 1, 3)
    idx = np.arange(n) * protos // n
    imgs = colour[idx] + noise * rs.normal(size=(n, size, size, 3))
    return imgs.astype(np.float32), idx.astype(np.int32)


def phase_devices_prune(seed):
    """ELS prune=True 10-step machines at 'highest' and 'high' over
    prototype images, card against CPU at TOL, each with a skip fraction
    above 0 on both devices; then one label-vector call on the clustered
    bank (per-seed weights, K5, unmasked). Returns the card's launches."""
    imgs, labels = prototype_set(seed)
    x = np.random.RandomState(seed).normal(size=(2, 16, 16, 3)).astype(np.float32)
    scales = [3, 3, 3, 3, 5, 5, 5, 7, 7, 9]
    vec = np.array([1, 3])
    launches = {}
    for precision in ("highest", "high"):
        outs, mods, fracs = {}, {}, {}
        for dev in ("cuda", "cpu"):
            mods[dev] = LocalEquivScoreModule((imgs, labels), batch_size=16,
                                              precision=precision, device=dev, prune=True)
            if dev == "cuda":
                reset_launches()
            with MaskSpy() as masks:
                outs[dev] = ScheduledScoreMachine(mods[dev], imsize=16, scales=scales)(x).cpu()
            if dev == "cuda":
                for key, n in fs.flash_score_update.launches.items():
                    launches[key] = launches.get(key, 0) + n
            fracs[dev] = np.mean([f for _, _, f in masks.calls])
        e = rel(outs["cuda"], outs["cpu"])
        print(f"[devices] ELS {precision!r} prune=True 10-step machine, scales {scales}, "
              f"prototype images N=64 16x16x3, b=2: cuda vs cpu rel {e:.2e} (tol {TOL:g}); "
              f"mean skip fraction cuda {fracs['cuda']:.2%}, cpu {fracs['cpu']:.2%}",
              flush=True)
        if not e <= TOL:
            fail(f"card and CPU disagree on the small pruned {precision!r} machine")
        if not (fracs["cuda"] > 0 and fracs["cpu"] > 0):
            fail(f"the small pruned {precision!r} machine's masks skip nothing")
        if precision != "highest":
            continue
        vouts = {}
        for dev in ("cuda", "cpu"):
            xv = torch.from_numpy(x).to(dev)
            before = dict(fs.flash_score_update.launches)
            vouts[dev] = mods[dev](0.05, xv, k=3, label=vec).cpu()
            ran = {key: n - before[key] for key, n in fs.flash_score_update.launches.items()
                   if n != before[key]}
            if dev == "cuda":
                if ran != {"flash_score" + fs.PER_SEED: 1}:
                    fail(f"the label-vector call on the clustered bank launched {ran}")
                launches["flash_score" + fs.PER_SEED] += 1
        e = rel(vouts["cuda"], vouts["cpu"])
        print(f"[devices] ELS 'highest' prune=True, label vector {vec.tolist()} at k=3 "
              f"t=0.05 on the clustered bank (K5, unmasked): cuda vs cpu rel {e:.2e} "
              f"(tol {TOL:g})", flush=True)
        if not e <= TOL:
            fail("card and CPU disagree on the label-vector call on the clustered bank")
    return launches


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
    recs, ms_by_k, ms_center = phase_kernel(images_dev, args.n, gen)
    phase_mxu1_kernel(images_dev, args.n, gen, recs)
    recs.update(phase_kernel_per_seed(
        images_dev, torch.from_numpy(ds.labels.astype(np.int64)).cuda(), args.n, gen))
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    prune_recs = phase_prune_kernel(images_dev, args.n, gen)
    phase_prune_stress(prune_recs)
    for key, rec in prune_recs.items():
        if key.startswith(FAST):  # checked, but on no path: not in the kernels line
            print(f"[prune] {key} (no path launches it: the ELS module masks only "
                  f"'highest' and 'high'): worst max abs error {rec['max_abs_err']:.3e}, "
                  f"{rec['ms']:.3f} ms at k={rec['k']}", flush=True)
        else:
            recs[key] = rec
    del images_dev
    torch.cuda.empty_cache()
    print("[exact] worst rel of each variant against the exact split sum, over the "
          "kernel, mxu1 and k5 cases: " + ", ".join(
              f"{key} {e:.2e}" for key, e in EXACT_WORST.items()), flush=True)
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    path = {}  # launches by key on the paths (machines, pipeline, CLI)

    def add(counts):
        for key, n in counts.items():
            path[key] = path.get(key, 0) + n

    x = torch.randn((SEEDS, 32, 32, 3), generator=gen, device="cuda")
    walls, outs = {}, {}
    for tag, cls, precision, times in (
        ("main", LocalEquivScoreModule, "highest", ms_by_k["flash_score"]),
        ("bbels", LocalEquivBordersScoreModule, "high", ms_center["flash_score_bf16x3"]),
        ("els_high", LocalEquivScoreModule, "high", ms_by_k["flash_score_bf16x3"]),
        ("els_default", LocalEquivScoreModule, "default", ms_by_k[FAST]),
        ("bbels_default", LocalEquivBordersScoreModule, "default", ms_center[FAST]),
    ):
        ran, walls[tag], outs[tag] = phase_machine(tag, cls, precision, ds, args.n, x,
                                                   times)
        add(ran)
        print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
        if tag == "main":
            ran, walls["els_prune"] = phase_els_prune(ds, args.n, x, times, outs["main"],
                                                      walls["main"])
            add(ran)
            print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    for fast, high in (("els_default", "els_high"), ("bbels_default", "bbels")):
        print(f"[{fast}] the tier's cost in accuracy (information): output vs {high}'s "
              f"from the same seeds, rel {rel(outs[fast], outs[high]):.2e}; wall "
              f"{walls[fast] / walls[high]:.3f}x", flush=True)
    add(phase_mxu1_path(ds, args.n, gen))
    got, mod = phase_cond(ds, args.n, walls["main"])
    add(got)
    phase_grouped(mod, gen)
    del mod
    torch.cuda.empty_cache()
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    add(phase_cli())
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_devices(args.seed)
    add(phase_devices_prune(args.seed))
    print(f"[time] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    never = [key for key in recs if not path.get(key)]
    if never:
        fail(f"kernel variants never launched on the paths: {never} ({path})")
    print(json.dumps({"kernels": [
        kernel_record(name, rec, path[name]) for name, rec in recs.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
