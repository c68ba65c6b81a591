#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--n IMAGES] [--n-wide IMAGES] [--seed SEED]

Phases, each printing its own lines; any failure exits non-zero:

1. device   — the card's name and power limit (nvidia-smi), torch's view, and
              the SFU's exp2 rate (16 per clock per SM x SMs x max SM clock).
2. build    — compiles the three flash-score kernels from the sources in this
              checkout (one nvcc per source, started together, sm_90a; K1's
              source holds its main loop and the merge pass, K2's and the
              'default' kernel's the split-dot main loop, the merge pass and
              the pre-split pass) and prints one [ptxas] line per kernel
              instantiation (registers, spill stores and loads, stack), any
              note of ptxas serialising the wgmma products, and the build
              times.
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
              Tier gaps are printed as information only. Every kernel runs
              on the split-bank grid (ops/csrc/split_bank.cuh): each timing
              line prints the split plan and the grid, and at k in {3, 9, 17}
              every t a launch from the empty state must return m equal, bit
              for bit, to the row max of the parent's logits (K1: of
              `fs.fp32_logits_in_order` over every eighth 64-row block; the
              'default' kernel: K2's per-row launch's, the one split-dot
              loop; K2's agreement with `fs._split_dot` prints; the moved
              variants of phase variants likewise, at t = 0.5). Every timed
              variant, here and in the phases below, is also timed against
              the library yardstick: PyTorch's memory-efficient attention
              (`_scaled_dot_product_efficient_attention`) on the same
              inputs as attention with an additive per-key bias
              (`sdpa_inputs`), its distance from the plain version printed,
              never gated, never called by the port. Then 'mxu1' once,
              where 'auto' takes it: k = 9, one call over 5 chunks (P >= 2^18).
4. k5       — per-seed weights, kernel variant K5, in every kernel (at
              'default' in the ELS module's variant: 'inbank' at k = 3):
              M = 8192 (8 seeds x 1024 rows) against one full CIFAR10
              chunk, w [8, P] from label-filtered image weights (one class
              per seed, one seed of a class with no image in the chunk),
              k in {3, 9, 17}, t in {0.05, 0.5, 0.95}, against
              the plain version at 1e-3; at t = 0.5 also chained, with
              sentinel rows, at rows_per_seed = 784 (a partial last block per
              seed), and against 8 one-seed 1-D launches (gate 1e-6). Each
              block walks only its seed's live bank tiles: one launch
              records the tiles each block walked (`tile_counts`), which
              must equal, block by block, its seed's live tiles in its
              split by the plain flags (`fs.live_tiles_plain`), so the
              walked fraction equals the live fraction (printed, with the
              spread over blocks). K5's time against the bound of the live
              (seed, tile) pairs' work and the all-pairs bound, the 1-D
              kernel's time on the same inputs, and the grouped
              alternative's (8 launches at M = 1024, information).
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
   variants — 'mxu', 'inbank' at 'highest'/'high' and the bf16 exponential
              apart from the tier, each against its plain version at
              1e-3 (one call, and where marked a two-call chain
              and a carried state with sentinel rows), its launch key
              checked, its time, plain time and bound printed: (1) 'mxu',
              what 'auto' takes at c > 8, in K1, K2 and the 'default'
              kernel on one full chunk of the 16-channel bank, M = 8192,
              k in {3, 9, 17}, t in {0.05, 0.5, 0.95}, chained at t = 0.5
              and k = 3 (at d >= 200 the plain versions run over every
              eighth 64-row query block, rows being independent, and K1's
              repeats K1's fp32 summation order, `fs.fp32_logits_in_order`:
              at d = 4624, t = 0.05 two fp32 orders of the same dot part by
              ~3e-3 on the posterior mean; the BLAS order's distance
              prints), 'default' also within 4e-3 of the exact split sum;
              per-launch times at every k of the schedule; (2)
              'mxu' at c = 9 and 48 (k = 3), and forced at c = 3 against
              'vpu' (1e-3; 'default' 4e-3); (3) 'inbank' at 'highest' and
              'high', c = 3, k = 3, 5; (4) 'highest' with the bf16
              exponential in 'vpu', 'mxu1', 'inbank' and 'mxu' (k = 3, 9),
              also within 4e-3 of the plain version over float64 dots; (5)
              'high' with the bf16 exponential and 'default' without: they
              launch the 'default' kernel and K2; (6) K5 in each new
              variant, 8 seeds of 1024 rows (one label-filtered weight row
              each, the last seed's class absent), against the plain
              version and 7 one-seed 1-D launches (1e-6), its walk gated as
              in phase k5 and timed against the live pairs' bound; (7) K6:
              'mxu' masked at 'highest' and 'high' on a clustered 16-channel
              chunk (sound masks, against plain + mask 1e-3 and the
              unmasked kernel 1e-5) and on the stress problem at d = 144,
              c = 16 (more than half skipped); (8) K6 in K1, c = 3, k = 17,
              under a mask that skips nothing: bit-equal to the unmasked
              launch, and the two timed in turns (unmasked, masked,
              masked, unmasked).
5. machines — one 20-step ScheduledScoreMachine call each, CIFAR10 scales,
              8 seeds of 32x32x3 (the same seeds for all), over N synthetic
              bank images (--n, default 10000, cut from the published
              50000 to keep the script within its time limit; printed as
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
   wide     — the slice's path: 20-step ELS machines at 'highest',
              'high' and 'default' on 8 seeds of 32x32x16 over N images of
              synthetic_dataset(num_channels=16) (--n-wide, default 8000,
              for 'highest', half of it for the other two, whose sweeps take
              ~0.7x K1's time each; cut from 50000 and printed as reduced),
              every sweep 'mxu':
              each launch count equal to the sum of bank chunks over the
              19 steps, no other variant, the output finite; wall, images/s,
              peak memory, kernel time at the per-launch times.
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
              clustered bank (K5, unmasked); then on 16x16x16 images (every
              sweep 'mxu'): ELS at each tier, bbELS at 'high', ELS with a
              2-seed label vector at each tier, and ELS prune=True at
              'highest' and 'high' over 16-channel prototype images with
              the skip fraction above 0. The 16-channel 'default' machines
              are held at 2.5e-2, not 2.5e-3: on the CPU alone a last-bit
              change of their split dots moves them by ~1.1e-2 (printed
              beside each, with the tier gap to 'high').
10. neural  — the neural serving half (cuDNN and cuBLAS: the JAX models have
              no Pallas kernel). Gates: the flagship conditional ResNet of
              the JAX bench (emb_dim 256, 8 layers, 'zeros', 10 classes) at
              'highest' on the card and on the CPU from the same seeded
              weights and NHWC seeds, a 20-step DDIM trajectory (every
              state) and one ddpm_step with injected noise, each within 1e-3
              relative to scale; the epsilon of one forward and the
              ddpm_step also within 1e-5 (true fp32 against true fp32), and
              the TF32 model's epsilon (precision=None) must fall outside
              1e-5, so TF32 in cuDNN or cuBLAS shows; the reference pickles
              tests/goldens/pickles/backbone_{resnet_cond,unet}.pt loaded on
              the card against tests/goldens/pickle_forward.npz (atol 5e-5,
              rtol 2e-4); every output finite. Then the bench's cells, each
              a 1000-step DDPM `sampling.sample` call after a 3-step
              warm-up: the flagship at batch 64 at 'highest' and with TF32
              allowed (precision=None, the JAX bench's headline), three
              calls each, interleaved (each call's line, then the median
              and the spread), and the 64x64 conditional UNet (fsizes
              64..512, 2 classes) at batch 32, one call: wall, images/s,
              ms per step, TFLOP/s from the bench's count (the flagship),
              peak memory; then a profiled 20-step window: the kernels'
              device time over the window's span on the device clock (CUDA
              events inside the window), both from that one run (the
              device-busy share; the window's step, which carries the
              profiler's host cost, prints beside the unprofiled step), the
              kernel launches per step and the host synchronisations.
11. calibrate — scale calibration against the CNN: a small case (N = 256,
              2 seeds, 3 steps, k = 3, 5) on the card and on the CPU must
              give the same k_optimals; then the README recipe that the JAX
              bench times: eight ELS modules k = 3..17 at 'highest' on one
              bank ledger over N = 5000 synthetic 32x32x3 images, 10 seeds,
              20 steps, the flagship unconditional at 'highest': wall (bank
              builds included), K1 launches (one per bank chunk per k per
              step, nothing else), peak memory, banked k's, median and mode;
              then at the recipe's shapes (M = 10 x 1024 query rows, the
              N = 5000 banked chunks) one call of the k = 3 and k = 17
              modules at t = 0.05 and 0.5: every K1 launch of the call
              against the plain version from the same input state on every
              eighth 64-row query block, m + log s1 and s2/s1 at 1e-3.
12. cli_sample — cli.sample --conditional on the card with the conditional
              reference pickle: the PNG grid (decoded with zlib: 2 x 8
              tiles of 16x16 RGB) and --save_arrays under build/chip_smoke/.
13. train    — training (cuDNN, cuBLAS and PyTorch's fused AdamW; the JAX
              trainer has no Pallas kernel, and the phase fails if a
              flash-score kernel runs). Gates: (a) one flagship step at
              batch 8 on the card at 'highest', on the card with TF32, and
              on the CPU in float32 and float64 from the same weights, t and
              eps: the card's loss and gradients within 1e-5 of the float64
              step plus twice the CPU float32's own distance from it (that
              alone reaches ~1e-5 of the gradients' scale), the TF32 step
              past that bound (a backward that leaked TF32 shows); (b) the
              flagship with TF32 over 200 steps on 1280 synthetic images at
              the recipe's lr: the last epoch's mean loss below 0.9x the
              first's; (c) under cudnn.deterministic, 10 flagship steps
              straight against 5, a checkpoint, a restore into a model of
              other weights and 5 more: weights and AdamW moments bit for
              bit; (d) as (a) for a BatchNorm UNet of the UNet-64 widths at
              32x32, running statistics included (conv biases that
              BatchNorm zeroes left out), and as information the same card
              step through cuDNN's BatchNorm, which the port's
              `models.layers.BatchNorm` keeps out; (e) cli.train for one epoch of
              --dataset synthetic with the flagship's flags, then
              cli.sample --modelfile on its checkpoint directory (the PNG
              decoded, finite samples). Then the flagship recipe (batch
              128, 32x32) at 'highest' and with TF32 and the UNet-64 recipe
              (batch 64, 64x64) at 'highest': three windows of 20 chained
              steps after a warm-up, each by CUDA events (median, spread),
              images/s, TFLOP/s by 3x the forward's conv and dense count,
              peak memory; and one profiled 20-step train_diffusion epoch:
              the device-busy share, kernel launches per step, host
              synchronisations (more than 3 fail the phase).
14. parallel — parallel/ over torch.distributed (after train). (a) NCCL with
              one rank, in this process: the sharded ELS module (N = 2000)
              at k = 3, 9, 17 and one data-parallel flagship step at batch
              128 (cudnn.deterministic) equal the unsharded ones bit for
              bit. (b) Two gloo ranks sharing cuda:0 (this script, started
              twice with --parallel-worker; NCCL refuses two ranks on one
              device), each with half the 48 GiB bank ledger, against one
              process on the same card and data: the sharded ELS 'highest'
              machine (N = 4000) and bbELS 'high' machine (N = 2000), 20
              steps, 8 seeds, CIFAR10 scales, at 1e-3 (printed beside one
              score call's distance); one IS and one LS call at the devices
              phase's sizes at 1e-5; three data-parallel flagship steps
              (batch 128 as 2 x 64) and one BatchNorm UNet step (UNet-64
              widths, 32x32, batch 16 as 2 x 8): losses at 1e-5, the first
              step's averaged gradients within 1e-5 + 2x the one-process
              float32's own distance of a float64 step, weights (running
              statistics included) after 1 and 3 steps at 1e-5 of scale,
              the components without a gradient AdamW resolves (float64
              gradient within float32's error, or a float64 or float32
              gradient within 1e-6) within AdamW's step bound and counted; sample_sharded of the flagship's 20-step
              DDIM, 8 seeds over 2 ranks, against sample at 1e-5. A rank
              that fails or outlives 600 s fails the run. Information: the
              sharded walls beside the one-process walls, all-reduces and
              bytes per score call, each rank's launches (added to the path
              counts) and peak memory, the phase's seconds.
15. analysis — analysis/ and cli.analyze_ed's loop (after parallel; the
              flash-score kernel has no backward: the analysis
              differentiates the plain sweep, use_pallas=False). (a) a
              bbELS field on the kernel route raises under jacrev; with
              use_pallas=False its Jacobian is non-zero and no kernel
              launches; (b) the flagship's full Jacobian at 32x32x3 (n =
              3072, label 3) at 'highest' within 1e-5 of the same Jacobian
              in float64 (max abs over max |J64|), the TF32 model outside
              it; wall and peak; (c) cli.analyze_ed's realization loop at
              --image_size 16, 20 steps, one realization: the flagship
              (unconditional) and bbELS (k = 5, max_samples 1000) over a
              50000-image synthetic set, seconds per step, no kernel launch;
              then one step's df card against CPU on the same x at 1e-3
              (bbELS at max_samples 64); (d) one bbELS Jacobian at 32x32x3
              with max_samples cut to 256; (e) the IS field's ||J - J^T|| /
              ||J|| <= 1e-5 at 16x16 (bbELS's printed beside it); (f)
              analyze_patch_distances at the CLI defaults (patch sizes 3, 6,
              10, 200 samples) over sets of MNIST's, CIFAR10's and CelebA's
              shapes and train-split sizes on the card: d^2 within 32
              float32 ulps of ||a||^2 + ||b||^2 of float64 on the same
              patches, the TF32 gram outside it.
16. loader   — the native C++ loader built from native/loader.cpp here
              (build seconds); from_arrays over 50000 uint8 32x32x3 images,
              from_idx and from_cifar_bins over temporary files: batches
              (next and the pinned next_device) bit-equal to the
              normalisation of the images their labels name; 20 flagship
              steps at batch 128 fed by the loader, by the arrays, and by
              the loader again (CUDA events, images/s);
              train_diffusion(use_native_loader=True) and (native_loader=,
              no dataset) take their batches from the loader.
17. profiling — utils/profiling.py: a trace of one small ELS machine call
              (CIFAR10 scales) and 3 train steps holds machine_step_k{k}
              for each step's k and train_step 3 times; Timer within 2% of
              CUDA events (the flagship forward at batch 64).

The kernels line lists every variant checked; the variants no module path
reaches ('inbank' at 'highest'/'high', the bf16 exponential after fp32
dots, the 'default' kernel's K6), which the JAX package reaches only
through keywords or an environment override, carry their path launches
(0) and are exempt from the rule that each listed variant ran on the
paths.

Artifacts of phases 7, 8, 12, 13, 14 and 17 go to build/chip_smoke/ (git-ignored). The
card's name and power limit print as the first line, the kernels JSON
record as the second-to-last, and {"ok": true, "device": {...}} as the
last. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from convolutional_diffusion_tpu_torch import sampling as tsampling
from convolutional_diffusion_tpu_torch.calibration import calibrate
from convolutional_diffusion_tpu_torch.cli import els as cli_els
from convolutional_diffusion_tpu_torch.cli import sample as cli_sample
from convolutional_diffusion_tpu_torch.cli import train as cli_train
from convolutional_diffusion_tpu_torch.cli.common import load_model
from convolutional_diffusion_tpu_torch.cli.common import build_score_module
from convolutional_diffusion_tpu_torch.data import synthetic_dataset
from convolutional_diffusion_tpu_torch.models import DiffusionModel, MinimalResNet, MinimalUNet
from convolutional_diffusion_tpu_torch.models import layers as tlayers
from convolutional_diffusion_tpu_torch.ops import _build
from convolutional_diffusion_tpu_torch.ops import flash_score as fs
from convolutional_diffusion_tpu_torch.ops import prune as pr
from convolutional_diffusion_tpu_torch.ops.fp32 import true_fp32
from convolutional_diffusion_tpu_torch.parallel import mesh as pm
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
    BankLedger,
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
from convolutional_diffusion_tpu_torch.training import (
    TrainConfig,
    TrainState,
    draw_noise,
    global_loss,
    make_train_step,
    step_with_noise,
    train_diffusion,
)
from convolutional_diffusion_tpu_torch.utils.checkpoint import restore_checkpoint

CIFAR10_SCALES = [3, 3, 3, 3, 5, 5, 5, 7, 7, 7, 7, 9, 9, 11, 11, 13, 15, 17, 17, 17]
FULL_N = 50000  # the published bank depth (the JAX bench's 50k CIFAR10 bank)
# bank images of the RGB machines: cut from FULL_N so that the script, grown
# by phases variants, wide, the neural half, train, parallel and the
# analysis, stays within its time limit (with phases analysis, loader and
# profiling, 20000 took 1146.3 s and 15000 1198.7 s of 1200 on a host
# whose CPU phases ran slower: the host's share of a run varies by ~100 s
# between machines); printed as reduced
RGB_N = 10000
SEEDS = 8
TARGET_BLOCK = 65536
MODULE_BATCH = 256  # the JAX bench's ELS module batch size
CHECKED_K = (3, 9, 17)  # kernels held against the plain version at these k
TOL = 1e-3
# card vs CPU on the neural path at 'highest', beside TOL: true fp32 against
# true fp32 reads ~1e-6 on an H100 (a forward, a DDPM step), TF32 ~6e-4; the
# TF32 model must fall outside it, so TF32 reaching a convolution shows
FP32_TOL = 1e-5
DEFAULT_TOL = 4e-3  # the 'default' tier's own (tests/test_flash_score.py:407)
# card vs CPU on the small 'default' machines: above the readings (up to
# 1.81e-3 on an H100), below the upper range of one sweep's gap between the
# 'default' and 'high' tiers (6.7e-4 to 3.7e-3); the gap on the same machine
# prints beside it
DEVICES_DEFAULT_TOL = 2.5e-3
# the same for the small 16-channel 'default' machines: on the CPU alone,
# changing only the last bits of their split dots (the card's step-by-step
# sum against the exact sum, `exact_split_dot`) moves the 10-step machine's
# output by 1.13e-2 (RGB: 9.1e-4), and its gap to the 'high' tier is
# 1.12e-1; the hold sits between the card's reading (1.21e-2 on an H100)
# and the tier gap, and both witnesses print beside it in each run
DEVICES_WIDE_DEFAULT_TOL = 2.5e-2
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
# the variants 'mxu', 'inbank' at 'highest'/'high' and the bf16 exponential
# after fp32 dots, by the branch of `_kernel_body` that is theirs: the bf16 exponential after fp32 dots, 'mxu', 'mxu1'
# ('flash_score/bf16_exp/mxu1'), 'inbank' at 'highest'/'high'
NEW_VARIANT_LINE = (("/bf16_exp", "215"), ("/mxu1", "225"), ("/mxu", "292"),
                    ("/inbank", "240"))
# launch keys no module path reaches (the JAX package reaches them only
# through keywords or an environment override): checked and timed here,
# listed in the kernels line with their path launches (0), and not held to
# the rule that every listed variant ran on the paths
KEYWORD_ONLY = ("/bf16_exp", "flash_score/inbank", "flash_score_bf16x3/inbank",
                FAST + "/mxu/prune")
PRUNE_T = (0.05, 0.5, 0.95)  # t of phase prune; times at the first
STRESS_AT_BT = (0.99, 0.08)  # the stress problem's low-noise step
# a clustered build may hold one bank plus this much (k-means sample and
# distance blocks, the sort's ids): a second copy of the bank would not fit
BUILD_TRANSIENT = 4e9

# the neural half (phases neural, calibrate, cli_sample): the JAX bench's
# flagship conditional MinimalResNet (bench.py:111-114) and its 64x64 UNet
# (bench.py:142-146), each a 1000-step DDPM sampler call
FLAGSHIP = dict(channels=3, emb_dim=256, num_layers=8, mode="zeros", conditional=True,
                num_classes=10, kernel_size=3, lastksize=3)
# the bench's analytic count per image per step (bench.py:63-68): 8 residual
# convs 256 -> 256 3x3 on 32x32, the up- and down-projections, the
# embedding MLPs (~9.7 GFLOP)
FLAGSHIP_FLOPS_PER_IMG_STEP = (8 * 2 * 256 * 256 * 9 * 32 * 32 + 2 * 3 * 256 * 9 * 32 * 32
                               + 2 * 256 * 3 * 9 * 32 * 32 + 9 * 2 * 256 * 256)
UNET64 = dict(channels=3, fsizes=(64, 128, 256, 512), mode="zeros", conditional=True,
              num_classes=2, lastksize=3)
DDPM_STEPS = 1000
BUSY_STEPS = 20  # DDPM steps of the profiled window (device-busy share)
NEURAL_RUNS = 3  # timed DDPM calls of each flagship cell, interleaved
# the README calibration recipe the JAX bench times (bench.py:302-345):
# eight ELS modules at 'highest' on one bank ledger, module batch 16, N =
# 5000 synthetic 32x32x3 images, 10 seeds, 20 steps, the flagship
# unconditional
CALIB_KS = (3, 5, 7, 9, 11, 13, 15, 17)
CALIB_N = 5000
CALIB_SEEDS = 10
CALIB_BATCH = 16
# phase train: the flagship recipe (README cli.train recipe; bench.py:346-367)
# at batch 128 and the UNet-64 recipe (cli.train_64x64) at batch 64, timed
# over TRAIN_WINDOWS windows of TRAIN_STEPS chained steps after TRAIN_WARM
TRAIN_STEPS = 20
TRAIN_WINDOWS = 3
TRAIN_WARM = 3
TRAIN_GATE_BATCH = 8  # gates (a) and (d): the CPU side stays cheap
# gate (b): 200 steps at the recipe's lr
LOSS_FALL_N, LOSS_FALL_EPOCHS, LOSS_FALL_LR = 1280, 20, 1e-4
RESUME_STEPS = 5  # gate (c): 2 x 5 steps straight against 5 + restore + 5
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens"
PICKLE_ATOL, PICKLE_RTOL = 5e-5, 2e-4  # tests/test_convert_pickle.py:39


def source(name: str) -> str:
    """Kernel `name`'s CUDA source, as a path in the repo."""
    src = _build.CSRC / _build.KERNELS[name][0]
    return str(src.relative_to(_build.CSRC.parents[2]))


def value_kw(precision: str, k: int, c: int = 3) -> dict:
    """The value-strategy keywords the ELS module's sweeps take at k."""
    return els_value_kw(precision, k * k * c, center_index(k, c).start, c)


def kw_plan(kw, M, P, d, c=3, prune=False):
    """`fs.sweep_plan` of `fs.flash_score_update` with keywords `kw` on M
    query rows of d features against P bank rows with c value channels (a
    prune mask where `prune`)."""
    rps = kw.get("rows_per_seed")
    return fs.sweep_plan(kw["precision"], kw.get("fast_exp"), kw.get("v_strategy", "auto"), c,
                         M, rps or M, P, d, rps is not None, prune, kw.get("inbank_cols"))


def module_plan(precision: str, k: int, per_seed: bool = False, prune: bool = False,
                c: int = 3):
    """`fs.sweep_plan` of an ELS module sweep at k over one TARGET_BLOCK
    chunk (SEEDS seeds of 32 x 32 query rows)."""
    kw = dict(precision=precision, **value_kw(precision, k, c))
    if per_seed:
        kw["rows_per_seed"] = 32 * 32
    return kw_plan(kw, SEEDS * 32 * 32, TARGET_BLOCK, k * k * c, c, prune)


def replaces(name: str) -> str:
    """The TPU kernel branch (file:line) that launch-count key `name` ports."""
    if name in REPLACES:
        return REPLACES[name]
    return _TPU + next(line for part, line in NEW_VARIANT_LINE if part in name)


def keyword_only(name: str) -> bool:
    return any(part in name for part in KEYWORD_ONLY)


def kernel_record(name: str, rec: dict, launches: int) -> dict:
    """The kernels-line entry of launch-count key `name` (a kernel of
    ops._build, then its value strategy and fs.PER_SEED where they apply)."""
    kernel, sep, variant = name.partition("/")
    return {
        "name": _build.KERNELS[kernel][1] + sep + variant,  # the C symbol
        "route": "cuda",
        "source": source(kernel),
        "replaces": replaces(name),
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],  # memory-efficient attention (sdpa_io)
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


def plain_time(precision: str, fn):
    """(ms per call, the last call's result) of a plain version: 3 calls
    after a warm-up at 'highest'; one call at the tensor-core tiers, whose
    plain versions repeat the kernel's dot step by step in float64 (up to
    ~2.6 s a call at k = 17) and have no warm-up to do."""
    out = []
    timed = lambda: out.append(fn())  # noqa: E731
    ms = cuda_ms(timed, 3) if precision == "highest" else cuda_ms(timed, 1, warm=False)
    return ms, out[-1]


LN2 = math.log(2.0)


def kernel_call(*args, **kw):
    """One `fs.flash_score_update` call on `args` on the card; returns (its
    result, the positional and keyword arguments the wrapper handed
    `fs.sweep_kernel`, the kernel's own result in its convention)."""
    seen = []
    inner = fs.sweep_kernel

    def spy(*a, **k_):
        out = inner(*a, **k_)
        seen.append((a, k_, out))
        return out

    fs.sweep_kernel = spy
    try:
        got = fs.flash_score_update(*args, **kw)
    finally:
        fs.sweep_kernel = inner
    return (got, *seen[0])


def sdpa_inputs(q, bias, bank, values, dotscale: float):
    """The sweep's kernel inputs (q [M, d], bias [P] or [S, P], bank [P, d],
    values [P, c], dotscale) as the library yardstick's: the sweep is
    attention with an additive per-key bias in base 2 (logit = dotscale
    q.k + bias[p]; m + log2 s1 its log-sum-exp, s2 / s1 the softmax mean
    of V), so scale = dotscale ln 2 and attn_bias = bias ln 2, broadcast
    over the query rows (stride 0; per-seed weights are a batch of S with
    bias [S, 1, 1, P]). q and the bank are zero-padded to d4 (a multiple of
    4), V to c4, the bias row's storage to a multiple of 16. Returns
    (Q [S, 1, M / S, d4], K, V, attn_bias, scale)."""
    M, d = q.shape
    P, c = values.shape
    S = bias.shape[0] if bias.ndim == 2 else 1
    rows = M // S
    d4, c4, p16 = -(-d // 4) * 4, -(-c // 4) * 4, -(-P // 16) * 16
    Q = F.pad(q, (0, d4 - d)).view(S, 1, rows, d4)
    K = F.pad(bank, (0, d4 - d)).view(1, 1, P, d4).expand(S, 1, P, d4)
    V = F.pad(values, (0, c4 - c)).view(1, 1, P, c4).expand(S, 1, P, c4)
    store = torch.zeros(S, 1, 1, p16, dtype=q.dtype, device=q.device)
    store[..., :P] = bias.view(S, 1, 1, P) * LN2
    return Q, K, V, store[..., :P].expand(S, 1, rows, P), dotscale * LN2


def sdpa_state(out, lse, qn_s, c: int):
    """The yardstick's outputs (out [S, 1, rows, c4], natural-log lse
    [S, 1, >= rows]) as the wrapper's state of the same sweep: m = lse less
    the per-row offset qn_s = |q|^2 / (2 b^2) the wrapper moves out of the
    sweep, s1 = 1, s2 = the mean."""
    S, _, rows, _ = out.shape
    M = S * rows
    return (lse[..., :rows].reshape(M) - qn_s, torch.ones_like(qn_s),
            out[..., :c].reshape(M, c))


def sdpa_io(args, kw, c):
    """The library yardstick of the sweep `fs.flash_score_update(*args, ...,
    **kw)`: PyTorch's memory-efficient attention
    (`torch.ops.aten._scaled_dot_product_efficient_attention`, CUTLASS's
    3xTF32 on fp32 inputs) on the kernel's own inputs (`sdpa_inputs`;
    'inbank' takes the bank's center columns as V; the op takes the bias
    broadcast over the rows, stride 0). Returns (call, to_state): call()
    runs the op, to_state(its outputs) is `sdpa_state`."""
    _, (q, bias, bank, values, dotscale, *_), k_, _ = kernel_call(
        *args, empty_state(args[0].shape[0], c), **kw)
    if values is None:
        values = bank[:, k_["col0"]:k_["col0"] + c]
    Q, K, V, ab, scale = sdpa_inputs(q, bias, bank, values, dotscale)
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    qn_s = args[1] * (1.0 / (2.0 * fs._scalar(args[7]) ** 2)).to(q.device)
    return (lambda: op(Q, K, V, ab, True, 0.0, False, scale=scale),
            lambda outs: sdpa_state(outs[0], outs[1], qn_s, c))


def library_time(tag, key, k, args, kw, c, plain_out, rows=None, ref="the plain version") -> float:
    """The library yardstick's ms (CUDA events, 5 calls after a warm-up) on
    the sweep's inputs, and its distance from `ref`'s result `plain_out`
    (over `rows` where that ran on a subset; rows that admitted no patch
    left out), printed: the yardstick is timed, never gated, and the port
    never calls it."""
    call, to_state = sdpa_io(args, kw, c)
    ms = cuda_ms(call, 5)
    got = pick(to_state(call()), rows)
    keep = plain_out[1] > 0
    e_lse, e_mean, _ = compare(tuple(x[keep] for x in got), tuple(x[keep] for x in plain_out))
    print(f"[{tag}] {key} k={k}: library yardstick (memory-efficient attention) "
          f"{ms:.3f} ms; from {ref} (information) lse rel {e_lse:.2e}, "
          f"mean rel {e_mean:.2e}", flush=True)
    return ms


def grid_line(plan) -> str:
    """The splits and grid of a launch's plan."""
    return (f"{len(plan.splits)} splits of {plan.splits[0][1]} bank rows, grid {plan.grid} = "
            f"{math.prod(plan.grid)} blocks")


def check_logits(key, k, t, args, kw, c=3):
    """The logits are the parent's: one `fs.sweep_kernel` launch from the
    empty state (the variant's own strategy, exponential and c) returns m =
    the row max of its logits. On K1's loop m must equal, bit for bit, the
    row max of `fs.fp32_logits_in_order` (K1's fp32 order, over
    `row_subset`), in every strategy and with either exponential. On the
    split-dot loop, every mode of K2 and of the 'default' kernel must equal
    K2's per-row launch (c = 3) on every row: one dot for all modes. K2's
    own bits are held against the parent commit's by `kernel_ab.py` (the m
    digests of one call), and its distance from the plain `fs._split_dot`
    prints here (that version takes each tensor-core step as rounded toward
    zero, which the card does in ~97% of inexact steps,
    `ops.k2_numerics`)."""
    _, (q, bias, bank, values, dotscale, *_), k_, _ = kernel_call(
        *args, empty_state(args[0].shape[0], c), **kw)
    M = q.shape[0]
    m = fs.sweep_kernel(q, bias, bank, values, dotscale, *empty_state(M, c), **k_)[0]
    r = row_subset(M)
    what = f"{key} k={k} t={t} c={c}"
    if k_["precision"] == "highest":
        ref = fs.fp32_logits_in_order(q[r], bank, dotscale, bias).amax(1)
        same = int((m[r] == ref).sum())
        print(f"[logits] {what}: m_out of a launch from the empty state == the "
              f"row max of fs.fp32_logits_in_order on {same} of {r.numel()} rows", flush=True)
        if same != r.numel():
            fail(f"{key}'s logits moved at k={k} t={t}")
        return
    k2 = fs.sweep_kernel(q, bias, bank, torch.zeros(bank.shape[0], 3, device="cuda"),
                         dotscale, *empty_state(M, 3), precision="high")[0]
    same = int((m == k2).sum())
    line = (f"[logits] {what}: m_out of a launch from the empty state == K2's per-row "
            f"launch's on {same} of {M} rows")
    if k_["precision"] == "high" and k_["strategy"] == "vpu" and c <= fs.MAX_CHANNELS:
        qh, ql = fs._split_bf16(q[r])
        ref = fs._add_bias(fs._split_dot(qh.double(), ql.double(), *fs._split_bf16(bank))
                           .double() * dotscale, bias.double()).float().amax(1)
        line += (f" (K2 itself); == the row max of fs._split_dot (information) on "
                 f"{int((m[r] == ref).sum())} of {r.numel()} rows")
    print(line, flush=True)
    if same != M:
        fail(f"{key}'s logits moved at k={k} t={t}")


def bound(plan, M: int, P: int, d: int, S: int = 1, live=None):
    """Least time on the card: the larger of the operations over their
    peaks and the bytes over the memory rate (each input read once, each
    output written once). Three units run side by side, and the busiest
    sets the bound: the fp32 pipe, the tensor cores and the SFU, which
    takes one exponential per pair (M P exp2 at SFU_RATE). Only the work the
    function needs is counted, never the padding a kernel's tiles add.
    The sweep's `plan` gives the tier, the value strategy, the exponential
    and c. 'highest': 2 M P d for the fp32 dots plus (6 + 2c) per pair for
    logit, max, exp2 and the sums at the fp32 peak. 'high': the three bf16
    products, 3 * 2 M P d, at the bf16 tensor-core peak, and the per-pair
    work at the fp32 peak. The bf16 exponential adds the ln 2 multiply per
    pair. The value
    sums: 'vpu' 2 c per pair on the fp32 pipe; 'mxu' the product e @ V,
    2 M P c, on the fp32 pipe after the fp32 exp2 and on the bf16 tensor
    cores with the bf16 exponential; 'mxu1' the product e @ [V | 1],
    2 M P (c + 1), on the tensor cores, s1 included; 'inbank' 2 M P c on
    the fp32 pipe after fp32 dots, e @ [K | 1] on the tensor cores after
    split dots, 2 M P (c + 1) with the bf16 exponential and three split
    products, 3 x 2 M P (c + 1), without; 'inbank' reads no values.
    Per-seed weights (K5, S seeds) need the work of the live (seed, tile)
    pairs only: `live`, the bool [S, ceil(P / 128)] flags of
    `fs.live_tiles_plain`, scales the operations by the live pairs' share
    and the bank and value bytes by the share of tiles some seed admits;
    the weight bytes are S * P. Without `live`, every pair counts."""
    precision, strategy, fast, c = plan.tier, plan.strategy, plan.fast, plan.c
    elem = (6 + (1 if fast else 0)) * M * P  # logit, max, sums; ln 2 multiply
    tc = 0 if precision == "highest" else 3 * 2 * M * P * d
    if precision == "highest":
        elem += 2 * M * P * d
    if strategy == "vpu" or (strategy == "mxu" and not fast) or (
            strategy == "inbank" and precision == "highest"):
        elem += 2 * c * M * P
    elif strategy == "mxu":
        tc += 2 * M * P * c
    else:  # 'mxu1', 'inbank' after split dots: s1 rides the product
        elem -= M * P
        tc += (1 if fast else 3) * 2 * M * P * (c + 1)
    pairs = 1.0 if live is None else live.float().mean().item()
    rows = 1.0 if live is None else live.any(0).float().mean().item()
    t_sfu = M * P / SFU_RATE * 1e3
    t_ops = max(tc / PEAK_BF16 * 1e3, elem / PEAK_FP32 * 1e3, t_sfu) * pairs
    values = 0 if strategy == "inbank" else P * c
    nbytes = 4 * (M * d + M + rows * (P * d + P + values) + S * P + 2 * M * (2 + c))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def walk_check(tag, key, k, args, kw, c=3):
    """K5's walk, gated: one launch of the sweep `fs.flash_score_update(
    *args, ..., **kw)` (per-seed weights) from the empty state, through
    `fs.sweep_kernel` with `tile_counts`, and the tiles each block walked
    against its seed's live tiles in its split by the plain flags
    (`fs.live_tiles_plain` of the kernel's bias): they must be equal block
    by block, so the walked fraction equals the live fraction. Prints both
    fractions and the spread of walked tiles over the blocks; returns the
    flags."""
    _, (q, bias, bank, values, dotscale, *_), k_, _ = kernel_call(
        *args, empty_state(args[0].shape[0], c), **kw)
    M, P = q.shape[0], bank.shape[0]
    S = bias.shape[0]
    plan = kw_plan(kw, M, P, q.shape[1], c)
    split_rows, nsplit, grid = plan.splits[0][1], len(plan.splits), plan.grid
    counts = torch.full((math.prod(grid),), -1, dtype=torch.int32, device="cuda")
    fs.sweep_kernel(q, bias, bank, values, dotscale, *empty_state(M, c), **k_,
                    tile_counts=counts)
    torch.cuda.synchronize()
    live = fs.live_tiles_plain(bias)
    per = -(-split_rows // fs.FAST_TILE)  # tiles per split (all but the last)
    want = torch.stack([live[:, z * per:(z + 1) * per].sum(1) for z in range(nsplit)])
    want = want[:, :, None].expand(nsplit, S, grid[0]).reshape(-1)  # x fastest, then seed
    got = counts.long()
    walked, total = got.sum().item(), grid[0] * live.numel()
    print(f"[{tag}] {key} k={k}: walked {walked} of {total} (block, tile) pairs "
          f"({walked / total:.4f}); live (seed, tile) pairs by the flags "
          f"{live.float().mean().item():.4f}; tiles per block min {got.min().item()}, "
          f"median {got.median().item()}, max {got.max().item()} of {per}, "
          f"{(got == 0).float().mean().item():.1%} of {got.numel()} blocks walk none",
          flush=True)
    if not torch.equal(got, want.to(got.device)):
        fail(f"{key} at k={k}: the tiles its blocks walked are not their seeds' live tiles")
    return live


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


def demangle(names):
    """C++ names as cu++filt (the CUDA toolkit's) or c++filt gives them,
    without their parameter lists; the mangled names where neither runs."""
    for tool in (shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt", "c++filt"):
        try:
            out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                                 text=True, timeout=60, check=True).stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            continue
        if len(out) == len(names):
            out = [n.removeprefix("void ").replace("(anonymous namespace)::", "")
                   for n in out]
            return [n[:n.index(">(") + 1] if ">(" in n else n.split("(")[0] for n in out]
    return list(names)


def ptxas_table(log: str):
    """[(entry, registers, spill stores, spill loads, stack bytes)] of every
    kernel instantiation in an nvcc -Xptxas -v log."""
    rows, entry, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        words = line.replace(",", " ").split()
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in words and "stores" in words:
            frame = (int(words[words.index("stack") - 2]), int(words[words.index("stores") - 3]),
                     int(words[words.index("loads") - 3]))
        elif entry is not None and "Used" in words and "registers" in words:
            regs = int(words[words.index("Used") + 1])
            rows.append((entry, regs, frame[1], frame[2], frame[0]))
            entry, frame = None, (0, 0, 0)
    return rows


def phase_build():
    """Build the three kernels (one nvcc each, started together) and print
    ptxas's registers, spills and stack for every instantiation, and any
    note of ptxas serialising the wgmma products."""
    for name, built in _build.build_all(list(TIER_OF)).items():
        table = ptxas_table(built.log)
        for line in built.log.splitlines():
            if "Performance Loss" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
        for (_, regs, st, ld, stack), entry in zip(table, demangle([t[0] for t in table])):
            print(f"[ptxas] {source(name)} {entry}: {regs} registers, spill stores {st} "
                  f"bytes, spill loads {ld} bytes, stack {stack} bytes", flush=True)
        how = f"built in {built.seconds:.1f} s" if built.seconds else "reused an identical build"
        regs = [t[1] for t in table]
        regs = f"{min(regs)}-{max(regs)}" if regs else "not in the log"
        print(f"[build] {source(name)}: {how}; {len(table)} instantiations, registers "
              f"{regs}, spill stores {sum(t[2] for t in table)} bytes", flush=True)
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


def plain_with(name, fn, *args, **kw):
    """`fs.flash_score_update_plain` with its dot function `fs.<name>`
    replaced by `fn` for the call."""
    step = getattr(fs, name)
    setattr(fs, name, fn)
    try:
        return fs.flash_score_update_plain(*args, **kw)
    finally:
        setattr(fs, name, step)


def plain_exact(*args, **kw):
    """`fs.flash_score_update_plain` over the exact split sum: the TPU
    kernel's dot as the JAX package states it, independent of how the
    tensor cores accumulate. The plain version proper (`fs._split_dot`)
    repeats the card's step-by-step rounding; this one stands apart from
    it."""
    return plain_with("_split_dot", exact_split_dot, *args, **kw)


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
                    kw = dict(precision=prec, **vkw)
                    plan = kw_plan(kw, M, P, g.d)
                    key = plan.key
                    rec = recs.setdefault(key, {"max_abs_err": 0.0})
                    vals = None if plan.strategy == "inbank" else ctr
                    args = (xq, qn, p, pn, vals, w, at, bt)
                    cargs = (xc, (xc * xc).sum(-1), *args[2:])
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
                        check_logits(key, k, t, args, kw)
                    if t != 0.5:
                        continue
                    # timing: each variant; the one the ELS module takes at
                    # this k also for the machines' kernel time
                    first = vkw == variants[name][0]
                    ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
                    plain_ms, plain_out = plain_time(
                        prec, lambda: fs.flash_score_update_plain(*args, empty_state(M, c), **kw))
                    lib_ms = library_time("kernel", key, k, args, kw, c, plain_out)
                    b_ms, b_by = bound(plan, M, P, g.d)
                    line = (f"[kernel] {key} k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, "
                            f"plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound "
                            f"{b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound")
                    line += f"; {grid_line(plan)}"
                    if prec == "highest":
                        with true_fp32():
                            mm_ms = cuda_ms(lambda: torch.matmul(xq, p.T), 5)
                        line += f", fp32 matmul Q.K^T alone (partial yardstick) {mm_ms:.3f} ms"
                    elif first:
                        ms_center[name][k] = cuda_ms(
                            lambda: fs.flash_score_update(*cargs, empty_state(mc, c), **kw), 5)
                        line += f"; at the bbELS center's M={mc}: {ms_center[name][k]:.3f} ms"
                    if prec == "default" and first:
                        k2 = ms_by_k["flash_score_bf16x3"][k]
                        line += (f"; K2 on the same inputs (information) {k2:.3f} ms, "
                                 f"{ms / k2:.3f}x")
                    print(line, flush=True)
                    if first:
                        ms_by_k[name][k] = ms
                    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k,
                               library_ms=lib_ms)
            if "flash_score" in outs:  # k in CHECKED_K
                e_lse, e_mean, _ = compare(outs["flash_score_bf16x3"], outs["flash_score"])
                print(f"[kernel] tier gap k={k} t={t}, K2 'high' vs K1 'highest' "
                      f"(information, not a gate): lse rel {e_lse:.2e}, mean rel "
                      f"{e_mean:.2e}", flush=True)
                fast = outs.get(module_plan("default", k).key)
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
    plain_ms, plain_out = plain_time(
        "default", lambda: fs.flash_score_update_plain(*args, empty_state(M, c),
                                                       precision="default"))
    lib_ms = library_time("mxu1", key, k, args, dict(precision="default"), c, plain_out)
    vpu_ms = cuda_ms(lambda: fs.flash_score_update(
        *args, empty_state(M, c), precision="default", v_strategy="vpu"), 5)
    b_ms, b_by = bound(kw_plan(dict(precision="default"), M, P, g.d), M, P, g.d)
    print(f"[mxu1] {key} k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound; "
          f"'vpu' on the same inputs (information) {vpu_ms:.3f} ms", flush=True)
    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k, library_ms=lib_ms)


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
                key = module_plan(prec, k, per_seed=True).key
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
                plain_ms, plain_out = plain_time(
                    prec, lambda: fs.flash_score_update_plain(*args, empty_state(M, c), **kw))
                lib_ms = library_time("k5", key, k, args, kw, c, plain_out)
                one_d_ms = cuda_ms(lambda: fs.flash_score_update(
                    xq, qn, p, pn, vals, w[0].contiguous(), at, bt, empty_state(M, c),
                    **kw1), 5)

                def grouped():
                    for s in range(SEEDS):
                        r = slice(s * rps, (s + 1) * rps)
                        fs.flash_score_update(xq[r], qn[r], p, pn, vals, w[s], at, bt,
                                              empty_state(rps, c), **kw1)

                grouped_ms = cuda_ms(grouped, 3)
                live = walk_check("k5", key, k, args, kw)
                plan = kw_plan(kw, M, P, g.d)
                b_ms, b_by = bound(plan, M, P, g.d, S=SEEDS, live=live)
                all_ms, _ = bound(plan, M, P, g.d, S=SEEDS)
                grid = f"; {grid_line(plan)}"
                print(f"[k5] {key} k={k} d={g.d} M={M} P={P}: kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound of the live "
                      f"pairs {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of it; all-pairs bound "
                      f"{all_ms:.3f} ms; 1-D kernel on the same inputs {one_d_ms:.3f} ms; "
                      f"grouped alternative (information): 8 launches at M={rps} "
                      f"{grouped_ms:.3f} ms{grid}", flush=True)
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k,
                           library_ms=lib_ms)
        del p, ctr, pn
    return recs


def prune_variants(k: int):
    """(launch key, keywords) of each kernel with a prune mask at k: K1, K2
    and the 'default' kernel in the variant the ELS module takes at k."""
    return [(module_plan(prec, k, prune=True).key, dict(precision=prec, **value_kw(prec, k)))
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
    got, a, _, out = kernel_call(*args, **kw)
    return got, a[5:8], out


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


def time_masked(tag, key, k, what, args, M, P, d, mask, kw, rec, c=3):
    """ms per launch with the mask and without, the plain version's with
    the mask, and the bound of the unskipped work; into `rec`."""
    skip = mask.float().mean().item()
    ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), prune_mask=mask,
                                               **kw), 5)
    ms_full = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
    plain_ms, plain_out = plain_time(kw["precision"], lambda: fs.flash_score_update_plain(
        *args, empty_state(M, c), prune_mask=mask, **kw))
    # the yardstick computes the unmasked function (a per-key bias cannot
    # skip per query block), within the 1e-5 masked-vs-unmasked gate here
    lib_ms = library_time(tag, key, k, args, kw, c, plain_out)
    b_ms, b_by = bound(kw_plan(kw, M, P, d, c, prune=True), M, P, d)
    b_ms *= 1.0 - skip
    print(f"[{tag}] {key} k={k} d={d} M={M} P={P} {what}: {skip:.2%} skipped; kernel "
          f"{ms:.3f} ms with the mask, {ms_full:.3f} ms without ({ms / ms_full:.3f}x; "
          f"1 - skip {1.0 - skip:.3f}); plain {plain_ms:.3f} ms; bound of the unskipped "
          f"work {b_ms:.3f} ms ({b_by})", flush=True)
    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k, skip=skip,
               library_ms=lib_ms)


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


# Phase variants (the lines tagged [variants]): the matrix value sums 'mxu'
# on the 16-channel path, 'inbank' at 'highest'/'high', and the exponential
# apart from the tier.
WIDE_C = 16  # channels of the wide path (phase wide)
# bank images of the wide 'highest' machine (the 'high' and 'default' ones
# take half): cut from FULL_N (depth), printed as reduced
WIDE_N = 8000
WIDE_T = (0.05, 0.5, 0.95)
# from this d the plain versions run on a row subset: the split dots' sum
# step by step, K1's in its own order (both cost seconds a call there)
SUBSET_FROM_D = 200


def launched(fn, key):
    """fn() must launch exactly one kernel, under `key`; returns its result."""
    before = dict(fs.flash_score_update.launches)
    out = fn()
    torch.cuda.synchronize()
    ran = {k_: n - before[k_] for k_, n in fs.flash_score_update.launches.items()
           if n != before[k_]}
    if ran != {key: 1}:
        fail(f"expected one {key} launch, got {ran}")
    return out


def row_subset(M: int, rps: int | None = None):
    """Every eighth 64-row query block (every eighth seed's rows with
    per-seed weights): a plain split-dot sweep at large d costs seconds a
    call, and rows are independent, so the kernel's rows are held against
    the plain version's over these rows."""
    if rps is not None:
        return torch.arange(0, M, device="cuda").view(-1, rps)[::8].reshape(-1)
    return torch.arange(0, M, device="cuda").view(-1, 64)[::8].reshape(-1)


def plain_in_order(*args, **kw):
    """`fs.flash_score_update_plain` with K1's fp32 summation order
    (`fs.fp32_logits_in_order`): K1's plain version at large d, where the
    logit scale turns the difference between two fp32 orders of the same
    dot into more than the gate (the BLAS order's distance is printed
    beside it)."""
    return plain_with("_fp32_logits", fs.fp32_logits_in_order, *args, **kw)


def plain_on(rows, args, state, kw, rps=None, plain=None):
    """The plain version (`plain`, default fs.flash_score_update_plain) on
    query rows `rows` only (1-D weights, or whole seeds with per-seed
    weights)."""
    plain = plain or fs.flash_score_update_plain
    if rows is None:
        return plain(*args, state, **kw)
    q, qn, *rest = args
    st = tuple(x[rows] for x in state)
    if rps is not None:
        w = rest[3]
        seeds = torch.unique(rows // rps)
        rest = list(rest)
        rest[3] = w[seeds].contiguous()
    return plain(q[rows], qn[rows], *rest, st, **kw)


def pick(state, rows):
    return state if rows is None else tuple(x[rows] for x in state)


def exact_fp32_logits(q, k, dotscale, bias):
    """(q @ k^T) * dotscale + bias summed exactly (float64), rounded once
    to float32."""
    return fs._add_bias((q.double() @ k.double().T) * dotscale, bias.double()).float()


def plain_exact_highest(*args, **kw):
    """The plain version with the bf16 exponential after fp32 dots taken
    exactly (`exact_fp32_logits` in place of K1's summation order): the
    exact-sum witness at 'highest' (x = logit - m is rounded to bf16, so
    the dot's last bits matter as at 'default')."""
    return plain_with("fp32_logits_in_order", exact_fp32_logits, *args, **kw)


def variant_case(tag, key, k, t, args, M, c, kw, rec, chain=True, rows=None,
                 exact=False, rps=None):
    """One variant's gates at (k, t): one call against the plain version
    (on `rows` where given; K1's in its own summation order there, the
    BLAS order's distance printed), a two-call chain and a carried state
    with sentinel rows (chain), the bf16 exponential also against the exact
    sum at the tier's 4e-3 (exact). Returns the kernel's one-call state."""
    got = launched(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), key)
    in_order = (rows is not None and kw["precision"] == "highest"
                and not kw.get("fast_exp"))
    want = plain_on(rows, args, empty_state(M, c), kw, rps,
                    plain_in_order if in_order else None)
    cases = {"one call" + ("" if rows is None else f", {rows.numel()} rows")
             + (", K1's summation order" if in_order else ""): (pick(got, rows), want)}
    if in_order:
        blas = plain_on(rows, args, empty_state(M, c), kw, rps)
        e_lse, e_mean, _ = compare(pick(got, rows), blas)
        print(f"[{tag}] {key} k={k} t={t} vs the plain version in the BLAS order "
              f"(information): lse rel {e_lse:.2e}, mean rel {e_mean:.2e}", flush=True)
    if chain:
        q, qn, p, pn, vals, w = args[:6]
        P = p.shape[0]
        h = P // 2 + 37  # not a tile multiple
        v = (lambda a, b: None) if vals is None else (lambda a, b: vals[a:b])
        wv = (lambda a, b: w[..., a:b].contiguous())
        outs = []
        for fn in (fs.flash_score_update, fs.flash_score_update_plain):
            half = fn(q, qn, p[:h], pn[:h], v(0, h), wv(0, h), *args[6:8],
                      empty_state(M, c), **kw)
            outs.append(fn(q, qn, p[h:], pn[h:], v(h, P), wv(h, P), *args[6:8], half,
                           **kw))
        cases["two calls, kernel vs plain"] = tuple(outs)
        st = tuple(x.clone() for x in got)
        st[0][::7], st[1][::7], st[2][::7] = fs.NEG_INF, 0.0, 0.0
        cases["sentinel rows in state"] = (fs.flash_score_update(*args, st, **kw),
                                           fs.flash_score_update_plain(*args, st, **kw))
    check_cases(tag, key, k, t, cases, rec)
    if exact:
        if kw["precision"] == "highest":
            want_x = plain_exact_highest(*args, empty_state(M, c), **kw)
        else:
            want_x = plain_exact(*args, empty_state(M, c), **kw)
        e_lse, e_mean, _ = compare(got, want_x)
        EXACT_WORST[key] = max(EXACT_WORST.get(key, 0.0), e_lse, e_mean)
        print(f"[{tag}] {key} k={k} t={t} vs the exact dot sum (float64): lse rel "
              f"{e_lse:.2e}, mean rel {e_mean:.2e} (tol {DEFAULT_TOL:g})", flush=True)
        if not (e_lse <= DEFAULT_TOL and e_mean <= DEFAULT_TOL):
            fail(f"{key} is past the tier's {DEFAULT_TOL:g} from the exact sum at k={k}")
    return got


def variant_time(tag, key, k, args, M, P, d, c, kw, rec, rows=None, S=1, rps=None,
                 live=None):
    """ms per launch (CUDA events, 5 after a warm-up), the plain version's
    ms (over `rows` where given, scaled to M rows: information) and the
    bound of the function's work (K5: of the `live` pairs'); into `rec`."""
    ms = cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, c), **kw), 5)
    plan = kw_plan(kw, M, P, d, c)
    if plan.tier == "highest" and not plan.fast:
        rows = None  # the plain version's own (BLAS) time over all rows
    plain_ms, plain_out = plain_time(kw["precision"] if rows is None else "high",
                                     lambda: plain_on(rows, args, empty_state(M, c), kw, rps))
    lib_ms = library_time(tag, key, k, args, kw, c, plain_out, rows)
    if rows is not None:
        plain_ms *= M / rows.numel()
    b_ms, b_by = bound(plan, M, P, d, S=S, live=live)
    print(f"[{tag}] {key} k={k} d={d} M={M} P={P} c={c}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms{'' if rows is None else ' (row subset, scaled)'}, library "
          f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound",
          flush=True)
    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k=k, library_ms=lib_ms)
    return ms


def chunk_inputs(images, k, t, gen):
    """One full TARGET_BLOCK chunk of `images` at k with zero-weight rows,
    and queries from SEEDS noised seeds at t: (args without the state, the
    chunk's geometry)."""
    c, M = images.shape[-1], SEEDS * 32 * 32
    g = bank_geometry(images.shape[0], 32, 32, c, k, TARGET_BLOCK)
    imgs = images[: g.cs]
    p, ctr, pn = chunk_patches(imgs, k)
    w_img = torch.full((g.cs,), 1.0 / (MODULE_BATCH * g.per_img), device="cuda")
    w_img[-max(1, g.cs // 8):] = 0.0
    w = w_img.repeat_interleave(g.per_img)
    beta = cosine_noise_schedule(t)
    at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
    x = at.item() * imgs[:SEEDS] + bt.item() * torch.randn(
        imgs[:SEEDS].shape, generator=gen, device="cuda")
    xq = extract_patches(pad_image(x, k // 2, "circular"), k).reshape(M, g.d)
    return (xq, (xq * xq).sum(-1), p, pn, ctr, w, at, bt), g


def variant_kw(precision, strategy, k, c, fast=None):
    kw = dict(precision=precision, v_strategy=strategy)
    if fast is not None:
        kw["fast_exp"] = fast
    if strategy == "inbank":
        kw["inbank_cols"] = (center_index(k, c).start, c)
    return kw


def no_values(args, kw):
    """args with values None for 'inbank' (it reads the bank's columns)."""
    return args if kw.get("v_strategy") != "inbank" else (*args[:4], None, *args[5:])


def phase_variants(images_dev, images16_dev, gen):
    """'mxu', 'inbank' and the bf16-exp variants against their plain versions
    (see the module docstring, phase kernel / k5 / prune); returns (the
    JSON numbers by launch key, the wide 'mxu' per-launch ms by kernel and
    k at M = 8192)."""
    recs, wide_ms = {}, {}
    # (1) 'mxu' on the 16-channel path, every tier, k in CHECKED_K, every t;
    # per-launch times at every k of the schedule (the wide machines' sum)
    for k in sorted(set(CIFAR10_SCALES)):
        for t in WIDE_T if k in CHECKED_K else (0.5,):
            args, g = chunk_inputs(images16_dev, k, t, gen)
            M, P = args[0].shape[0], args[2].shape[0]
            for precision in ("highest", "high", "default"):
                kw = dict(precision=precision)  # 'auto' takes 'mxu' at c = 16
                plan = kw_plan(kw, M, P, g.d, WIDE_C)
                key = plan.key
                rec = recs.setdefault(key, {"max_abs_err": 0.0})
                rows = row_subset(M) if g.d >= SUBSET_FROM_D else None
                if k in CHECKED_K:
                    variant_case("variants", key, k, t, args, M, WIDE_C, kw, rec,
                                 chain=t == 0.5 and rows is None, rows=rows,
                                 exact=precision == "default")
                    if t == 0.5:
                        check_logits(key, k, t, args, kw, c=WIDE_C)
                if t == 0.5:
                    if k in CHECKED_K:
                        wide_ms.setdefault(key, {})[k] = variant_time(
                            "variants", key, k, args, M, P, g.d, WIDE_C, kw, rec, rows)
                    else:  # no plain run here: the yardstick is held against the kernel
                        wide_ms.setdefault(key, {})[k] = cuda_ms(
                            lambda: fs.flash_score_update(*args, empty_state(M, WIDE_C),
                                                          **kw), 5)
                        got = fs.flash_score_update(*args, empty_state(M, WIDE_C), **kw)
                        lib_ms = library_time("variants", key, k, args, kw, WIDE_C, got,
                                              ref="the kernel")
                        b_ms, b_by = bound(plan, M, P, g.d)
                        print(f"[variants] {key} k={k} d={g.d} M={M} P={P} c={WIDE_C}: "
                              f"kernel {wide_ms[key][k]:.3f} ms, library {lib_ms:.3f} ms, "
                              f"bound {b_ms:.3f} ms ({b_by}), {b_ms / wide_ms[key][k]:.1%} of "
                              f"bound", flush=True)
            del args
    # (2) 'mxu' at c = 9 and 48 (k = 3), and forced at c = 3 against 'vpu'
    for c in (9, 48):
        ds_c = synthetic_dataset(num_samples=80, image_size=32, num_channels=c, seed=c)
        imgs = torch.from_numpy(ds_c.images).cuda()
        args, g = chunk_inputs(imgs, 3, 0.5, gen)
        for precision in ("highest", "high", "default"):
            kw = dict(precision=precision, v_strategy="mxu")
            key = kw_plan(kw, args[0].shape[0], args[2].shape[0], g.d, c).key
            variant_case("variants", key, f"3 c={c}", 0.5, args, args[0].shape[0], c, kw,
                         recs.setdefault(key, {"max_abs_err": 0.0}))
        del args, imgs
    args, g = chunk_inputs(images_dev, 3, 0.5, gen)
    M, P = args[0].shape[0], args[2].shape[0]
    for precision in ("highest", "high", "default"):
        kw = dict(precision=precision, v_strategy="mxu")
        key = kw_plan(kw, M, P, g.d).key
        got = variant_case("variants", key, "3 c=3", 0.5, args, M, 3, kw,
                           recs.setdefault(key, {"max_abs_err": 0.0}))
        vpu = fs.flash_score_update(*args, empty_state(M, 3), precision=precision,
                                    v_strategy="vpu")
        tol = DEFAULT_TOL if precision == "default" else TOL
        check_cases("variants", key + " vs 'vpu'", 3, 0.5, {"forced 'mxu' at c=3": (got, vpu)},
                    {"max_abs_err": 0.0}, tol=tol)
    # (3) 'inbank' at 'highest' and 'high' (c = 3, k = 3, 5); (4) the bf16
    # exponential after fp32 dots in every strategy (k = 3, 9); (5) 'high'
    # with the bf16 exponential and 'default' without
    cases = [(variant_kw(prec, "inbank", k, 3), k, False)
             for prec in ("highest", "high") for k in (3, 5)]
    cases += [(variant_kw("highest", strategy, k, 3, fast=True), k, True)
              for strategy in ("vpu", "mxu1", "inbank", "mxu") for k in (3, 9)]
    cases += [(variant_kw(prec, strategy, 3, 3, fast=prec == "high"), 3, prec == "high")
              for prec in ("high", "default") for strategy in ("vpu", "inbank")]
    for i, (kw, k, bf16_exp) in enumerate(cases):
        key = kw_plan(kw, M, TARGET_BLOCK, k * k * 3).key
        # the routed cases (5) run variants of earlier slices, whose numbers
        # come from phase kernel: their own are printed only
        rec = recs.setdefault(key, {"max_abs_err": 0.0}) if i < 12 else {"max_abs_err": 0.0}
        for t in WIDE_T:
            args, g = chunk_inputs(images_dev, k, t, gen)
            args = no_values(args, kw)
            rows = row_subset(M) if g.d >= SUBSET_FROM_D else None
            variant_case("variants", key, k, t, args, M, 3, kw, rec,
                         chain=t == 0.5 and rows is None, rows=rows, exact=bf16_exp)
            if t == 0.5:
                check_logits(key, k, t, args, kw)
                variant_time("variants", key, k, args, M, args[2].shape[0], g.d, 3, kw,
                             rec, rows=rows)
    # (6) K5: per-seed weights (8 seeds of 1024 rows, label-filtered) in each
    # new variant; one K5 launch against 8 one-seed 1-D launches (1e-6)
    k5 = [(dict(precision=prec), WIDE_C, k) for prec in ("highest", "high", "default")
          for k in (3, 9)]
    k5 += [(kw, 3, k) for kw, k, _ in cases[:4] + cases[4:12:2]]
    for kw, c, k in k5:
        imgs = images16_dev if c == WIDE_C else images_dev
        args, g = chunk_inputs(imgs, k, 0.5, gen)
        args = no_values(args, kw)
        rps = 32 * 32
        labels = torch.arange(g.cs, device="cuda") % 10
        w = per_seed_weights(labels, [s % 10 for s in range(SEEDS - 1)] + [10], g)
        args = (*args[:5], w, *args[6:])
        kw5 = dict(kw, rows_per_seed=rps)
        key = kw_plan(kw5, M, args[2].shape[0], g.d, c).key
        rec = recs.setdefault(key, {"max_abs_err": 0.0})
        rows = row_subset(M, rps) if g.d >= SUBSET_FROM_D else None
        got = variant_case("variants", key, k, 0.5, args, M, c, kw5, rec, chain=rows is None,
                           rows=rows, rps=rps)
        diff = 0.0
        for s_ in range(SEEDS - 1):
            r = slice(s_ * rps, (s_ + 1) * rps)
            one = fs.flash_score_update(args[0][r], args[1][r], *args[2:5],
                                        w[s_].contiguous(), *args[6:8],
                                        empty_state(rps, c), **kw)
            diff = max(diff, rel(got[2][r], one[2]), rel(got[1][r], one[1]))
        print(f"[variants] {key} k={k}: one K5 launch vs one-seed 1-D launches, max "
              f"rel difference {diff:.2e} (gate 1e-6)", flush=True)
        if diff > 1e-6:
            fail(f"{key} differs from the one-seed launches at k={k}")
        dead = slice((SEEDS - 1) * rps, SEEDS * rps)
        if not ((got[0][dead] <= fs.NEG_INF / 2).all() and (got[1][dead] == 0).all()):
            fail(f"{key}: the all-excluded seed's rows are not empty")
        live = walk_check("variants", key, k, args, kw5, c=c)
        variant_time("variants", key, k, args, M, args[2].shape[0], g.d, c, kw5, rec,
                     rows=rows, S=SEEDS, rps=rps, live=live)
    # (7) K6: 'mxu' masked at 'highest' and 'high' on a clustered 16-channel
    # chunk (sound masks, k = 3) and on the stress problem at d = 144
    for precision in ("highest", "high"):
        kw = dict(precision=precision)
        g = bank_geometry(images16_dev.shape[0], 32, 32, WIDE_C, 3, TARGET_BLOCK)
        key = kw_plan(kw, M, TARGET_BLOCK, g.d, WIDE_C, prune=True).key
        rec = recs.setdefault(key, {"max_abs_err": 0.0})
        cb = build_clustered_bank(images16_dev[: g.cs], 3, TARGET_BLOCK)
        p, ctr, pn = cb.bank[0], cb.centers[0], cb.pn[0]
        w_img = torch.full((g.cs,), 1.0 / (MODULE_BATCH * g.per_img), device="cuda")
        w = tels._row_weights(cb, w_img, 0, g.per_img)
        for t in WIDE_T:
            base, _ = chunk_inputs(images16_dev, 3, t, gen)
            xq, qn, at, bt = base[0], base[1], base[6], base[7]
            mask = tels.sweep_masks(cb, w_img, xq, qn, at, bt, per_img=g.per_img)[0]
            args = (xq, qn, p, pn, ctr, w, at, bt)
            check_masked("variants", key, 3, t,
                         f"sound mask ({mask.float().mean().item():.2%} skipped)", args,
                         empty_state(M, WIDE_C), mask, kw, rec)
            if t == 0.5:
                time_masked("variants", key, 3, "sound mask", args, M, p.shape[0], g.d,
                            mask, kw, rec, c=WIDE_C)
        del cb, p, ctr, pn
    phase_prune_stress_wide(recs)
    # (8) K6 in K1 under a mask that skips nothing, beside the unmasked launch
    args, g = chunk_inputs(images_dev, 17, 0.5, gen)
    zero = torch.zeros(fs.prune_grid(M, args[2].shape[0]), dtype=torch.int32, device="cuda")
    kw = dict(precision="highest")
    key = kw_plan(kw, M, args[2].shape[0], g.d, prune=True).key
    masked = fs.flash_score_update(*args, empty_state(M, 3), prune_mask=zero, **kw)
    same = all(torch.equal(a, b) for a, b in zip(
        masked, fs.flash_score_update(*args, empty_state(M, 3), **kw)))
    print(f"[variants] {key} k=17: under a mask that skips nothing, bit-equal to the unmasked "
          f"launch: {same}", flush=True)
    if not same:
        fail(f"{key} under an empty mask differs from the unmasked launch")
    ms = [cuda_ms(lambda: fs.flash_score_update(*args, empty_state(M, 3), prune_mask=mask,
                                                **kw), 5)
          for mask in (None, zero, zero, None)]
    print(f"[variants] {key} k=17 d={g.d} M={M} P={args[2].shape[0]}: in turns unmasked / "
          f"masked (0% skipped) / masked / unmasked {' / '.join(f'{x:.3f}' for x in ms)} ms: "
          f"masked {(ms[1] + ms[2]) / (ms[0] + ms[3]):.3f}x the unmasked", flush=True)
    return recs, wide_ms


def phase_prune_stress_wide(recs, M=8192, P=65536, d=9 * WIDE_C):
    """The clustered stress problem of phase prune at d = 144, c = 16:
    'mxu' masked at 'highest' and 'high', more than half skipped, against
    the plain version (1e-3) and the unmasked kernel (1e-5)."""
    rng = np.random.RandomState(1)
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
    print(f"[variants] stress problem M={M} P={P} d={d} c={WIDE_C}: {skip:.2%} skipped "
          "(must be above 50%)", flush=True)
    if not skip > 0.5:
        fail(f"the wide stress problem's mask skips only {skip:.2%}")
    vals = bank[:, 4 * WIDE_C : 5 * WIDE_C].contiguous()  # the k = 3 center columns
    for precision in ("highest", "high"):
        kw = dict(precision=precision)
        key = kw_plan(kw, M, P, d, WIDE_C, prune=True).key
        rec = {"max_abs_err": 0.0}
        args = (q, qn, bank, pn, vals, w, at, bt)
        check_masked("variants", key, "stress", f"(a_t {at}, b_t {bt})", "stress mask",
                     args, empty_state(M, WIDE_C), mask, kw, rec)
        time_masked("variants", key, "stress", "stress mask", args, M, P, d, mask, kw, rec,
                    c=WIDE_C)
        recs[key]["max_abs_err"] = max(recs[key]["max_abs_err"], rec["max_abs_err"])


def phase_wide(ds16, n_wide, x16, wide_ms, full_n):
    """Phase wide, the slice's path: 20-step ELS machines at 'highest',
    'high' and 'default' on the 16-channel bank (every sweep 'mxu'), each
    'high' / 'default' at n_wide[precision] images. Returns (launches by
    key, walls)."""
    launches, walls = {}, {}
    for precision in ("highest", "high", "default"):
        key = module_plan(precision, 3, c=WIDE_C).key  # 'mxu' at every k
        ran, walls[precision], out = phase_machine(
            f"wide_{precision}", LocalEquivScoreModule, precision, ds16, n_wide[precision],
            x16, wide_ms[key], full_n=full_n)
        if set(ran) != {key}:
            fail(f"wide {precision}: launches {ran}, expected {key} only")
        for k_, n in ran.items():
            launches[k_] = launches.get(k_, 0) + n
        del out
    return launches, walls


def expected_launches(precision, n_bank, per_seed=False, pruned=(), c=3):
    """Launch counts of a 20-step CIFAR10 machine over n_bank images of c
    channels: one sweep per bank chunk per step, under the key of the
    variant the ELS rule takes at that step's k (with a prune mask at the
    k's in `pruned`)."""
    want = {}
    for i in range(len(CIFAR10_SCALES) - 1, 0, -1):
        k = CIFAR10_SCALES[i]
        key = module_plan(precision, k, per_seed, prune=k in pruned, c=c).key
        nblk = bank_geometry(n_bank, 32, 32, c, k, TARGET_BLOCK).nblk
        want[key] = want.get(key, 0) + nblk
    return want


def cached_ks(n_bank: int, prune: bool, c: int = 3) -> set:
    """The k's an ELS module caches under its default ledger over a 20-step
    CIFAR10 machine: first come, first served in step order, each bank's
    `bank_cache_nbytes` (a k that misses once misses again)."""
    used, ks = 0, set()
    for k in CIFAR10_SCALES[:0:-1]:
        nbytes = bank_cache_nbytes(n_bank, 32, 32, c, k, TARGET_BLOCK, prune)
        if k not in ks and used + nbytes <= tels.DEFAULT_BANK_BUDGET:
            used += nbytes
            ks.add(k)
    return ks


def phase_machine(tag, cls, precision, ds, n_bank, x, ms_by_k, prune=False,
                  before=None, after=None, full_n=FULL_N):
    """One 20-step machine call at full width from seeds x; the tier's
    kernel must carry every sweep (one launch per bank chunk per step, in
    the variant of the step's k; with `prune`, masked at the cached k's),
    no other kernel may run. `before(module)` runs inside the wall, just
    before the machine call, and returns the device peak it saw;
    `after(module)` runs before the module is dropped. Returns (launches by
    key, wall, output)."""
    c = x.shape[-1]
    if n_bank < full_n:
        print(f"[{tag}] reduced: {n_bank} of {full_n} bank images (depth cut; "
              "widths, channels, scales and seeds as published)", flush=True)
    mod = cls((ds.images[:n_bank], ds.labels[:n_bank]), batch_size=MODULE_BATCH,
              target_block=TARGET_BLOCK, precision=precision, device="cuda",
              **({"prune": True} if prune else {}))
    machine = ScheduledScoreMachine(mod, in_channels=c, imsize=32,
                                    scales=CIFAR10_SCALES)
    steps = range(len(CIFAR10_SCALES) - 1, 0, -1)
    pruned = cached_ks(n_bank, True) if prune else set()
    expected = expected_launches(precision, n_bank, pruned=pruned, c=c)
    kernel_s = sum(
        bank_geometry(n_bank, 32, 32, c, CIFAR10_SCALES[i], TARGET_BLOCK).nblk
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
        fail(f"{tag}: output is not a finite [8, 32, 32, {c}] tensor")
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


def prototype_set(seed, n=64, protos=4, size=16, noise=0.01, channels=3):
    """n images in `protos` runs of one flat colour each (distinct corners
    of the colour cube at +-0.8; with more channels, random corners) plus
    small noise, labelled by colour: the clustered bank's stats blocks hold
    one colour each, so the masks skip at the last, low-noise steps (on the
    synthetic textures they do not)."""
    rs = np.random.RandomState(seed)
    if channels == 3:
        corners = np.array(list(itertools.product([-0.8, 0.8], repeat=3)), np.float32)
        colour = corners[rs.permutation(8)[:protos]]
    else:
        colour = rs.choice([-0.8, 0.8], size=(protos, channels)).astype(np.float32)
    colour = colour.reshape(protos, 1, 1, channels)
    idx = np.arange(n) * protos // n
    imgs = colour[idx] + noise * rs.normal(size=(n, size, size, channels))
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


def phase_devices_wide(seed):
    """Small 16-channel machines on cuda and on cpu (plain versions), every
    sweep 'mxu': ELS at each tier, bbELS at 'high', ELS with a 2-seed label
    vector at each tier (per-seed 'mxu', K5), at 1e-3; ELS prune=True at 'highest' and
    'high' over 16-channel prototype images, with a skip fraction above 0
    on both devices. The 'default' machines are held at
    DEVICES_WIDE_DEFAULT_TOL, with their sensitivity to the dots' last bits
    and the tier gap printed. Returns the card's launches."""
    small = synthetic_dataset(num_samples=64, image_size=16, num_channels=WIDE_C,
                              seed=seed + 2)
    x = np.random.RandomState(seed).normal(size=(2, 16, 16, WIDE_C)).astype(np.float32)
    vec = np.unique(small.labels)[:2].astype(np.int64)  # two labels present
    els_scales = [3, 3, 3, 3, 5, 5, 5, 7, 7, 9]
    cases = [(f"ELS {p!r}", LocalEquivScoreModule, p, None) for p in ("highest", "high",
                                                                       "default")]
    cases.append(("bbELS 'high'", LocalEquivBordersScoreModule, "high", None))
    cases += [(f"conditional ELS {p!r}", LocalEquivScoreModule, p, vec)
              for p in ("highest", "high", "default")]
    launches = {}

    def run(cls, precision, label, dev):
        mod = cls((small.images, small.labels), batch_size=16, precision=precision,
                  device=dev)
        return ScheduledScoreMachine(mod, in_channels=WIDE_C, imsize=16,
                                     scales=els_scales)(x, label=label).cpu()

    for what, cls, precision, label in cases:
        outs = {}
        for dev in ("cuda", "cpu"):
            before = dict(fs.flash_score_update.launches)
            outs[dev] = run(cls, precision, label, dev)
            for key, n in fs.flash_score_update.launches.items():
                launches[key] = launches.get(key, 0) + n - before[key]
        e = rel(outs["cuda"], outs["cpu"])
        tol = DEVICES_WIDE_DEFAULT_TOL if precision == "default" else TOL
        print(f"[devices] {what} 10-step machine, N=64 16x16x{WIDE_C}, b=2"
              f"{'' if label is None else f', labels {label.tolist()}'}: cuda vs cpu rel "
              f"{e:.2e} (tol {TOL:g})", flush=True)
        if precision == "default":
            step = fs._split_dot
            fs._split_dot = exact_split_dot
            try:
                sens = rel(run(cls, precision, label, "cpu"), outs["cpu"])
            finally:
                fs._split_dot = step
            gap = rel(run(cls, "high", label, "cpu"), outs["cpu"])
            print(f"[devices] {what}, 16 channels: the CPU machine over the exact split "
                  f"sum (its sensitivity to the dots' last bits, information) rel "
                  f"{sens:.2e}; the tier gap to 'high' on the CPU rel {gap:.2e}; held at "
                  f"{DEVICES_WIDE_DEFAULT_TOL:g}", flush=True)
        if not e <= tol:
            fail(f"card and CPU disagree on the small 16-channel {what} machine")
    imgs, labels = prototype_set(seed, channels=WIDE_C)
    for precision in ("highest", "high"):
        outs, fracs = {}, {}
        for dev in ("cuda", "cpu"):
            mod = LocalEquivScoreModule((imgs, labels), batch_size=16, precision=precision,
                                        device=dev, prune=True)
            before = dict(fs.flash_score_update.launches)
            with MaskSpy() as masks:
                outs[dev] = ScheduledScoreMachine(mod, in_channels=WIDE_C, imsize=16,
                                                  scales=els_scales)(x).cpu()
            for key, n in fs.flash_score_update.launches.items():
                launches[key] = launches.get(key, 0) + n - before[key]
            fracs[dev] = np.mean([f for _, _, f in masks.calls])
        e = rel(outs["cuda"], outs["cpu"])
        print(f"[devices] ELS {precision!r} prune=True 10-step machine, prototype images "
              f"N=64 16x16x{WIDE_C}, b=2: cuda vs cpu rel {e:.2e} (tol {TOL:g}); mean skip "
              f"fraction cuda {fracs['cuda']:.2%}, cpu {fracs['cpu']:.2%}", flush=True)
        if not e <= TOL:
            fail(f"card and CPU disagree on the small pruned 16-channel {precision!r} machine")
        if not (fracs["cuda"] > 0 and fracs["cpu"] > 0):
            fail(f"the small pruned 16-channel {precision!r} machine's masks skip nothing")
    return {k_: n for k_, n in launches.items() if n}


def flagship(device, precision="highest", conditional=True, seed=0):
    cfg = dict(FLAGSHIP, precision=precision)
    if not conditional:
        cfg.update(conditional=False, num_classes=None)
    return DiffusionModel(MinimalResNet(**cfg), in_channels=3, default_imsize=32,
                          seed=seed, device=device)


def device_busy(tag, model, x, label, gen, step_ms, steps=BUSY_STEPS):
    """A `steps`-step DDPM window under torch.profiler, with CUDA events
    recorded inside it: the kernels' and copies' device time (one stream, so
    they do not overlap) over the window's span on the device clock, both of
    this one run (the device-busy share); the host's cudaLaunchKernel calls
    per step and its *Synchronize calls in the window (the closing one
    included). The window's step carries the profiler's host cost; the
    unprofiled calls' step `step_ms` prints beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        tsampling.sample_scan(model, model.noise_schedule, x, nsteps=steps, label=label,
                              generator=gen, ddpm=True)
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    events = prof.key_averages()
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in events if "LaunchKernel" in e.key) / steps
    sync_calls = {e.key: e.count for e in events if "Synchronize" in e.key}
    syncs = sum(sync_calls.values())
    busy = ("not measured (the profiler saw no device time)" if not dev_ms else
            f"{dev_ms / steps:.3f} ms of device time per step over a {span_ms / steps:.3f} "
            f"ms step on the device clock (one profiled {steps}-step window, CUDA events "
            f"inside it): busy {100 * dev_ms / span_ms:.1f}%; the unprofiled calls' step "
            f"{step_ms:.3f} ms")
    print(f"[neural] {tag}: {busy}; {launches:.1f} kernel launches per step; {syncs} "
          f"host synchronisations in the window (its closing one included)", flush=True)


def ddpm_inputs(batch, imsize, nlabels, seed):
    """(x, label, generator) of a DDPM cell, drawn on the card from `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, imsize, imsize, 3), generator=gen, device="cuda")
    label = torch.randint(0, nlabels, (batch,), generator=gen, device="cuda")
    return x, label, gen


def ddpm_warm(model, x, label, gen):
    tsampling.sample(model, x=x, nsteps=3, label=label, generator=gen, ddpm=True,
                     device="cuda")
    torch.cuda.synchronize()


def ddpm_call(tag, model, x, label, gen, flops_per_img_step=None):
    """One timed 1000-step DDPM sampler call (`sampling.sample`, ddpm=True):
    wall on the host clock ending in a synchronise, CUDA events around the
    same call, images/s, ms per step, TFLOP/s from the bench's count, peak
    memory. Returns the wall in seconds."""
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = tsampling.sample(model, x=x, nsteps=DDPM_STEPS, label=label, generator=gen,
                           ddpm=True, device="cuda")
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail(f"{tag}: the DDPM output is not a finite {list(x.shape)} tensor")
    batch = x.shape[0]
    rate = ("" if flops_per_img_step is None else
            f", {flops_per_img_step * batch * DDPM_STEPS / wall / 1e12:.2f} TFLOP/s "
            f"(the bench's count, {flops_per_img_step / 1e9:.2f} GFLOP per image-step)")
    print(f"[neural] {tag}: {DDPM_STEPS}-step DDPM, batch {batch}, {x.shape[1]}x{x.shape[2]}"
          f"x3: wall {wall:.3f} s, {batch / wall:.3f} images/s, {wall / DDPM_STEPS * 1e3:.3f} "
          f"ms per step{rate}; CUDA events {start.elapsed_time(end) / 1e3:.3f} s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return wall


def within(got, want, atol, rtol) -> bool:
    return bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all())


def phase_neural(seed):
    """The neural serving path on the card: gates first (card vs CPU at
    'highest', the reference pickles against their recorded forwards), then
    the flagship's 1000-step DDPM at 'highest' and with TF32 allowed
    (precision=None, the JAX bench's headline), and the 64x64 UNet's."""
    # gate 1: card vs CPU, the same seeded weights and NHWC seeds: a 20-step
    # DDIM trajectory (every state) and one DDPM step with injected noise
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 32, 32, 3), generator=g)
    label = torch.tensor([3, 7])
    traj = {}
    for dev in ("cuda", "cpu"):
        model = flagship(dev, seed=seed)
        seen = []

        def record(t, xt, lab, model=model, seen=seen):
            seen.append(xt.cpu())
            return model(t, xt, lab)

        out = tsampling.sample_scan(record, model.noise_schedule, x.to(dev), nsteps=20,
                                    label=label.to(dev))
        traj[dev] = torch.stack(seen[1:] + [out.cpu()])
        beta_t, beta_prev = torch.tensor([0.7, 0.3]), torch.tensor([0.6, 0.2])
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed + 1))
        with torch.no_grad():
            eps = model(torch.tensor([0.9, 0.4]).to(dev), x.to(dev), label.to(dev))
        traj[dev, "ddpm"] = tsampling.ddpm_step(x.to(dev), eps, beta_t.to(dev),
                                                beta_prev.to(dev), noise.to(dev)).cpu()
        traj[dev, "eps"] = eps.cpu()
        del model
    with torch.no_grad():
        tf32_eps = flagship("cuda", precision=None, seed=seed)(
            torch.tensor([0.9, 0.4]).cuda(), x.cuda(), label.cuda()).cpu()
    e_traj = rel(traj["cuda"], traj["cpu"])
    e_ddpm = rel(traj["cuda", "ddpm"], traj["cpu", "ddpm"])
    e_eps = rel(traj["cuda", "eps"], traj["cpu", "eps"])
    e_tf32 = rel(tf32_eps, traj["cpu", "eps"])
    print(f"[neural] flagship 'highest', card vs CPU (seeded weights, 2 NHWC seeds, "
          f"labels [3, 7]): 20-step DDIM trajectory rel {e_traj:.2e} over every state "
          f"(max |x| {traj['cpu'].abs().max().item():.3g}; tol {TOL:g}), one forward's "
          f"epsilon rel {e_eps:.2e} and one ddpm_step with injected noise rel "
          f"{e_ddpm:.2e} (tol {FP32_TOL:g}, and {TOL:g}); the TF32 model's "
          f"(precision=None) epsilon against the CPU's 'highest' rel {e_tf32:.2e} (must "
          f"exceed {FP32_TOL:g})", flush=True)
    if not (e_traj <= TOL and e_ddpm <= TOL):
        fail("neural: the card and the CPU disagree at 'highest'")
    if not (e_eps <= FP32_TOL and e_ddpm <= FP32_TOL):
        fail(f"neural: the card's 'highest' forward is past {FP32_TOL:g} from the CPU's: "
             "not true fp32")
    if not e_tf32 > FP32_TOL:
        fail(f"neural: the TF32 model's epsilon is within {FP32_TOL:g} of the CPU's "
             "'highest': the fp32 gate cannot tell TF32 from fp32")
    if not (torch.isfinite(traj["cuda"]).all() and torch.isfinite(traj["cuda", "ddpm"]).all()):
        fail("neural: a card output is not finite")
    # gate 2: the reference pickles on the card against their recorded forwards
    z = np.load(GOLDENS / "pickle_forward.npz")
    xz = torch.from_numpy(np.transpose(z["x"], (0, 2, 3, 1))).cuda()
    for name, key, lab in (("backbone_resnet_cond.pt", "resnet_out", z["label"]),
                           ("backbone_unet.pt", "unet_out", None)):
        model = load_model(str(GOLDENS / "pickles" / name), device="cuda")
        with torch.no_grad():
            got = model(torch.from_numpy(z["t"]).cuda(), xz,
                        None if lab is None else torch.from_numpy(lab).cuda()).cpu()
        want = torch.from_numpy(np.transpose(z[key], (0, 2, 3, 1)))
        err = (got - want).abs().max().item()
        print(f"[neural] {name} on the card ({type(model.backbone).__name__}, mode "
              f"{model.backbone.mode!r}): max abs error {err:.2e} against "
              f"pickle_forward.npz (atol {PICKLE_ATOL:g}, rtol {PICKLE_RTOL:g})", flush=True)
        if not (torch.isfinite(got).all() and within(got, want, PICKLE_ATOL, PICKLE_RTOL)):
            fail(f"neural: {name} on the card disagrees with its recorded forward")
    # the bench's cells: the flagship's two, NEURAL_RUNS calls each, interleaved
    models = {"flagship 'highest'": flagship("cuda", precision="highest", seed=seed),
              "flagship TF32": flagship("cuda", precision=None, seed=seed)}
    inputs = ddpm_inputs(64, 32, 10, seed)
    for model in models.values():
        ddpm_warm(model, *inputs)
    walls = {tag: [] for tag in models}
    for run in range(NEURAL_RUNS):
        for tag, model in models.items():
            walls[tag].append(ddpm_call(f"{tag} call {run + 1}", model, *inputs,
                                        flops_per_img_step=FLAGSHIP_FLOPS_PER_IMG_STEP))
    med, batch = {}, inputs[0].shape[0]
    for tag, model in models.items():
        w = sorted(walls[tag])
        med[tag] = w[len(w) // 2]
        print(f"[neural] {tag}: median of {len(w)} calls {med[tag]:.3f} s, "
              f"{batch / med[tag]:.3f} images/s, "
              f"{FLAGSHIP_FLOPS_PER_IMG_STEP * batch * DDPM_STEPS / med[tag] / 1e12:.2f} "
              f"TFLOP/s; walls {w[0]:.3f}-{w[-1]:.3f} s, spread "
              f"{100 * (w[-1] - w[0]) / med[tag]:.1f}% of the median", flush=True)
        device_busy(tag, model, *inputs, med[tag] / DDPM_STEPS * 1e3)
    del models, inputs
    unet = DiffusionModel(MinimalUNet(**UNET64), in_channels=3, default_imsize=64,
                          seed=seed, device="cuda")
    inputs = ddpm_inputs(32, 64, 2, seed)
    ddpm_warm(unet, *inputs)
    wall = ddpm_call("UNet-64 'highest'", unet, *inputs)
    device_busy("UNet-64 'highest'", unet, *inputs, wall / DDPM_STEPS * 1e3)
    del unet, inputs
    torch.cuda.empty_cache()
    speedup = med["flagship 'highest'"] / med["flagship TF32"]
    print(f"[neural] TF32 against 'highest': {speedup:.2f}x images/s (medians)", flush=True)


def calib_modules(images, labels, ks, device, ledger=None):
    return {k: LocalEquivScoreModule((images, labels), kernel_size=k, batch_size=CALIB_BATCH,
                                     target_block=TARGET_BLOCK, bank_ledger=ledger,
                                     device=device) for k in ks}


def phase_calibrate(seed):
    """Scale calibration against the CNN: a small case on the card and on
    the CPU (the same k at every step), then the README recipe on the card
    with its wall, K1 launches, peak memory and scales, and its modules'
    K1 launches held against the plain version (`recipe_gate`). Returns the
    recipe's launches by key and the gate's worst max abs error by key."""
    small = synthetic_dataset(num_samples=256, image_size=32, num_channels=3,
                              seed=seed + 2)
    x0 = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(seed))

    def small_case(dev):
        cnn = flagship(dev, conditional=False, seed=seed)
        mods = calib_modules(small.images, small.labels, (3, 5), dev)
        return calibrate(cnn, mods, image_size=32, in_channels=3, nsamps=2, nsteps=3,
                         x0=x0, device=dev)["k_optimals"]

    card, cpu = small_case("cuda"), small_case("cpu")
    print(f"[calibrate] small case (N = 256, 2 seeds, 3 steps, k = 3, 5): k_optimals "
          f"card {card.tolist()}, CPU {cpu.tolist()}", flush=True)
    if not np.array_equal(card, cpu):
        fail("calibrate: the card's k_optimals differ from the CPU port's")
    ds = synthetic_dataset(num_samples=CALIB_N, image_size=32, num_channels=3, seed=seed)
    images = torch.from_numpy(ds.images).cuda()
    labels = torch.from_numpy(ds.labels.astype(np.int64)).cuda()
    cnn = flagship("cuda", conditional=False, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ledger = BankLedger(tels.DEFAULT_BANK_BUDGET)
    mods = calib_modules(images, labels, CALIB_KS, "cuda", ledger)
    res = calibrate(cnn, mods, image_size=32, in_channels=3, nsamps=CALIB_SEEDS, nsteps=20,
                    generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = {key: n for key, n in fs.flash_score_update.launches.items() if n}
    expected = {}  # one sweep per bank chunk per k per step
    for k in CALIB_KS:
        key = module_plan("highest", k).key
        expected[key] = expected.get(key, 0) + 20 * bank_geometry(
            CALIB_N, 32, 32, 3, k, TARGET_BLOCK).nblk
    banked = sorted(k for k, m in mods.items() if m._bank_cache)
    print(f"[calibrate] recipe: {len(CALIB_KS)} ELS modules k = {list(CALIB_KS)} at "
          f"'highest' on one bank ledger, N = {CALIB_N}, {CALIB_SEEDS} seeds, 20 steps, "
          f"the flagship unconditional at 'highest': wall {wall:.2f} s (bank builds "
          f"included), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"banked k = {banked} ({ledger.used / 1e9:.2f} GB); launches {ran} (expected "
          f"{expected}); median {res['median'].tolist()}, mode {res['mode'].tolist()}",
          flush=True)
    if ran != expected:
        fail(f"calibrate: launches {ran}, expected {expected}")
    if res["k_optimals"].shape != (CALIB_SEEDS, 20) or not set(
            res["k_optimals"].reshape(-1).tolist()) <= set(CALIB_KS):
        fail("calibrate: k_optimals is not [10, 20] of the candidate k's")
    worst = recipe_gate(mods, seed)
    del mods, cnn, images, labels
    torch.cuda.empty_cache()
    return ran, worst


def recipe_gate(mods, seed):
    """At the recipe's shapes: one call of the k = 3 and k = 17 modules at
    t = 0.05 and 0.5 on 10 seeds; every K1 launch of the call against the
    plain version from the same input state (cloned before the launch), on
    every eighth 64-row query block (rows are independent), m + log s1 and
    s2/s1 at TOL. Run after the recipe's launches were read. Returns the
    worst max abs error of the means by launch key."""
    x = torch.randn((CALIB_SEEDS, 32, 32, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed + 3))
    inner, worst = tels.flash_score_update, {}
    for k in (CALIB_KS[0], CALIB_KS[-1]):
        for t in (0.05, 0.5):
            errs = []

            def spy(q, qn, *rest, **kw):
                state = tuple(s_.clone() for s_ in rest[-1])
                got = inner(q, qn, *rest, **kw)
                rps = kw.get("rows_per_seed")
                rows = row_subset(q.shape[0], rps)
                want = plain_on(rows, (q, qn, *rest[:-1]), state, kw, rps)
                errs.append(compare(pick(got, rows), want))
                return got

            tels.flash_score_update = spy
            try:
                mods[k](t, x, k=k)
            finally:
                tels.flash_score_update = inner
            key = module_plan("highest", k).key
            e_lse, e_mean, e_abs = (max(e[i] for e in errs) for i in range(3))
            worst[key] = max(worst.get(key, 0.0), e_abs)
            print(f"[calibrate] recipe shapes, ELS k={k} t={t} (M = {CALIB_SEEDS} x 1024, "
                  f"N = {CALIB_N}): {len(errs)} {key} launches against the plain version "
                  f"on every eighth 64-row block, worst lse rel {e_lse:.2e}, mean rel "
                  f"{e_mean:.2e} (tol {TOL:g})", flush=True)
            if not errs or not (e_lse <= TOL and e_mean <= TOL):
                fail(f"calibrate: K1 disagrees with its plain version at the recipe's "
                     f"shapes, k={k} t={t}")
    return worst


def png_shape(path):
    """(height, width, channels) of an 8-bit PNG, its rows decoded with zlib
    (filter type 0 on every row)."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head
    ch = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if depth != 8 or raw.size != h * (1 + w * ch) or raw.reshape(h, -1)[:, 0].any():
        fail(f"{path}: the rows do not decode")
    return h, w, ch


def phase_cli_sample():
    """cli.sample on the card with the conditional reference pickle: the
    PNG grid and --save_arrays under build/chip_smoke/."""
    png = SCRATCH / "samples.png"
    arrays = SCRATCH / "sample_arrays"
    shutil.rmtree(arrays, ignore_errors=True)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = cli_sample.main(["--modelfile", str(GOLDENS / "pickles" / "backbone_resnet_cond.pt"),
                           "--conditional", "--out", str(png), "--save_arrays", str(arrays)])
    wall = time.perf_counter() - t0
    shape = png_shape(png)
    print(f"[cli_sample] cli.sample --conditional on the card: {out.shape[0]} samples in "
          f"{wall:.2f} s; {png.name} decodes to {shape}; {len(list(arrays.iterdir()))} "
          "arrays", flush=True)
    if out.shape != (16, 16, 16, 3) or not np.isfinite(out).all():
        fail("cli_sample: the samples are not a finite [16, 16, 16, 3] array")
    if shape != (32, 128, 3) or len(list(arrays.iterdir())) != 16:
        fail("cli_sample: the grid is not 2 x 8 tiles of 16x16 RGB, or arrays are missing")


# --- phase train -------------------------------------------------------------


def conv_dense_flops(model, t, x, label) -> float:
    """2 x the multiply-adds of every Conv2d, ConvTranspose2d and Linear of
    one forward, per image, from the shapes their forward hooks see."""
    total = 0

    def count(m, inp, out):
        nonlocal total
        kh, kw = getattr(m, "kernel_size", (1, 1))
        if isinstance(m, torch.nn.ConvTranspose2d):
            total += 2 * inp[0].numel() * m.out_channels * kh * kw
        elif isinstance(m, torch.nn.Conv2d):
            total += 2 * out.numel() * m.in_channels * kh * kw
        else:
            total += 2 * out.numel() * m.in_features
    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)
    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, kinds)]
    with torch.no_grad():
        model(t, x, label)
    for h in hooks:
        h.remove()
    return total / x.shape[0]


def train_data(n, imsize, nlabels, seed, device="cuda"):
    ds = synthetic_dataset(num_samples=n, image_size=imsize, num_channels=3,
                           num_classes=nlabels, seed=seed)
    return (torch.from_numpy(ds.images).to(device),
            torch.from_numpy(ds.labels.astype(np.int64)).to(device))


def train_busy(tag, model, images, labels, step_ms):
    """One `train_diffusion` epoch of TRAIN_STEPS steps (the loop as a user
    runs it, the loss read once, at its log step) under torch.profiler,
    with CUDA events inside: kernel device time over the span (the device-
    busy share), kernel launches per step, host synchronisations. Fails if
    more than 3 synchronising calls run in the window (the loss read and
    the closing synchronise are 2): a sync per step would show."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = images.shape[0] // TRAIN_STEPS
    config = TrainConfig(epochs=1, batch_size=batch, log_every=TRAIN_STEPS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        train_diffusion(model, (images, labels), config, conditional=True,
                        log_fn=lambda s: None)
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    events = prof.key_averages()
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in events if "LaunchKernel" in e.key) / TRAIN_STEPS
    sync_calls = {e.key: e.count for e in events if "Synchronize" in e.key}
    syncs = sum(sync_calls.values())
    busy = ("not measured (the profiler saw no device time)" if not dev_ms else
            f"{dev_ms / TRAIN_STEPS:.3f} ms of device time per step over a "
            f"{span_ms / TRAIN_STEPS:.3f} ms step on the device clock (one profiled "
            f"{TRAIN_STEPS}-step train_diffusion epoch, CUDA events inside it, optimizer "
            f"set-up included): busy {100 * dev_ms / span_ms:.1f}%; the timed windows' "
            f"step {step_ms:.3f} ms")
    print(f"[train] {tag}: {busy}; {launches:.1f} kernel launches per step; {syncs} host "
          f"synchronisations in the window ({sync_calls}; the log step's loss read and the "
          f"closing one included)", flush=True)
    if syncs > 3:
        fail(f"train: {syncs} host synchronisations in a {TRAIN_STEPS}-step epoch")


def train_cell(tag, model, batch, imsize, nlabels, seed):
    """The recipe's train step at full width: TRAIN_WINDOWS windows of
    TRAIN_STEPS chained steps (batches of the per-epoch permutation, as
    train_diffusion takes them) after TRAIN_WARM, each timed by CUDA events:
    ms per step, images/s, TFLOP/s by 3 x the forward's conv and dense count
    (the backward's input and weight gradients each cost about one
    forward), peak memory; then `train_busy`. Returns the median ms."""
    images, labels = train_data(batch * TRAIN_STEPS, imsize, nlabels, seed)
    fwd = conv_dense_flops(model, torch.rand(batch, device="cuda"), images[:batch],
                           labels[:batch])
    state = TrainState(model, TrainConfig(batch_size=batch, seed=seed))
    step = make_train_step(state, conditional=True)
    for _ in range(TRAIN_WARM):
        step(images[:batch], labels[:batch])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for w in range(TRAIN_WINDOWS):
        perm = torch.from_numpy(state.rng.permutation(images.shape[0])).cuda()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(TRAIN_STEPS):
            idx = perm[i * batch:(i + 1) * batch]
            loss = step(images[idx], labels[idx])
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        ms.append(start.elapsed_time(end) / TRAIN_STEPS)
        print(f"[train] {tag} window {w + 1}: {ms[-1]:.3f} ms per step (CUDA events), "
              f"host wall {wall:.3f} ms per step, last loss {loss.item():.4f}", flush=True)
        if not torch.isfinite(loss):
            fail(f"train: {tag}'s loss is not finite")
    srt = sorted(ms)
    med = srt[len(srt) // 2]
    print(f"[train] {tag}, batch {batch}, {imsize}x{imsize}x3: median {med:.3f} ms per step "
          f"({srt[0]:.3f}-{srt[-1]:.3f}, spread {100 * (srt[-1] - srt[0]) / med:.1f}% of the "
          f"median), {batch / med * 1e3:.1f} images/s, {3 * fwd * batch / med / 1e9:.2f} "
          f"TFLOP/s (3 x {fwd / 1e9:.3f} GFLOP per image: the forward's convs and dense "
          f"layers, counted from their shapes); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    train_busy(tag, model, images, labels, med)
    return med, fwd


def one_step(model, images, labels, t, eps):
    """Loss, gradients (CPU float64 copies by name) and buffers of one step
    from the given t and eps, in the model's dtype (images and eps follow
    it)."""
    dev, dtype = model.device, next(model.parameters()).dtype
    state = TrainState(model, TrainConfig())
    loss = step_with_noise(state, images.to(dev, dtype), labels.to(dev), t.to(dev),
                           eps.to(dev, dtype), conditional=True)
    grads = {n: p.grad.detach().double().cpu() for n, p in model.backbone.named_parameters()}
    bufs = {k: v.detach().cpu() for k, v in model.backbone.named_buffers()}
    return loss.detach().double().cpu(), grads, bufs


def null_biases(backbone) -> set:
    """Conv biases that a per-channel normalisation right after removes
    (BatchNorm2d, or GroupNorm with one channel per group): their gradient
    is zero, so what a step computes for them is rounding noise."""
    names = set()
    for name, m in backbone.named_modules():
        kids = list(m.named_children()) if isinstance(m, torch.nn.Sequential) else []
        for (a, conv), (_, norm) in zip(kids, kids[1:]):
            per_channel = isinstance(norm, torch.nn.BatchNorm2d) or (
                isinstance(norm, torch.nn.GroupNorm) and norm.num_groups == norm.num_channels)
            if isinstance(conv, torch.nn.Conv2d) and per_channel:
                names.add(f"{name}.{a}.bias" if name else f"{a}.bias")
    return names


def grad_rel(a: dict, b: dict, skip=()) -> float:
    """max|a-b| / max|b| over all gradients but `skip` (no floor of 1: they
    are small)."""
    keys = [k for k in b if k not in skip]
    err = max((a[k] - b[k]).abs().max().item() for k in keys)
    return err / max(b[k].abs().max().item() for k in keys)


def step_inputs(n, imsize, nlabels, seed):
    images, labels = train_data(n, imsize, nlabels, seed, device="cpu")
    t, eps = draw_noise(images, torch.Generator().manual_seed(seed), 1000)
    return images, labels, t, eps


def step_gate(tag, build, inputs, stats=False):
    """One train step of `build(device, precision)` on the card at
    'highest', on the card with TF32 allowed, and on the CPU in float32 and
    float64, from the same weights, images, t and eps. Float32's own
    rounding of these gradients reaches ~1e-5 of their scale on the CPU
    (the flagship's 1.1e-5 against float64, BatchNorm's 6.4e-5), and the
    card's is a draw of the same size, not the same draw: so the card is
    held to the float64 step within FP32_TOL plus twice the CPU float32's
    own distance from it (loss, gradients, and with `stats` the running
    statistics), and the TF32 step must fall outside that bound; the card
    against the CPU's float32 prints too. Null conv biases (`null_biases`) are left out of
    the gradients and printed apart."""
    ref = one_step(build("cpu", "highest").double(), *inputs)
    cpu = one_step(build("cpu", "highest"), *inputs)
    card = one_step(build("cuda", "highest"), *inputs)
    tf32 = one_step(build("cuda", None), *inputs)
    skip = null_biases(build("cpu", "highest").backbone)

    def errs(x):
        e = [rel(x[0], ref[0]), grad_rel(x[1], ref[1], skip)]
        if stats:
            e.append(max(rel(x[2][k].double(), ref[2][k].double()) for k in ref[2]
                         if k.endswith(("running_mean", "running_var"))))
        return e

    own, got, t32 = errs(cpu), errs(card), errs(tf32)
    names = ("loss", "gradients", "running statistics")[:len(own)]
    noise = (max(card[1][k].abs().max().item() for k in skip)
             / max(ref[1][k].abs().max().item() for k in ref[1]) if skip else 0.0)
    print(f"[train] {tag}, batch {TRAIN_GATE_BATCH}, against the CPU's float64 step, rel to "
          f"scale: " + "; ".join(
              f"{n} card 'highest' {g:.2e} (bound {FP32_TOL:g} + 2 x the CPU float32's own "
              f"{o:.2e}), TF32 {x:.2e} (must exceed the bound)"
              for n, g, o, x in zip(names, got, own, t32))
          + f"; card vs CPU float32: loss {rel(card[0], cpu[0]):.2e}, gradients "
          f"{grad_rel(card[1], cpu[1], skip):.2e}; {len(skip)} null conv biases left out (the "
          f"card's rounding noise on them {noise:.2e} of scale)", flush=True)
    if not all(g <= FP32_TOL + 2 * o for g, o in zip(got, own)):
        fail(f"train {tag}: the card's 'highest' step is not fp32: past the bound")
    if not max(x - FP32_TOL - 2 * o for x, o in zip(t32, own)) > 0:
        fail(f"train {tag}: the TF32 step is within the bound: the gate cannot tell TF32 "
             "from fp32")
    return card


def gate_step_card_vs_cpu(seed):
    """(a) The flagship's step (`step_gate`): a backward that leaked TF32
    at 'highest' would be ~1e-3 off."""
    step_gate("(a) flagship step",
              lambda dev, prec: flagship(dev, precision=prec, seed=seed),
              step_inputs(TRAIN_GATE_BATCH, 32, 10, seed + 7))


def gate_loss_falls(seed):
    """(b) The flagship with TF32 over LOSS_FALL_EPOCHS epochs of
    LOSS_FALL_N // 128 steps: the last epoch's mean loss below 0.9 x the
    first's."""
    images, labels = train_data(LOSS_FALL_N, 32, 10, seed + 6)
    config = TrainConfig(epochs=LOSS_FALL_EPOCHS, batch_size=128, lr=LOSS_FALL_LR,
                         log_every=2, seed=seed)
    t0 = time.perf_counter()
    state, hist = train_diffusion(flagship("cuda", precision=None, seed=seed),
                                  (images, labels), config, conditional=True,
                                  log_fn=lambda s: None)
    print(f"[train] (b) flagship TF32, {state.step} steps of batch 128 over {LOSS_FALL_N} "
          f"images, lr {LOSS_FALL_LR:g}, in {time.perf_counter() - t0:.2f} s: epoch mean "
          f"losses {hist[0]:.4f} -> {hist[-1]:.4f} (must fall below 0.9x)", flush=True)
    if not (np.isfinite(hist).all() and hist[-1] < 0.9 * hist[0]):
        fail(f"train (b): the loss did not fall: {hist}")


def gate_resume(seed):
    """(c) Under cudnn.deterministic: 2 x RESUME_STEPS flagship steps at
    'highest' straight against RESUME_STEPS, a checkpoint, a restore into a
    model of other weights and RESUME_STEPS more: weights and AdamW state
    bit for bit."""
    images, labels = train_data(128 * RESUME_STEPS, 32, 10, seed + 8)
    root = SCRATCH / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = dict(batch_size=128, save_interval=1, seed=seed)
        run = functools.partial(train_diffusion, dataset=(images, labels), conditional=True,
                                log_fn=lambda s: None)
        whole, _ = run(flagship("cuda", seed=seed), config=TrainConfig(epochs=2, **cfg))
        run(flagship("cuda", seed=seed), config=TrainConfig(epochs=1, **cfg),
            checkpoint_dir=str(root))
        resumed, _ = run(flagship("cuda", seed=seed + 1), config=TrainConfig(epochs=1, **cfg),
                         resume_from=str(root))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    a, b = resumed.model.backbone.state_dict(), whole.model.backbone.state_dict()
    worst = max((a[k].double() - b[k].double()).abs().max().item() for k in a)
    oa, ob = resumed.optimizer.state_dict()["state"], whole.optimizer.state_dict()["state"]
    same = all(torch.equal(a[k], b[k]) for k in a) and all(
        torch.equal(oa[i][k], ob[i][k]) for i in ob for k in ob[i])
    print(f"[train] (c) resume under cudnn.deterministic: {2 * RESUME_STEPS} flagship steps "
          f"straight against {RESUME_STEPS} + checkpoint + restore + {RESUME_STEPS} (step "
          f"{resumed.step}): weights and AdamW moments bit-equal {same} (max |diff| "
          f"{worst:.3e})", flush=True)
    if not same:
        fail("train (c): the resumed run is not the unbroken one bit for bit")


def gate_batchnorm(seed):
    """(d) One step of the UNet-64 recipe's widths with BatchNorm (32x32)
    through `step_gate`, running statistics included; every
    num_batches_tracked 1 on the card."""

    def net(dev, precision):
        return DiffusionModel(MinimalUNet(**dict(UNET64, normalization="BatchNorm",
                                                 precision=precision)),
                              in_channels=3, default_imsize=32, seed=seed, device=dev)

    inputs = step_inputs(TRAIN_GATE_BATCH, 32, 2, seed + 9)
    card = step_gate(f"(d) BatchNorm UNet (fsizes {UNET64['fsizes']}, 32x32) step", net,
                     inputs, stats=True)
    if not all(int(v) == 1 for k, v in card[2].items() if k.endswith("num_batches_tracked")):
        fail("train (d): BatchNorm's num_batches_tracked is not 1 after one step")
    # information: the same step with cuDNN's BatchNorm, which models.layers
    # .BatchNorm keeps out
    ref = one_step(net("cpu", "highest").double(), *inputs)
    inner, tlayers.without_cudnn = tlayers.without_cudnn, contextlib.nullcontext
    try:
        cudnn_bn = one_step(net("cuda", "highest"), *inputs)
    finally:
        tlayers.without_cudnn = inner
    skip = null_biases(net("cpu", "highest").backbone)
    print(f"[train] (d) information: the same card step through cuDNN's BatchNorm: "
          f"gradients rel {grad_rel(cudnn_bn[1], ref[1], skip):.2e} from the float64 step "
          f"(PyTorch's own kernel, above: {grad_rel(card[1], ref[1], skip):.2e})", flush=True)


def gate_cli(seed):
    """(e) cli.train (the flagship recipe's flags) for one epoch of
    --dataset synthetic with a checkpoint, then cli.sample --modelfile on
    that directory: the checkpoint's step, the PNG grid and finite
    samples."""
    home = SCRATCH / "train_cli"
    shutil.rmtree(home, ignore_errors=True)
    t0 = time.perf_counter()
    state = cli_train.main(["--dataset", "synthetic", "--epochs", "1", "--resnet", "--layers",
                            "8", "--mode", "zeros", "--conditional", "--saveinterval", "1",
                            "--seed", str(seed), "--homedir", str(home), "--suppress"])
    (ckpt,) = home.iterdir()
    blob = restore_checkpoint(str(ckpt))
    png = SCRATCH / "train_cli_samples.png"
    out = cli_sample.main(["--modelfile", str(ckpt), "--conditional", "--out", str(png)])
    shape = png_shape(png)
    print(f"[train] (e) cli.train --dataset synthetic --epochs 1 --resnet --layers 8 --mode "
          f"zeros --conditional: {state.step} steps, checkpoint {ckpt.name}/step_"
          f"{blob['meta']['step']}; cli.sample --modelfile on it: {out.shape[0]} samples, "
          f"{png.name} decodes to {shape}; {time.perf_counter() - t0:.2f} s", flush=True)
    if not blob["meta"]["step"] == state.step == 2:
        fail("train (e): the checkpoint's step is not the run's (2)")
    if out.shape != (16, 32, 32, 3) or not np.isfinite(out).all() or shape != (64, 256, 3):
        fail("train (e): the samples are not a finite [16, 32, 32, 3] array in a 2 x 8 grid")


def phase_train(seed):
    """Training on the card (cuDNN, cuBLAS and PyTorch's fused AdamW: the
    JAX trainer has no Pallas kernel, and no flash-score kernel may run):
    gates (a)-(e), then the flagship recipe's step at 'highest' and with
    TF32, and the UNet-64 recipe's at 'highest'."""
    reset_launches()
    gate_step_card_vs_cpu(seed)
    gate_loss_falls(seed)
    gate_resume(seed)
    gate_batchnorm(seed)
    gate_cli(seed)
    ms = {}
    for precision in ("highest", None):
        tag = "flagship 'highest'" if precision else "flagship TF32"
        ms[precision], fwd = train_cell(tag, flagship("cuda", precision=precision, seed=seed),
                                        128, 32, 10, seed)
    print(f"[train] the bench's forward count {FLAGSHIP_FLOPS_PER_IMG_STEP / 1e9:.3f} GFLOP "
          f"per image against the hooks' {fwd / 1e9:.3f}; TF32 against 'highest': "
          f"{ms['highest'] / ms[None]:.2f}x images/s", flush=True)
    unet = DiffusionModel(MinimalUNet(**UNET64), in_channels=3, default_imsize=64, seed=seed,
                          device="cuda")
    train_cell("UNet-64 'highest'", unet, 64, 64, 2, seed)
    del unet
    torch.cuda.empty_cache()
    ran = {key: n for key, n in fs.flash_score_update.launches.items() if n}
    print(f"[train] flash-score launches in the phase: {ran or 0}", flush=True)
    if ran:
        fail(f"train: the training path launched flash-score kernels: {ran}")


# phase parallel: parallel/ over torch.distributed. A one-card machine runs
# NCCL with one rank only (it refuses two ranks on one device), so (a) is
# NCCL in this process with one rank, and (b) two gloo ranks sharing cuda:0
# (gloo stages CUDA tensors through the host) run the multi-rank logic with
# the real kernels, each rank with half the bank ledger
PAR_ELS_N = 4000  # the sharded ELS 'highest' machine's bank images (of 50000)
PAR_BBELS_N = 2000  # the sharded bbELS 'high' machine's
PAR_TRAIN_BATCH = 128  # the flagship recipe's batch, 64 + 64 over the ranks
PAR_BN_BATCH = 16  # the BatchNorm UNet step's, 8 + 8
PAR_TRAIN_STEPS = 3
PAR_TOL = 1e-5  # score calls, train steps and samples against one process
PAR_TIMEOUT = 600  # seconds the worker pair may take


def par_data(seed):
    ds = synthetic_dataset(num_samples=PAR_ELS_N, image_size=32, num_channels=3,
                           seed=seed + 11)
    x = torch.randn((SEEDS, 32, 32, 3), generator=torch.Generator().manual_seed(seed + 12))
    return ds, x


def par_machines(ds, x, mesh, ledger_bytes):
    """The ELS 'highest' machine over PAR_ELS_N images and the bbELS 'high'
    machine over PAR_BBELS_N, 20 steps, CIFAR10 scales, 8 seeds: one process
    (mesh None) or sharded over the mesh. Returns outputs (and each module's
    one call at t = 0.5, k = 9 before), walls and all-reduces (calls, bytes)
    per score call."""
    outs, walls, per_call = {}, {}, {}
    for tag, kind, precision, n in (("els", "ELS", "highest", PAR_ELS_N),
                                    ("bbels", "bbELS", "high", PAR_BBELS_N)):
        mod = build_score_module(kind, (ds.images[:n], ds.labels[:n]),
                                 batch_size=MODULE_BATCH, image_size=32, channels=3,
                                 schedule=cosine_noise_schedule, precision=precision,
                                 target_block=TARGET_BLOCK, bank_ledger=BankLedger(ledger_bytes),
                                 device=None if mesh else "cuda", mesh=mesh)
        machine = ScheduledScoreMachine(mod, in_channels=3, imsize=32, scales=CIFAR10_SCALES)
        outs[f"{tag} call"] = mod(0.5, x.cuda(), k=9).cpu()
        pm.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[tag] = machine(x.cuda()).cpu()
        walls[tag] = time.perf_counter() - t0
        calls = len(CIFAR10_SCALES) - 1
        per_call[tag] = (pm.COLLECTIVES["all_reduce"] / calls,
                         pm.COLLECTIVES["all_reduce_bytes"] / calls)
        del mod, machine
        torch.cuda.empty_cache()
    return outs, walls, per_call


def par_scores(seed, mesh):
    """One IS and one LS (k = 5, order pinned) call at the devices phase's
    sizes."""
    small = synthetic_dataset(num_samples=64, image_size=16, num_channels=3, seed=seed + 1)
    x = np.random.RandomState(seed).normal(size=(2, 16, 16, 3)).astype(np.float32)
    out = {}
    for kind in ("IS", "LS"):
        mod = build_score_module(kind, (small.images, small.labels), batch_size=16,
                                 image_size=16, channels=3, schedule=cosine_noise_schedule,
                                 device=None if mesh else "cuda", mesh=mesh)
        out[kind] = mod(0.5, x, k=5, order=np.arange(64)).cpu()
    return out


def par_steps(build, batch, nlabels, steps, seed, mesh):
    """`steps` train steps of `build()` at `batch` ('highest', conditional)
    from seeded weights, images, t and eps, data-parallel over the mesh or
    in one process: the losses, the weights before each step and after the
    last, the (averaged) gradients of each step, and the draws."""
    images, labels = train_data(batch, 32, nlabels, seed + 13)
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    model = build()
    state = TrainState(model, TrainConfig(batch_size=batch, seed=seed))
    out = {"losses": [], "weights": [], "grads": [], "draws": [],
           "data": (images.cpu(), labels.cpu())}
    for _ in range(steps):
        t, eps = draw_noise(images, g, 1000)
        out["weights"].append({k: v.detach().cpu().clone()
                               for k, v in model.backbone.state_dict().items()})
        out["draws"].append((t.cpu(), eps.cpu()))
        loss = step_with_noise(state, images, labels, t, eps, conditional=True, mesh=mesh)
        out["losses"].append(global_loss(loss, mesh).item())
        out["grads"].append({n: p.grad.detach().cpu().clone()
                             for n, p in model.backbone.named_parameters()})
    out["weights"].append({k: v.detach().cpu().clone()
                           for k, v in model.backbone.state_dict().items()})
    return out


def bn_unet():
    return DiffusionModel(MinimalUNet(**dict(UNET64, normalization="BatchNorm")),
                          in_channels=3, default_imsize=32, seed=0, device="cuda")


def par_train(seed, mesh):
    """PAR_TRAIN_STEPS flagship steps at batch PAR_TRAIN_BATCH, and one
    BatchNorm UNet step (the UNet-64 widths at 32x32) at batch
    PAR_BN_BATCH (`par_steps`)."""
    return {"flagship": par_steps(lambda: flagship("cuda", seed=seed), PAR_TRAIN_BATCH, 10,
                                  PAR_TRAIN_STEPS, seed, mesh),
            "bn": par_steps(bn_unet, PAR_BN_BATCH, 2, 1, seed + 1, mesh)}


def grad64(build, weights, images, labels, t, eps) -> dict:
    """The float64 gradients (CPU, by name) of `build()` at `weights` on the
    card, from the given images, t and eps."""
    m64 = build().double()
    m64.backbone.load_state_dict(weights)
    grads = one_step(m64, images, labels, t, eps)[1]
    del m64
    return grads


def steps_gate(tag, build, got, want, lr=TrainConfig.lr):
    """A data-parallel run against the one-process run from the same
    weights, images, t and eps. The losses within PAR_TOL. At every step,
    each tensor of averaged gradients within PAR_TOL of its largest float64
    gradient (of the same weights) + twice the one-process float32
    gradients' own distance from float64 on that tensor (float32's
    rounding of a BatchNorm net's gradients alone reaches ~5e-5 of their
    scale; phase train's rule, tensor by tensor; null conv biases left
    out). The weights after the first and the last step (running
    statistics included) within PAR_TOL of scale. A weight whose float64
    gradient lies within its tensor's bound may take an AdamW step of
    either sign (+-lr, whatever the gradient's size): those components,
    found from the one-process run and float64 alone, are left out of the
    weights gate, counted, and held only to the most AdamW moves a weight
    (2 lr a step apart)."""
    images, labels = want["data"]
    start = got["weights"][0], want["weights"][0]
    if not (all(torch.equal(a, b) for dg, dw in zip(got["draws"], want["draws"])
                for a, b in zip(dg, dw))
            and all(torch.equal(start[0][k], v) for k, v in start[1].items())):
        fail(f"parallel: the {tag} did not start from the one-process run's weights and draws")
    skip = null_biases(build().backbone)

    def gap(grads, ref, n):
        return (grads[n].double() - ref[n]).abs().max().item()

    steps = len(want["losses"])
    ratios, worst_grad, rels, masks, mask = [], [], [], [], {}
    for i, (t, eps) in enumerate(want["draws"]):
        ref = grad64(build, want["weights"][i], images, labels, t, eps)
        live = [n for n in ref if n not in skip]
        bound = {n: PAR_TOL * ref[n].abs().max().item() + 2 * gap(want["grads"][i], ref, n)
                 for n in live}
        ref_dp = ref if i == 0 else grad64(build, got["weights"][i], images, labels, t, eps)
        ratio = {n: gap(got["grads"][i], ref_dp, n) / max(bound[n], 1e-30) for n in live}
        worst_grad.append(max(ratio, key=ratio.get))
        ratios.append(ratio[worst_grad[-1]])
        rels.append(grad_rel({n: v.double() for n, v in got["grads"][i].items()}, ref_dp, skip))
        mask = {n: mask.get(n, torch.zeros_like(g, dtype=torch.bool)) | (
            g.abs() <= bound[n] if n in bound else torch.ones_like(g, dtype=torch.bool))
            for n, g in ref.items()}
        masks.append(mask)
    loss_e = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(got["losses"], want["losses"]))
    errs, noise = [], 0.0
    for i in sorted({1, steps}):
        a, b, m = got["weights"][i], want["weights"][i], masks[i - 1]
        live = [k for k in b if not k.endswith("num_batches_tracked")]
        scale = max(max(b[k].double().abs().max().item() for k in live), 1.0)
        diff = {k: (a[k].double() - b[k].double()).abs() for k in live}
        live_diff = {k: (d.masked_fill(m[k], 0) if k in m else d).max().item()
                     for k, d in diff.items()}
        worst = max(live_diff, key=live_diff.get)
        errs.append(live_diff[worst] / scale)
        noise = max([noise] + [d.masked_fill(~m[k], 0).max().item()
                               for k, d in diff.items() if k in m])
    n_null = sum(int(v.sum()) for v in mask.values())
    n_all = sum(v.numel() for v in mask.values())
    print(f"[parallel] (b) {tag} against one process: losses "
          f"{[round(v, 6) for v in got['losses']]}, rel {loss_e:.2e} (tol {PAR_TOL:g}); each "
          f"step's averaged gradients against the float64 step, per tensor over its bound "
          f"({PAR_TOL:g} of its largest gradient + 2 x the one-process float32's own "
          f"distance; must be <= 1): worst {', '.join(f'{r:.3f}' for r in ratios)} "
          f"({', '.join(worst_grad)}), over all {', '.join(f'{e:.2e}' for e in rels)} of "
          f"scale ({len(skip)} null conv biases left out); weights after "
          f"{' and '.join(str(i) for i in sorted({1, steps}))} step(s) rel "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {PAR_TOL:g}; the last's worst "
          f"{worst}), {n_null} of {n_all} weight components left out (float64 gradient "
          f"within its tensor's bound at some step of the one-process run: AdamW may step "
          f"them either way; moved apart by up to {noise:.2e}, the most AdamW moves them "
          f"{2 * lr * steps:.2e})", flush=True)
    if not (loss_e <= PAR_TOL and max(ratios) <= 1 and max(errs) <= PAR_TOL
            and noise <= 2 * lr * steps):
        fail(f"parallel: the {tag} is not the one-process run")


def par_sample(seed, mesh):
    """The flagship's 20-step DDIM of 8 conditional seeds: `sample`, or
    `sample_sharded` over the mesh."""
    model = flagship("cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 16)
    label = torch.arange(SEEDS, device="cuda") % 10
    if mesh is None:
        return tsampling.sample(model, batch_size=SEEDS, nsteps=20, label=label,
                                generator=g, device="cuda").cpu()
    return tsampling.sample_sharded(model, mesh, batch_size=SEEDS, nsteps=20, label=label,
                                    generator=g).cpu()


def parallel_worker(rank, store, out, seed):
    """One of the two gloo ranks on cuda:0 (`chip_smoke.py --parallel-worker
    RANK STORE OUT SEED`): every case of phase parallel (b), sharded or
    data-parallel, its results to OUT.RANK."""
    rank, seed = int(rank), int(seed)
    pm.init_distributed("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    mesh = pm.make_mesh(2, device="cuda:0")
    reset_launches()
    ds, x = par_data(seed)
    res = {}
    res["machines"] = par_machines(ds, x, mesh, tels.DEFAULT_BANK_BUDGET // 2)
    res["scores"] = par_scores(seed, mesh)
    train = par_train(seed, mesh)
    res["train"] = train if rank == 0 else {"losses": train["flagship"]["losses"]}
    res["sample"] = par_sample(seed, mesh)
    res["launches"] = {k: n for k, n in fs.flash_score_update.launches.items() if n}
    res["peak"] = torch.cuda.max_memory_allocated()
    torch.save(res, f"{out}.{rank}")
    pm.barrier()
    torch.distributed.destroy_process_group()


def run_parallel_pair(seed):
    """Start the two gloo ranks (this script, one process each), wait for
    both within PAR_TIMEOUT; a rank that fails or hangs fails the run.
    Returns their results."""
    root = SCRATCH / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    store, out = root / "store", root / "out"
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--parallel-worker", str(r), str(store), str(out), str(seed)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [None, None]
    try:
        deadline = time.perf_counter() + PAR_TIMEOUT
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0]
    except subprocess.TimeoutExpired:
        fail(f"parallel: the gloo pair outlived its {PAR_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if rcs != [0, 0]:
        fail(f"parallel: the gloo ranks exited {rcs}\n--- rank 0 ---\n{logs[0][-3000:]}"
             f"\n--- rank 1 ---\n{logs[1][-3000:]}")
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]


def phase_parallel_nccl(seed):
    """(a) NCCL with one rank, in this process: the sharded ELS module at
    k = 3, 9, 17 and one data-parallel flagship step at batch 128 (under
    cudnn.deterministic) equal the unsharded ones bit for bit. Returns the
    sharded calls' launches."""
    store = SCRATCH / f"nccl_store_{os.getpid()}"
    store.unlink(missing_ok=True)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    pm.init_distributed("nccl", init_method=f"file://{store}", world_size=1, rank=0)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mesh = pm.make_mesh(1, device="cuda")
        ds, x = par_data(seed)
        kw = dict(batch_size=MODULE_BATCH, image_size=32, channels=3,
                  schedule=cosine_noise_schedule, target_block=TARGET_BLOCK)
        data = (ds.images[:PAR_BBELS_N], ds.labels[:PAR_BBELS_N])
        one = build_score_module("ELS", data, device="cuda", **kw)
        sharded = build_score_module("ELS", data, mesh=mesh, **kw)
        reset_launches()
        pm.reset_collectives()
        same = []
        for k in (3, 9, 17):
            a = one(0.5, x, k=k)
            b = sharded(0.5, x, k=k)
            same.append(torch.equal(a, b))
        launches = {key: n // 2 for key, n in fs.flash_score_update.launches.items() if n}
        calls = dict(pm.COLLECTIVES)
        del one, sharded
        images, labels = train_data(PAR_TRAIN_BATCH, 32, 10, seed + 13)
        t, eps = draw_noise(images, torch.Generator(device="cuda").manual_seed(seed + 14), 1000)
        a, b = flagship("cuda", seed=seed), flagship("cuda", seed=seed)
        la = step_with_noise(TrainState(a, TrainConfig()), images, labels, t, eps,
                             conditional=True)
        lb = step_with_noise(TrainState(b, TrainConfig()), images, labels, t, eps,
                             conditional=True, mesh=mesh)
        sa, sb = a.backbone.state_dict(), b.backbone.state_dict()
        step_same = torch.equal(la, lb) and all(torch.equal(sa[k], sb[k]) for k in sa)
        backend = torch.distributed.get_backend()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
        torch.distributed.destroy_process_group()
        store.unlink(missing_ok=True)
    print(f"[parallel] (a) {backend} world of one: the sharded ELS module (N = "
          f"{PAR_BBELS_N}, {SEEDS} seeds) at k = 3, 9, 17 bit-equal to the unsharded: {same} "
          f"({calls['all_reduce']} all-reduces, {calls['all_reduce_bytes']} bytes); one "
          f"data-parallel flagship step at batch {PAR_TRAIN_BATCH} (cudnn.deterministic) "
          f"bit-equal to the one-process step, loss and weights: {step_same}", flush=True)
    if backend != "nccl" or not all(same) or not step_same:
        fail("parallel (a): the NCCL world of one is not the unsharded path bit for bit")
    return launches


def phase_parallel(seed):
    """parallel/ on the card: (a) `phase_parallel_nccl`; (b) two gloo
    ranks sharing cuda:0 against one process on the same card and data:
    the sharded ELS 'highest' and bbELS 'high' machines (TOL), IS and LS
    calls, the data-parallel flagship steps (loss, weights after 1 and 3
    steps), the BatchNorm UNet step (weights, running statistics) and
    `sample_sharded` (PAR_TOL). Returns the launches of the paths it ran:
    (a)'s sharded calls, this process's machines, and both ranks'."""
    t_phase = time.perf_counter()
    launches = phase_parallel_nccl(seed)

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    for tag, n in (("els", PAR_ELS_N), ("bbels", PAR_BBELS_N)):
        print(f"[parallel] reduced: the sharded {tag} machine runs {n} of {FULL_N} bank "
              "images (depth cut; widths, scales and seeds as published)", flush=True)
    ds, x = par_data(seed)
    reset_launches()
    outs, walls, _ = par_machines(ds, x, None, tels.DEFAULT_BANK_BUDGET)
    add({k: n for k, n in fs.flash_score_update.launches.items() if n})
    scores = par_scores(seed, None)
    train = par_train(seed, None)
    samples = par_sample(seed, None)
    torch.cuda.empty_cache()
    t_pair = time.perf_counter()
    ranks = run_parallel_pair(seed)
    pair_s = time.perf_counter() - t_pair
    for r in ranks:
        add(r["launches"])
    got_outs, got_walls, per_call = ranks[0]["machines"]
    for r in range(2):
        if not torch.equal(ranks[r]["machines"][0]["els"], got_outs["els"]):
            fail("parallel: the two ranks' sharded ELS outputs differ")
    for tag, what in (("els", "ELS 'highest'"), ("bbels", "bbELS 'high'")):
        e = rel(got_outs[tag], outs[tag])
        calls, nbytes = per_call[tag]
        print(f"[parallel] (b) sharded {what} machine over 2 gloo ranks on cuda:0 against "
              f"one process on the same card and data: rel {e:.2e} (tol {TOL:g}); one score "
              f"call (t = 0.5, k = 9) rel {rel(got_outs[tag + ' call'], outs[tag + ' call']):.2e}"
              f" (a reorder of two partial sums); wall {got_walls[tag]:.2f} s on 2 ranks "
              f"sharing the card against {walls[tag]:.2f} s in one process (information: "
              f"no speed-up expected on one card); {calls:g} all-reduces and {nbytes:.0f} "
              "bytes per score call", flush=True)
        if not e <= TOL or not torch.isfinite(got_outs[tag]).all():
            fail(f"parallel: the sharded {what} machine is not the one-process machine")
    for kind in ("IS", "LS"):
        e = rel(ranks[0]["scores"][kind], scores[kind])
        print(f"[parallel] (b) sharded {kind} call (N = 64, 16x16x3, 2 seeds) against one "
              f"process: rel {e:.2e} (tol {PAR_TOL:g})", flush=True)
        if not e <= PAR_TOL:
            fail(f"parallel: the sharded {kind} call is not the one-process call")
    got = ranks[0]["train"]
    if ranks[1]["train"]["losses"] != got["flagship"]["losses"]:
        fail("parallel: the two ranks' losses differ")
    steps_gate(f"data-parallel flagship steps (batch {PAR_TRAIN_BATCH} as 2 x "
               f"{PAR_TRAIN_BATCH // 2}, 'highest')", lambda: flagship("cuda", seed=seed),
               got["flagship"], train["flagship"])
    steps_gate(f"data-parallel BatchNorm UNet step (UNet-64 widths, 32x32, batch "
               f"{PAR_BN_BATCH} as 2 x {PAR_BN_BATCH // 2}, global batch statistics)",
               bn_unet, got["bn"], train["bn"])
    e = rel(ranks[0]["sample"], samples)
    same = torch.equal(ranks[0]["sample"], ranks[1]["sample"])
    print(f"[parallel] (b) sample_sharded: the flagship's 20-step DDIM, {SEEDS} seeds over 2 "
          f"ranks, against sample of {SEEDS} seeds: rel {e:.2e} (tol {PAR_TOL:g}); both ranks "
          f"gathered the same {same}", flush=True)
    if not (e <= PAR_TOL and same):
        fail("parallel: sample_sharded is not sample seed for seed")
    print(f"[parallel] ranks' flash-score launches {[r['launches'] for r in ranks]}; peak "
          f"memory per rank {[round(r['peak'] / 1e9, 2) for r in ranks]} GB; the pair took "
          f"{pair_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# phase analysis: analysis/ and cli.analyze_ed on the card. The flash-score
# kernel has no backward (in JAX or here): the analysis differentiates the
# plain sweep (use_pallas=False), and the kernel route refuses inputs that
# require grad
AN_IMSIZE = 16  # cli.analyze_ed --image_size (the JAX CLI's tractability option)
AN_STEPS = 20
AN_K = 5  # cli.analyze_ed's default --kernel_size
AN_MAX_SAMPLES = 1000  # its default --max_samples
AN_BATCH = 64  # its default --scorebatchsize
AN_CPU_MAX_SAMPLES = 64  # the card-against-CPU step's bbELS: 128 images (CPU time)
AN_BIG_MAX_SAMPLES = 256  # (d): bbELS at 32x32, 320 images
AN_T = 0.5  # the step of gates (c) and (e)
JAC_TOL = 1e-5  # (b): max|J32 - J64| / max|J64|
CLOSED_TOL = 1e-5  # (e): ||J - J^T||_F / ||J||_F of the IS field
# (f): the sets' shapes (the published train splits' sizes) and the d^2
# bound, in float32 ulps (2^-24) of ||a||^2 + ||b||^2: the CPU's float32
# reaches up to 11 at d = 300
PATCH_SETS = {"mnist": (60000, 28, 1), "cifar10": (FULL_N, 32, 3),
              "celeba": (162770, 64, 3)}
PATCH_SIZES = (3, 6, 10)  # cli.patch_stats defaults
PATCH_SAMPLES = 200
D2_ULPS = 32


def an_x(images16, seed):
    """A point of the reverse trajectory at t = AN_T: a set image noised as
    the forward process does, [1, 16, 16, 3] on the card."""
    beta = cosine_noise_schedule(torch.tensor(AN_T))
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    img = torch.as_tensor(images16[:1], device="cuda")
    return torch.sqrt(1 - beta) * img + torch.sqrt(beta) * torch.randn(
        img.shape, generator=g, device="cuda")


def an_repair(images16, labels, seed):
    """(a) A bbELS field on the kernel route raises under jacrev; with
    use_pallas=False its Jacobian is non-zero and no kernel launches."""
    from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import jacobian_nd

    x = an_x(images16, seed)
    kw = dict(kernel_size=3, batch_size=16, device="cuda")
    routed = LocalEquivBordersScoreModule((images16[:64], labels[:64]), **kw)
    reset_launches()
    routed(AN_T, x)  # eager, bank cached: the kernel
    eager = sum(fs.flash_score_update.launches.values())
    try:
        jacobian_nd(x, lambda xb: routed(AN_T, xb))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        refusal = str(e).split(":")[0]
    else:
        fail("analysis (a): jacrev through the kernel route did not raise")
    plain = LocalEquivBordersScoreModule((images16[:64], labels[:64]), use_pallas=False, **kw)
    plain(AN_T, x)
    before = dict(fs.flash_score_update.launches)
    J = jacobian_nd(x, lambda xb: plain(AN_T, xb))
    ran = {k_: n - before[k_] for k_, n in fs.flash_score_update.launches.items()
           if n != before[k_]}
    norm = J.norm().item()
    print(f"[analysis] (a) bbELS k=3, 64 images 16x16: the kernel route's eager call "
          f"launched {eager} kernel(s); under jacrev it raised ({refusal!r}); "
          f"use_pallas=False: ||J||_F {norm:.4e}, kernel launches in the Jacobian "
          f"{ran or 0}", flush=True)
    if not eager or ran or not (norm > 0 and math.isfinite(norm)):
        fail(f"analysis (a): eager launches {eager}, Jacobian launches {ran}, ||J|| {norm}")


def an_timed(fn):
    """(result, wall seconds, peak GB) of fn() on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def an_flagship_jacobian(seed):
    """(b) One full-width Jacobian of the flagship CNN (conditional, label 3:
    its float64 copy then runs in float64 past the float32 time embedding;
    seeded weights) at 32x32x3, n = 3072, at 'highest' against the same
    Jacobian in float64 on the card; the TF32 model must miss the gate."""
    from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import (
        jacobian_chunk,
        jacobian_nd,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 32, 32, 3), generator=g, device="cuda")
    label = torch.full((1,), 3, device="cuda")
    model = flagship("cuda", seed=seed)
    field = lambda xb: model(AN_T, xb, label)  # noqa: E731
    chunk = jacobian_chunk(lambda xf: field(xf.reshape(1, 32, 32, 3)).reshape(-1),
                           x.reshape(-1))
    J32, wall, peak = an_timed(lambda: jacobian_nd(x, field))
    model64 = flagship("cuda", seed=seed).double()
    J64, wall64, peak64 = an_timed(lambda: jacobian_nd(
        x.double(), lambda xb: model64(AN_T, xb, label)))
    tf32 = flagship("cuda", precision=None, seed=seed)
    Jtf, wall_tf, _ = an_timed(lambda: jacobian_nd(x, lambda xb: tf32(AN_T, xb, label)))
    scale = J64.abs().max().item()
    err = (J32.double() - J64).abs().max().item() / scale
    err_tf = (Jtf.double() - J64).abs().max().item() / scale
    print(f"[analysis] (b) flagship Jacobian 3072 x 3072 at t={AN_T}, label 3: 'highest' "
          f"{wall:.3f} s, peak {peak:.2f} GB, {chunk} lanes a chunk; float64 {wall64:.3f} s, "
          f"peak {peak64:.2f} GB; TF32 {wall_tf:.3f} s. max|J - J64| / max|J64| "
          f"(= {scale:.4e}): 'highest' {err:.3e}, TF32 {err_tf:.3e} (gate {JAC_TOL:g}; TF32 "
          f"must miss it)", flush=True)
    if not err <= JAC_TOL or not err_tf > JAC_TOL:
        fail(f"analysis (b): 'highest' {err:.3e}, TF32 {err_tf:.3e} against {JAC_TOL}")
    del J32, J64, Jtf, model, model64, tf32


def an_realizations(ds50, images16, seed):
    """(c) cli.analyze_ed's realization loop at --image_size 16: the
    flagship and bbELS (k = 5, max_samples 1000 over the 50000-image set),
    20 steps, one realization, no flash-score launch; then one step's ED
    card against CPU on the same x (bbELS at max_samples 64, as the devices
    phase's small machines)."""
    from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import (
        compute_exterior_derivative_nd,
    )
    from convolutional_diffusion_tpu_torch.cli import analyze_ed as ed

    def fields(device, max_samples, net):
        return {"resnet": (ed.model_field(net), False),
                "bbels": (ed.bbels_field(images16, ds50.labels, kernel_size=AN_K,
                                         batch_size=AN_BATCH, max_samples=max_samples,
                                         device=device), True)}

    shape = (1, AN_IMSIZE, AN_IMSIZE, 3)
    model = flagship("cuda", conditional=False, seed=seed)
    card = ed.warm(fields("cuda", AN_MAX_SAMPLES, model), shape, "cuda", log=print)
    if len(card) != 2:
        fail(f"analysis (c): warm-up dropped a field: {list(card)}")
    reset_launches()
    (results, finals, secs), wall, peak = an_timed(lambda: ed.realizations(
        card, image_size=AN_IMSIZE, channels=3, nsteps=AN_STEPS, n_real=1, seed=seed,
        device="cuda", log=lambda s: None))
    ran = {k_: n for k_, n in fs.flash_score_update.launches.items() if n}
    ok = all(np.isfinite(v).all() and (v > 0).all() for v in results.values()) and all(
        np.isfinite(f).all() and f.shape == (AN_IMSIZE, AN_IMSIZE, 3) for f in finals.values())
    print(f"[analysis] (c) analyze_ed loop, {AN_IMSIZE}x{AN_IMSIZE}x3, {AN_STEPS} steps, 1 "
          f"realization, bbELS k={AN_K} over {ed.quota_images(FULL_N, AN_BATCH, AN_MAX_SAMPLES)}"
          f" of {FULL_N} images (max_samples {AN_MAX_SAMPLES}): "
          + ", ".join(f"{n} {s:.3f} s per step (ED first / middle / last "
                      f"{v[0, 0]:.4e} / {v[0, AN_STEPS // 2]:.4e} / {v[0, -1]:.4e})"
                      for (n, v), s in zip(results.items(), secs.values()))
          + f"; {wall:.2f} s in all, peak {peak:.2f} GB; flash-score launches {ran or 0}",
          flush=True)
    if not ok or ran:
        fail(f"analysis (c): finite and positive {ok}, launches {ran}")
    x = an_x(images16, seed)
    cpu_net = flagship("cpu", conditional=False, seed=seed)
    worst = {}
    for (name, (fn_card, _)), (fn_cpu, _) in zip(
            ed.warm(fields("cuda", AN_CPU_MAX_SAMPLES, model), shape, "cuda").items(),
            ed.warm(fields("cpu", AN_CPU_MAX_SAMPLES, cpu_net), shape, "cpu").values()):
        dfs = [compute_exterior_derivative_nd(x.to(dev), lambda xb, f=f: f(AN_T, xb)).cpu()
               for f, dev in ((fn_card, "cuda"), (fn_cpu, "cpu"))]
        mags = [d.norm().item() for d in dfs]
        worst[name] = rel(*dfs)
        print(f"[analysis] (c) {name} ED at t={AN_T}, card against CPU on one x: df rel "
              f"{worst[name]:.2e}, ||df||_F {mags[0]:.6e} / {mags[1]:.6e} (gate {TOL:g})",
              flush=True)
    if not max(worst.values()) <= TOL:
        fail(f"analysis (c): card against CPU {worst}")


def an_bbels_big(ds50, seed):
    """(d) One bbELS Jacobian at 32x32x3 (n = 3072), max_samples cut to 256."""
    from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import (
        compute_exterior_derivative_nd,
        exterior_derivative_magnitude,
    )
    from convolutional_diffusion_tpu_torch.cli import analyze_ed as ed

    fn = ed.bbels_field(ds50.images, ds50.labels, kernel_size=AN_K, batch_size=AN_BATCH,
                        max_samples=AN_BIG_MAX_SAMPLES, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    x = torch.randn((1, 32, 32, 3), generator=g, device="cuda")
    with torch.no_grad():
        fn(AN_T, x)
    df, wall, peak = an_timed(lambda: compute_exterior_derivative_nd(
        x, lambda xb: fn(AN_T, xb)))
    mag = exterior_derivative_magnitude(df)[0].item()
    print(f"[analysis] (d) bbELS Jacobian 3072 x 3072, k={AN_K}, t={AN_T}, max_samples cut to "
          f"{AN_BIG_MAX_SAMPLES} ({ed.quota_images(FULL_N, AN_BATCH, AN_BIG_MAX_SAMPLES)} "
          f"images; the CLI's default is {AN_MAX_SAMPLES}): {wall:.3f} s, peak {peak:.2f} GB, "
          f"||df||_F {mag:.4e}", flush=True)
    if not (math.isfinite(mag) and mag > 0):
        fail(f"analysis (d): ||df|| = {mag}")


def an_closed(ds50, images16, seed):
    """(e) The IS field is a gradient field: ||J - J^T|| / ||J|| at 16x16,
    beside bbELS's (information)."""
    from convolutional_diffusion_tpu_torch.analysis.exterior_derivative import jacobian_nd
    from convolutional_diffusion_tpu_torch.cli import analyze_ed as ed

    x = an_x(images16, seed)
    ideal = IdealScoreModule((images16, ds50.labels), batch_size=len(images16),
                             device="cuda")
    bb = ed.bbels_field(images16, ds50.labels, kernel_size=AN_K, batch_size=AN_BATCH,
                        max_samples=AN_MAX_SAMPLES, device="cuda")
    ratios = {}
    for name, fn in (("IS", lambda xb: ideal(AN_T, xb)), ("bbELS", lambda xb: bb(AN_T, xb))):
        with torch.no_grad():
            fn(x)  # eager first: bbELS caches its bank
        (J,), wall, _ = an_timed(lambda: jacobian_nd(x, fn))
        ratios[name] = ((J - J.T).norm() / J.norm()).item()
        print(f"[analysis] (e) {name} at {AN_IMSIZE}x{AN_IMSIZE}x3, t={AN_T}: ||J - J^T||_F / "
              f"||J||_F {ratios[name]:.3e} ({wall:.3f} s)", flush=True)
    if not ratios["IS"] <= CLOSED_TOL:
        fail(f"analysis (e): the IS field's ratio {ratios['IS']:.3e} > {CLOSED_TOL}")


def an_patch_stats(ds50, seed):
    """(f) analyze_patch_distances at the CLI defaults over sets of MNIST's,
    CIFAR10's (the synthetic 50000) and CelebA's shapes on the card; d^2
    held to float64 on the same patches within D2_ULPS float32 ulps of
    ||a||^2 + ||b||^2, which the gram product in TF32 must miss."""
    from convolutional_diffusion_tpu_torch.analysis import patch_statistics as ps
    from convolutional_diffusion_tpu_torch.ops.fp32 import tf32_products

    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = {}
    for name, (n, size, c) in PATCH_SETS.items():
        sets[name] = (torch.from_numpy(ds50.images).cuda() if name == "cifar10" else
                      torch.rand((n, size, size, c), generator=g, device="cuda") * 2 - 1)
    res, wall, _ = an_timed(lambda: ps.analyze_multiple_datasets(
        sets, patch_sizes=PATCH_SIZES, num_samples=PATCH_SAMPLES, make_plots=False,
        generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda",
        log_fn=lambda s: None))
    redraw = torch.Generator(device="cuda").manual_seed(seed)  # the same draws, in order
    worst, worst_tf = 0.0, math.inf
    iu = torch.triu_indices(PATCH_SAMPLES, PATCH_SAMPLES, 1, device="cuda")
    for name, images in sets.items():
        for k in PATCH_SIZES:
            if k not in res[name]:
                fail(f"analysis (f): {name} k={k} failed")
            flat = ps.random_patches(images, k, PATCH_SAMPLES, redraw).reshape(PATCH_SAMPLES, -1)
            f64 = flat.double()
            sq = (f64 * f64).sum(1)
            norms = sq[iu[0]] + sq[iu[1]]
            d2 = ((f64[:, None] - f64[None]) ** 2).sum(-1)[iu[0], iu[1]]
            got = torch.as_tensor(res[name][k]["_distances"], device="cuda").double() ** 2
            worst = max(worst, ((got - d2).abs() / norms).max().item() / 2**-24)
            with tf32_products(True):
                gram = flat @ flat.T
            sq32 = (flat * flat).sum(1)
            tf = torch.clamp(sq32[:, None] - 2 * gram + sq32[None], min=0)[iu[0], iu[1]]
            worst_tf = min(worst_tf, ((tf.double() - d2).abs() / norms).max().item() / 2**-24)
    print(f"[analysis] (f) analyze_patch_distances, patch sizes {PATCH_SIZES}, "
          f"{PATCH_SAMPLES} samples, on the card over "
          + ", ".join(f"{n} {tuple(v.shape)}" for n, v in sets.items())
          + f": {wall:.2f} s for the {len(sets) * len(PATCH_SIZES)} configurations (fits "
          f"included); best fits "
          + ", ".join(f"{n} " + "/".join(str(r[k]["fits"].get("best_fit")) for k in PATCH_SIZES)
                      for n, r in res.items())
          + f"; d^2 against float64: worst {worst:.2f} float32 ulps of ||a||^2 + ||b||^2 "
          f"(bound {D2_ULPS}), the TF32 gram's least worst {worst_tf:.1f} (must miss)",
          flush=True)
    if not worst <= D2_ULPS or not worst_tf > D2_ULPS:
        fail(f"analysis (f): d^2 {worst:.2f} ulps, TF32 {worst_tf:.1f}, bound {D2_ULPS}")


def phase_analysis(seed):
    """analysis/ and cli.analyze_ed's loop on the card: gates (a)-(f)."""
    from convolutional_diffusion_tpu_torch.cli.analyze_ed import resize_images

    t0 = time.perf_counter()
    ds50 = synthetic_dataset(num_samples=FULL_N, image_size=32, num_channels=3, seed=seed)
    images16 = resize_images(ds50.images, AN_IMSIZE)
    print(f"[analysis] the {FULL_N}-image synthetic 32x32x3 set and its {AN_IMSIZE}x"
          f"{AN_IMSIZE} resize: {time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    an_repair(images16, ds50.labels, seed)
    an_flagship_jacobian(seed)
    an_realizations(ds50, images16, seed)
    an_bbels_big(ds50, seed)
    an_closed(ds50, images16, seed)
    an_patch_stats(ds50, seed)
    torch.cuda.empty_cache()
    print(f"[analysis] phase: {time.perf_counter() - t0:.1f} s", flush=True)


# phase loader: the native C++ loader built from native/loader.cpp on this
# machine, its batches exact, and the flagship recipe's steps fed from it
LOADER_N = FULL_N
LOADER_FILES_N = 256  # IDX and CIFAR-bin records: labels 0..255 name them
LOADER_STEPS = 20


def loader_expect(u8, labels):
    """The loader's normalisation of the images its labels name, in float32
    as the C++ computes it: (u8 / 255 - 0.5) / 0.5."""
    return (u8[labels].astype(np.float32) / np.float32(255.0) - np.float32(0.5)) / np.float32(0.5)


def loader_exact(tag, ld, u8, batches=3):
    """`batches` batches (next and next_device alternately) equal the
    normalisation of the images their labels name, bit for bit."""
    for i in range(batches):
        if i % 2:
            xb, yb = (t.cpu().numpy() for t in ld.next_device("cuda"))
        else:
            xb, yb = ld.next()
        if not np.array_equal(xb, loader_expect(u8, yb)):
            fail(f"loader: a {tag} batch differs from its images")


def loader_steps(tag, step, batch_fn):
    """ms per step of LOADER_STEPS flagship steps fed by batch_fn, after 3."""
    for _ in range(3):
        step(*batch_fn())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LOADER_STEPS):
        loss = step(*batch_fn())
    end.record()
    torch.cuda.synchronize()
    if not torch.isfinite(loss):
        fail(f"loader: {tag}'s loss is not finite")
    return start.elapsed_time(end) / LOADER_STEPS


def phase_loader(seed):
    import struct
    import tempfile

    from convolutional_diffusion_tpu_torch.utils import native_loader as nl

    t0 = time.perf_counter()
    try:
        built = nl.build()
    except RuntimeError as e:
        fail(f"loader: native/loader.cpp does not build here: {e}")
    if not nl.is_available():
        fail("loader: the built library does not load")
    print(f"[loader] built {built.path.relative_to(_build.BUILD_DIR.parents[1])} in "
          f"{built.seconds:.2f} s ({'reused' if not built.seconds else 'compiled'}; "
          f"{' '.join(nl.CXXFLAGS)})", flush=True)
    rs = np.random.RandomState(seed)
    u8 = rs.randint(0, 256, size=(LOADER_N, 32, 32, 3), dtype=np.uint8)
    ld = nl.NativeLoader.from_arrays(u8, np.arange(LOADER_N, dtype=np.int32),
                                     batch_size=128, seed=seed)
    if ld.num_samples != LOADER_N or ld.shape != (32, 32, 3):
        fail(f"loader: from_arrays reports {ld.num_samples} samples of {ld.shape}")
    loader_exact("from_arrays", ld, u8)
    small = u8[:LOADER_FILES_N]
    with tempfile.TemporaryDirectory() as tmp:
        gray = small[..., 0]
        img, lab = os.path.join(tmp, "images-idx3-ubyte"), os.path.join(tmp, "labels-idx1-ubyte")
        with open(img, "wb") as f:
            f.write(struct.pack(">IIII", 0x803, LOADER_FILES_N, 32, 32) + gray.tobytes())
        with open(lab, "wb") as f:
            f.write(struct.pack(">II", 0x801, LOADER_FILES_N)
                    + np.arange(LOADER_FILES_N, dtype=np.uint8).tobytes())
        idx = nl.NativeLoader.from_idx(img, lab, batch_size=64, seed=seed)
        loader_exact("from_idx", idx, gray[..., None])
        idx.close()
        bins = []
        for part in range(2):  # two files, joined as the loader joins them
            rows = range(part * LOADER_FILES_N // 2, (part + 1) * LOADER_FILES_N // 2)
            path = os.path.join(tmp, f"data_batch_{part + 1}.bin")
            with open(path, "wb") as f:
                for i in rows:
                    f.write(bytes([i]) + small[i].transpose(2, 0, 1).tobytes())
            bins.append(path)
        cifar = nl.NativeLoader.from_cifar_bins(bins, batch_size=64, seed=seed)
        if cifar.num_samples != LOADER_FILES_N:
            fail(f"loader: from_cifar_bins read {cifar.num_samples} records")
        loader_exact("from_cifar_bins", cifar, small)
        cifar.close()
    print(f"[loader] batches bit-equal to their images: from_arrays ({LOADER_N} 32x32x3, "
          f"next and next_device), from_idx and from_cifar_bins ({LOADER_FILES_N} records "
          f"each, temporary files)", flush=True)
    model = flagship("cuda", seed=seed)
    state = TrainState(model, TrainConfig(batch_size=128, seed=seed))
    step = make_train_step(state, conditional=True)
    n = 128 * LOADER_STEPS
    images = torch.from_numpy(loader_expect(u8, np.arange(n))).cuda()
    labels = torch.from_numpy(np.arange(n) % 10).cuda()
    perm = torch.randperm(n, device="cuda")
    it = itertools.count()

    def array_batch():
        i = next(it) % LOADER_STEPS
        idx = perm[i * 128:(i + 1) * 128]
        return images[idx], labels[idx]

    def loader_batch():
        xb, yb = ld.next_device("cuda")
        return xb, yb % 10

    ms = {"loader": loader_steps("loader", step, loader_batch),
          "arrays": loader_steps("arrays", step, array_batch),
          "loader again": loader_steps("loader", step, loader_batch)}
    ld.close()
    print("[loader] flagship 'highest' train steps, batch 128, by CUDA events over "
          f"{LOADER_STEPS} steps: " + ", ".join(
              f"{k_} {v:.3f} ms ({128 / v * 1e3:.1f} images/s)" for k_, v in ms.items()),
          flush=True)
    small_model = flagship("cuda", seed=seed)
    ds = (loader_expect(u8, np.arange(256)), np.arange(256) % 10)
    seen = []
    real = nl.NativeLoader.next_device

    def spy(self, device):
        seen.append(1)
        return real(self, device)

    nl.NativeLoader.next_device = spy
    try:
        _, hist = train_diffusion(small_model, ds, TrainConfig(epochs=1, batch_size=64),
                                  conditional=True, use_native_loader=True,
                                  log_fn=lambda s: None)
        given = nl.NativeLoader.from_arrays(u8[:256], np.arange(256) % 10, batch_size=64,
                                            seed=seed)
        _, hist2 = train_diffusion(small_model, None, TrainConfig(epochs=1, batch_size=64),
                                   conditional=True, native_loader=given,
                                   log_fn=lambda s: None)
        given.close()
    finally:
        nl.NativeLoader.next_device = real
    print(f"[loader] train_diffusion(use_native_loader=True) and (native_loader=, dataset "
          f"None): {len(seen)} batches from the loader, losses {hist[-1]:.4f} / "
          f"{hist2[-1]:.4f}; phase {time.perf_counter() - t0:.1f} s", flush=True)
    if len(seen) != 8 or not np.isfinite(hist + hist2).all():
        fail(f"loader: train_diffusion took {len(seen)} loader batches, losses {hist + hist2}")
    del model, small_model, images
    torch.cuda.empty_cache()


# phase profiling: utils/profiling.py on the card
PROF_N = 256  # the small ELS machine's bank images
PROF_TRAIN_STEPS = 3
PROF_TIMER_CALLS = 20
PROF_TIMER_TOL = 0.02


def phase_profiling(seed):
    """A trace of one small ELS machine call and PROF_TRAIN_STEPS train
    steps holds machine_step_k{k} for each step's k and train_step once a
    step; Timer agrees with CUDA events within 2%."""
    from collections import Counter

    from convolutional_diffusion_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    ds = synthetic_dataset(num_samples=PROF_N, image_size=32, num_channels=3, seed=seed)
    mod = LocalEquivScoreModule((ds.images, ds.labels), batch_size=MODULE_BATCH, device="cuda")
    machine = ScheduledScoreMachine(mod, scales=CIFAR10_SCALES)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, 32, 32, 3), generator=g, device="cuda")
    model = flagship("cuda", seed=seed)
    train = (ds.images[:8 * PROF_TRAIN_STEPS], ds.labels[:8 * PROF_TRAIN_STEPS])
    out_dir = SCRATCH / "profiling"
    shutil.rmtree(out_dir, ignore_errors=True)
    with profiling.trace(str(out_dir)) as prof:
        machine(x)
        train_diffusion(model, train, TrainConfig(epochs=1, batch_size=8), conditional=True,
                        log_fn=lambda s: None)
        torch.cuda.synchronize()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    want = Counter(f"machine_step_k{CIFAR10_SCALES[i]}"
                   for i in range(len(CIFAR10_SCALES) - 1, 0, -1))
    want["train_step"] = PROF_TRAIN_STEPS
    got = {name: spans.get(name, 0) for name in want}
    device_spans = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[profiling] trace {Path(prof.trace_path).name} ({os.path.getsize(prof.trace_path)} "
          f"bytes, {device_spans} device kernel spans): named ranges {dict(got)}", flush=True)
    if got != dict(want):
        fail(f"profiling: the trace's ranges {dict(got)} != {dict(want)}")
    xb = torch.randn((64, 32, 32, 3), generator=g, device="cuda")
    lab = torch.arange(64, device="cuda") % 10
    fwd = lambda: model(0.5, xb, lab)  # noqa: E731
    with torch.no_grad():
        timer_s, _ = profiling.Timer().time(fwd, iters=PROF_TIMER_CALLS, warmup=2)
        event_ms = cuda_ms(fwd, PROF_TIMER_CALLS)
    gap = abs(timer_s * 1e3 - event_ms) / event_ms
    print(f"[profiling] Timer {timer_s * 1e3:.3f} ms a call against CUDA events {event_ms:.3f} "
          f"ms (flagship forward, batch 64, {PROF_TIMER_CALLS} calls): {100 * gap:.2f}% apart "
          f"(gate {100 * PROF_TIMER_TOL:g}%); phase {time.perf_counter() - t0:.1f} s", flush=True)
    if not gap <= PROF_TIMER_TOL:
        fail(f"profiling: Timer {timer_s * 1e3:.3f} ms against CUDA events {event_ms:.3f} ms")
    del model, mod
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=RGB_N,
                    help="bank images of the RGB machines (depth)")
    ap.add_argument("--n-wide", type=int, default=WIDE_N,
                    help="bank images of the 16-channel ELS 'highest' machine "
                         "(the 'high' and 'default' ones take half)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parallel-worker", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.parallel_worker:
        parallel_worker(*args.parallel_worker)
        return 0
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
    n_wide = {"highest": args.n_wide, "high": args.n_wide // 2,
              "default": args.n_wide // 2}
    ds16 = synthetic_dataset(num_samples=max(n_wide.values()), image_size=32,
                             num_channels=WIDE_C, seed=args.seed + WIDE_C)
    images16_dev = torch.from_numpy(ds16.images[:256]).cuda()
    variant_recs, wide_ms = phase_variants(images_dev, images16_dev, gen)
    recs.update(variant_recs)
    del images_dev, images16_dev
    torch.cuda.empty_cache()
    print("[exact] worst rel of each variant against the exact dot sum, over the "
          "kernel, mxu1, k5 and variants cases: " + ", ".join(
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
    x16 = torch.randn((SEEDS, 32, 32, WIDE_C), generator=gen, device="cuda")
    ran, wide_walls = phase_wide(ds16, n_wide, x16, wide_ms, FULL_N)
    add(ran)
    del ds16
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
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
    add(phase_devices_wide(args.seed))
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_neural(args.seed)
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    ran, worst = phase_calibrate(args.seed)
    add(ran)
    for key, e in worst.items():  # the recipe-shape gate's, beside the kernel phase's
        recs[key]["max_abs_err"] = max(recs[key]["max_abs_err"], e)
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_cli_sample()
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_train(args.seed)
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    add(phase_parallel(args.seed))
    print(f"[time] {time.perf_counter() - t_start:.1f} s so far", flush=True)
    phase_analysis(args.seed)
    phase_loader(args.seed)
    phase_profiling(args.seed)
    print(f"[time] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    never = [key for key in recs if not path.get(key) and not keyword_only(key)]
    if never:
        fail(f"kernel variants never launched on the paths: {never} ({path})")
    for key in recs:
        if keyword_only(key):
            print(f"[variants] {key}: reached by no module path (keyword only, as in "
                  f"the JAX package); {path.get(key, 0)} path launches", flush=True)
    print(json.dumps({"kernels": [
        kernel_record(name, rec, path.get(name, 0)) for name, rec in recs.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
