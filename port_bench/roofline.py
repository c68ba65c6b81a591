"""The yardstick of the rooflines and the MFU: the published peaks of one
NVIDIA H100 SXM (dense, at its 700 W limit) and the least time of one score
sweep. Frozen here so that no change to the program moves it: the work is
counted from the inputs' shapes and the pairs the weights admit, never
from the tiles, splits or launches a kernel happens to use.

A sweep of M query rows over P bank rows of d features and c value
channels needs, per (query, bank row) pair, one dot of d products, the
logit, the running max, one exponential and the sums of the exponential
and of its c value products. Three units run side by side, and the busiest
sets the bound, as do the bytes over the memory rate (each input read once,
each output written once):

- 'highest': the dot's 2 d flops and (6 + 2 c) flops of the rest on the
  fp32 pipe;
- 'high': the three bf16 products of the split, 3 x 2 d, on the bf16
  tensor cores, and (6 + 2 c) on the fp32 pipe;
- 'default': as 'high', with the ln 2 multiply of the bf16 exponential on
  the fp32 pipe and the value products, 2 c, on the tensor cores;
- every tier: one exp2 per pair on the SFU.

Only admitted pairs count: `pairs` is the share of the M x P pairs whose
bank row has a weight above 0 for the query's seed, `rows` the share of
bank rows that some seed admits (their bytes are read).
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_FP32 = 67e12  # flop/s, fp32 outside the tensor cores
PEAK_BF16 = 989e12  # flop/s, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s, HBM3
SFU_RATE = 16 * 132 * 1.98e9  # exp2/s: 16 per clock per SM, 132 SMs, 1.98 GHz


class Sweep(NamedTuple):
    """The least time, in seconds, of one sweep whose work runs on the
    kernel family `family` ('k1', 'k1_list', 'split', 'split_list' or
    'border': see `trace.family`)."""

    family: str
    seconds: float


def bound(M: int, P: int, d: int, c: int, precision: str, *, S: int = 1,
          pairs: float = 1.0, rows: float = 1.0) -> float:
    """Least seconds of a sweep of M query rows (S seeds) over P bank rows;
    see the module docstring."""
    fast = precision == "default"
    elem = (6 + (1 if fast else 0)) * M * P
    tc = 0.0 if precision == "highest" else 3 * 2 * M * P * d
    if precision == "highest":
        elem += 2 * M * P * d
    if fast:
        tc += 2 * c * M * P
    else:
        elem += 2 * c * M * P
    t_ops = max(tc / PEAK_BF16, elem / PEAK_FP32, M * P / SFU_RATE) * pairs
    nbytes = 4 * (M * d + M + rows * (P * d + P + P * c) + S * P + 2 * M * (2 + c))
    return max(t_ops, nbytes / PEAK_BYTES)


def chunks(n: int, h: int, w: int, k: int, target_block: int):
    """(per_img, [(first image, end image), ...]) of the bank chunks a sweep
    of kernel size k walks: `target_block // per_img` images a chunk, at
    most n, the chunking that the inputs' shapes and the configuration's
    target block fix."""
    per_img = (h - k + 1) * (w - k + 1)
    cs = max(1, min(target_block // max(per_img, 1), n))
    return per_img, [(i, min(n, i + cs)) for i in range(0, n, cs)]


def split_family(precision: str, per_seed: bool) -> str:
    """The kernel family of a flash-score sweep at `precision`."""
    base = "k1" if precision == "highest" else "split"
    return base + ("_list" if per_seed else "")
