"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` source compiles with `nvcc` into a shared library with a
plain C interface, loaded with `ctypes`. `build_all` compiles several
sources at once, one `nvcc` process each. The build happens at first use, in
`build/torch_kernels/` at the root of the checkout (git-ignored), under a
name that carries a hash of the source, the shared `csrc/*.cuh` headers and
the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Bank rows per tile of the split-dot kernels (`csrc/flash_score_split.cuh`,
# its BP). Part of the 'default' tier's function, which re-bases m once per
# tile; `flash_score.FAST_TILE` is this value, so the plain version follows.
SPLIT_TILE = 128

# The prune mask's cell (variant K6, `ops.prune`): PRUNE_ROWS query rows by
# PRUNE_BLOCK bank rows, one int32 skip flag each. Every kernel's query
# block and bank tile nest in it (static_asserts in the sources); the plain
# version and the mask builders read the same values.
PRUNE_ROWS = 64
PRUNE_BLOCK = 2048

# Query rows per thread block of each main loop: K1's ('k1',
# `flash_score.cu` rows::Rows: 128, and 'k1_bf16_exp', 64 with the bf16
# exponential, which runs one split), K2's per-row sums' ('k2_ws',
# `flash_score_split_ws.cuh` ws::BQ, the warp-specialised loop) and the
# split-dot loop ('split_dot', `flash_score_split_rows.cuh` BQ: the
# 'default' kernel and K2's wide modes). Each source static_asserts its own
# against the -D flag; `flash_score.sweep_plan` names a launch's loop and
# reads its rows for the grid.
SPLIT_BQ = {"k1": 128, "k1_bf16_exp": 64, "k2_ws": 128, "split_dot": 64}

# No --use_fast_math: the flash-score dots' fp32 sums and exp2f must stay
# full fp32.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DSPLIT_TILE={SPLIT_TILE}", f"-DPRUNE_ROWS={PRUNE_ROWS}",
    f"-DPRUNE_BLOCK={PRUNE_BLOCK}", f"-DK1_SPLIT_BQ={SPLIT_BQ['k1']}",
    f"-DK1_FAST_BQ={SPLIT_BQ['k1_bf16_exp']}",
    f"-DK2_SPLIT_BQ={SPLIT_BQ['k2_ws']}",
    f"-DSPLIT_DOT_BQ={SPLIT_BQ['split_dot']}",
]

_P = ctypes.c_void_p
# (q, bias, bank, values, dotscale, m_in, s1_in, s2_in, m_out, s1_out,
#  s2_out, M, rows_per_seed, P, d, c, mask, mask_stride, strategy, col0,
#  fast, scratch, split_rows, live, walked, device, stream): the flash-score
# kernels' C interface; bias is [M / rows_per_seed, P] (1-D weights:
# rows_per_seed = M); mask is null or the int32 skip mask
# [ceil(M / PRUNE_ROWS), mask_stride] of 1-D weights (K6); strategy is the
# value strategy's code (`flash_score.STRATEGY_CODE`), col0 the first center
# column of 'inbank' (-1 otherwise), fast 1 for the bf16 exponential;
# scratch (null or float32, `flash_score.sweep_plan`'s scratch_numel) and
# split_rows (the rows of its first split) are the main loops' (partial
# states of the splits, the split-dot kernels' bf16 planes); live is null
# (every tile walked) or, with per-seed weights, the int32 workspace
# [M / rows_per_seed, ceil(P / SPLIT_TILE)] the launch fills with its
# live-tile flags and walks by (K5); walked is null or int32, one per
# thread block: the bank tiles each walked, written by the list walks (K5,
# K6) only (`flash_score.sweep_kernel`'s tile_counts)
_FLASH_ARGS = [
    _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P, _P,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, _P, ctypes.c_longlong, _P, _P, ctypes.c_int, _P,
]

# name -> (source, C symbol, argtypes)
KERNELS = {
    "flash_score": ("flash_score.cu", "flash_score_f32", _FLASH_ARGS),
    "flash_score_bf16x3": (
        "flash_score_bf16x3.cu", "flash_score_bf16x3", _FLASH_ARGS,
    ),
    "flash_score_fast": ("flash_score_fast.cu", "flash_score_fast", _FLASH_ARGS),
    # (A, B, C, D, n): the tensor-core rounding probe of `ops.k2_numerics`
    "mma_probe": ("mma_probe.cu", "mma_probe", [_P, _P, _P, _P, ctypes.c_int]),
    # (A, B, C, D, n, lbo, sbo, use_c): the same for the warpgroup product
    "wgmma_probe": ("mma_probe.cu", "wgmma_probe",
                    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
}


class Built(NamedTuple):
    path: Path
    log: str  # nvcc output (ptxas registers / shared memory / spills)
    seconds: float  # 0.0 when an existing build was reused


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None
    )
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            "source at first use"
        )
    return found


def _target(name: str):
    """(source, library path) of kernel `name`; the path carries a hash of
    the source, the headers of `csrc/` it may include, and the flags."""
    src = CSRC / KERNELS[name][0]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names) -> dict:
    """Compile kernels `names` unless identical builds exist: one nvcc
    process per source, all started together. Returns name -> Built;
    raises if any build fails."""
    done, running = {}, {}
    for name in names:
        src, out = _target(name)
        log_path = out.with_suffix(".log")
        if out.exists():
            log = log_path.read_text() if log_path.exists() else ""
            done[name] = Built(out, log, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (src, out, tmp, proc, time.perf_counter())
    failed = []
    for name, (src, out, tmp, proc, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        done[name] = Built(out, log, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build(name: str) -> Built:
    """Compile kernel `name` unless an identical build exists."""
    return build_all([name])[name]


_LOADED: dict = {}


def load(name: str):
    """The ctypes function of kernel `name`, building it at first use."""
    fn = _LOADED.get(name)
    if fn is None:
        _, symbol, argtypes = KERNELS[name]
        lib = ctypes.CDLL(str(build(name).path))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn
