"""Run one cell of the port's benchmark once:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up makes the bank on the card from the
seed, builds (first run in a checkout) or loads the kernels of the
configuration's tier from `build/torch_kernels/`, builds the score module
through `cli.common.build_score_module` and the `ScheduledScoreMachine`
that `cli.els` builds, and calls the module once for each distinct kernel
size of the schedule with the cell's batch and labels, which fills the bank
cache and loads every kernel the window runs. The window is a closed loop
of `pipeline.generate_els_samples` calls, one client, `batch` new samples a
call (resuming in one output directory under TMPDIR, as the CLI does),
for `--seconds`. With `--trace 1` the window runs under `torch.profiler`
and the machine behind a span of the benchmark's; the line then carries
the per-layer metrics instead of the end-to-end ones. After the window the
program is freed and `check.judge` holds a sample of the written samples
against the plain reference.

The last line on stdout is the result, JSON; the compared numbers, each
with its limit, are the last lines on stderr and the last key of the
result. Exit codes: 2 without the cards the cell asks for, 3 when JAX or
the JAX package was loaded, 1 on any other failure; no result then.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
# run as a script, the harness's own directory would come first on the path
# and its modules would shadow others of those names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "port_bench"]
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import check, devtrace, inputs, spec, window  # noqa: E402
from port_bench.reference import machine as ref_machine  # noqa: E402
from port_bench.work import sweeps_fn  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "convolutional_diffusion_tpu")


def process_start() -> float:
    """When this process started, on `time.perf_counter`'s clock (the
    kernel's start time of the process; the module's import as a
    fallback)."""
    try:
        with open("/proc/self/stat") as f:
            after = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - int(after[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


class TimedMachine:
    """The machine behind the benchmark's span 'machine', which ends when
    the card has finished the call."""

    def __init__(self, machine, spans: window.Spans, cuda: bool):
        self.machine, self.spans, self.cuda = machine, spans, cuda

    def __getattr__(self, name):
        return getattr(self.machine, name)

    def __call__(self, *args, **kw):
        with self.spans.span("machine"):
            out = self.machine(*args, **kw)
            _sync(self.cuda)
        return out


def build_program(cell, seed: int, device, precision: str | None = None):
    """(machine, bank labels) of the cell over the bank of `seed`: the score
    module `cli.common.build_score_module` builds, at the configuration's
    precision unless `precision` says another, in the machine `cli.els`
    builds."""
    from convolutional_diffusion_tpu_torch.cli.common import build_score_module
    from convolutional_diffusion_tpu_torch.schedules import cosine_noise_schedule
    from convolutional_diffusion_tpu_torch.scores import ScheduledScoreMachine
    from convolutional_diffusion_tpu_torch.scores.bank import BankLedger

    cfg = cell.config
    images, labels = inputs.synthetic_bank(seed, cfg["num_images"], cfg["image_size"],
                                           cfg["channels"], cfg["num_classes"], device)
    module = build_score_module(
        cfg["module"], (images, labels), batch_size=cfg["scorebatchsize"],
        image_size=cfg["image_size"], channels=cfg["channels"],
        schedule=cosine_noise_schedule, max_samples=cfg["max_samples"],
        precision=precision or cfg["precision"], target_block=cfg["target_block"],
        bank_ledger=BankLedger(cfg["bank_budget_bytes"]), device=device)
    machine = ScheduledScoreMachine(module, in_channels=cfg["channels"],
                                    imsize=cfg["image_size"],
                                    noise_schedule=cosine_noise_schedule,
                                    scales=cfg["scales"])
    return machine, labels


def warm(machine, cell, seed: int, device) -> None:
    """One module call per distinct kernel size, in the machine's order,
    with the cell's batch and label form: fills the bank cache and loads
    every kernel the window's calls run."""
    cfg, tr = cell.config, cell.traffic
    scales, b = cfg["scales"], tr["batch"]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, cfg["image_size"], cfg["image_size"], cfg["channels"]),
                    generator=gen, device=device)
    label = None
    if tr["conditional"]:
        label = (np.arange(b) % tr["nlabels"]
                 if getattr(machine.backbone, "supports_vector_label", False) else 0)
    seen = set()
    for i in range(len(scales) - 1, 0, -1):
        if scales[i] not in seen:
            seen.add(scales[i])
            machine.backbone(torch.tensor(i, dtype=torch.float32) / len(scales), x,
                             label=label, k=scales[i])


def window_calls(machine, cell, seed: int, seconds: float, out_dir: str,
                 spans: window.Spans):
    """The closed loop of pipeline calls; (start, ends)."""
    from convolutional_diffusion_tpu_torch.pipeline import generate_els_samples

    cfg, tr = cell.config, cell.traffic
    b = tr["batch"]

    def call(i: int):
        with spans.span("pipeline"):
            generate_els_samples(
                machine, out_dir, numiters=(i + 1) * b, in_channels=cfg["channels"],
                image_size=cfg["image_size"], conditional=tr["conditional"],
                nlabels=tr["nlabels"], idealname=tr["idealname"], batch=b, fmt="npy",
                seed=seed, log_fn=lambda s: None)

    return window.closed_loop(call, seconds)


def window_sweeps(cell, seed: int, bank_labels: torch.Tensor, calls: int) -> list:
    """The least times (`roofline.Sweep`) of every sweep of the window's
    calls, from the shapes and the pairs the reference's weights admit."""
    cfg, tr = cell.config, cell.traffic
    ref = ref_machine.module(cfg["reference"])
    masks = {}

    def admitted(label):
        if label not in masks:
            masks[label] = (ref.weights(bank_labels, label, cfg) > 0).cpu().numpy()
        return masks[label]

    count = sweeps_fn(cfg["reference"])
    b = tr["batch"]
    out = []
    for i in range(calls):
        labs = [inputs.draw(seed, j, cfg["image_size"], cfg["channels"], tr["conditional"],
                            tr["nlabels"])[1] for j in range(i * b, (i + 1) * b)]
        out += count(cfg, admitted, labs)
    return out


def card(cuda: bool, chips: int, peak: int) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak, "power_limit": limit}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, start: float,
             out_root: str | None = None) -> dict:
    """One run of `cell` on `device`: set-up, the window, the check, and the
    metrics. Returns the result line (a dict, `checks` last)."""
    from convolutional_diffusion_tpu_torch.ops import flash_score as fs

    cfg, tr = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from convolutional_diffusion_tpu_torch.ops import _build

        _build.build_all([fs.KERNEL_OF[cfg["precision"]]])
        torch.cuda.reset_peak_memory_stats()
    machine, bank_labels = build_program(cell, seed, device)
    warm(machine, cell, seed, device)
    _sync(cuda)
    spans = window.Spans()
    target = TimedMachine(machine, spans, cuda) if trace else machine
    with tempfile.TemporaryDirectory(prefix="port_bench_", dir=out_root) as tmp:
        out_dir = os.path.join(tmp, "samples")
        before = dict(fs.flash_score_update.launches)
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0, ends = window_calls(target, cell, seed, seconds, out_dir, spans)
        _sync(cuda)
        if prof is not None:
            prof.stop()
        setup_s = t0 - start
        window_s = ends[-1] - t0
        launches = {k: v - before.get(k, 0) for k, v in fs.flash_score_update.launches.items()}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        written = len(ends) * tr["batch"]
        sweeps = window_sweeps(cell, seed, bank_labels, len(ends)) if trace else []
        del target, machine, bank_labels
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers, per_sample = check.judge(cfg, tr, seed, out_dir, written, device)
        print(f"port_bench: {cell.name} seed {seed}: set-up {setup_s:.2f} s, window "
              f"{window_s:.2f} s ({len(ends)} calls: "
              f"{', '.join(f'{b - a:.3f}' for a, b in zip([t0] + ends, ends))} s), "
              f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr, flush=True)
    ok, checks = check.verdict(numbers, cell.limits)
    failed = numbers["missing_samples"] + sum(
        g > cell.limits["sample_gap"]["limit"] or not drawn for g, drawn in per_sample.values())
    dev = card(cuda, cell.chips, peak)
    result = {"correct": ok, "attempted": written, "failed": int(failed)}
    if trace:
        tr_ = devtrace.collect(prof)
        busy = devtrace.busy_intervals(tr_.device)
        busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
        ctx = SimpleNamespace(
            cell=cell, calls=len(ends), batch=tr["batch"], window_s=window_s,
            sweeps=sweeps, device_ops=tr_.device,
            family_seconds=devtrace.family_seconds(tr_.device), busy_s=busy_s,
            launches=launches, spans=spans, peak_bytes=peak,
            precision=cfg["precision"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        dev.update(busy_s=busy_s / max(cell.chips, 1), window_s=window_s)
        result["device"] = dev
        result["breakdown"] = devtrace.breakdown(tr_)
    else:
        result["metrics"] = {
            "images_per_s": {"value": window.rate(tr["batch"], t0, ends), "unit": "images/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["device"] = dev
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    cell = spec.load(args.workload, ROOT)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", start)
    banned = banned_modules()
    if banned:
        print(f"port_bench: loaded in the process that ran the window: {banned}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
