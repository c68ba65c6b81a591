"""Readings that a cell's correctness limits are set from, in one process:

    python3 port_bench/calibrate.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]

For each seed, the timed path's own readings: the cell's program over the
bank of that seed, one call of the window's loop (the window's batch and
labels, written by the pipeline), then `check.judge` as a run judges.
For each control seed, the same call and then the control in the
program's place, judged the same way: with the configuration's
`control` {"dots": "tf32"}, the reference computed with TF32 products;
with {"precision": <tier>}, the program at that tier. Prints one line per
reading; the benchmark's runs never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "port_bench"]
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from port_bench import check, inputs, run, spec, window  # noqa: E402
from port_bench.reference import machine as ref_machine  # noqa: E402


def program_call(cell, seed: int, device, out_dir: str, precision: str | None = None) -> int:
    """One window call of the cell's program into out_dir; samples written."""
    machine, _ = run.build_program(cell, seed, device, precision)
    _, ends = run.window_calls(machine, cell, seed, 0.0, out_dir, window.Spans())
    del machine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return len(ends) * cell.traffic["batch"]


def control_outputs(cell, seed: int, device, out_dir: str, written: int) -> dict:
    """The control's outputs at the indices a run samples."""
    cfg, tr = cell.config, cell.traffic
    ctl = cfg["control"]
    idx = check.sample_indices(seed, written, tr["check_samples"])
    if "precision" in ctl:
        ctl_dir = out_dir + "_control"
        program_call(cell, seed, device, ctl_dir, ctl["precision"])
        return {j: check.load_saved(os.path.join(ctl_dir, tr["idealname"], f"{j:04d}")) for j in idx}
    images, labels = inputs.synthetic_bank(seed, cfg["num_images"], cfg["image_size"],
                                           cfg["channels"], cfg["num_classes"], device)
    out = {}
    for j in idx:
        x, lab = inputs.draw(seed, j, cfg["image_size"], cfg["channels"], tr["conditional"],
                             tr["nlabels"])
        out[j] = ref_machine.sample(x, lab, images, labels, cfg, ctl["dots"]).cpu().numpy()
    return out


def reading(cell, seed: int, device, control: bool) -> dict:
    with tempfile.TemporaryDirectory(prefix="port_bench_cal_") as tmp:
        out_dir = os.path.join(tmp, "samples")
        written = program_call(cell, seed, device, out_dir)
        outputs = control_outputs(cell, seed, device, out_dir, written) if control else None
        numbers, per_sample = check.judge(cell.config, cell.traffic, seed, out_dir, written,
                                          device, outputs=outputs)
    return dict(numbers, gaps={j: g for j, (g, _) in per_sample.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load(args.workload, ROOT)
    if args.device == "cuda":
        from convolutional_diffusion_tpu_torch.ops import _build, flash_score as fs

        tiers = {cell.config["precision"], cell.config["control"].get("precision",
                                                                      cell.config["precision"])}
        _build.build_all([fs.KERNEL_OF[t] for t in tiers])
    for what, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            r = reading(cell, seed, args.device, what == "control")
            print(f"[{cell.name}] {what} seed={seed} sample_gap={r['sample_gap']!r} "
                  f"seed_mismatch={r['seed_mismatch']} label_mismatch={r['label_mismatch']} "
                  f"missing={r['missing_samples']} gaps={r['gaps']} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
