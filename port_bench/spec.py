"""What a cell is made of, found by the names in `BENCHMARK.json`: the
configuration's file (`configs/`), the traffic mix (`traffic/<traffic>.
json`), the cell's correctness limits (`limits/<cell>.json`) and a reader
per per-layer metric (`metrics/<metric>.py`). A later cell, configuration,
traffic or metric is added as files and entries, without editing these."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # number -> {"limit": ..., and the readings it was set from}
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json; KeyError if it names
    none, FileNotFoundError if one of its files is missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        chips=entry["chips"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
    )


def reader(metric: str):
    """The `read(ctx)` of per-layer metric `metric` (`metrics/<metric>.py`):
    its value, or None where the run gave it nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path} for per-layer metric {metric!r}")
    mod_spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
