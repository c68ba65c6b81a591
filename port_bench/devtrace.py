"""What the profiler's trace of a window says: the device operations with
their times, the family of flash-score kernel each belongs to, the union
of busy device time, and a breakdown of the device time and of the longest
idle gaps by what the host was doing then.

Families, from the kernel names the program's CUDA sources give
(`ops/csrc/`): 'k1' the fp32 loop's 1-D walk (`rows::rows_kernel<C, EPI,
false>`), 'k1_list' its tile-list walk (`<..., true>`: per-seed weights,
K5, or a prune mask, K6), 'split' and 'split_list' the split-dot loop's
(`cdt_split_rows::rows_kernel<C, MODE, LIST>`). A launch's passes belong to
its main loop: the live-tile flag pass and the split-dot pre-split pass
come before it on the stream, the merge pass after it. Every other device
operation has no family.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_MAIN = re.compile(r"(cdt_split_rows::)?rows_kernel<([^>]*)>")
_MANGLED = re.compile(r"rows_kernelI.*?Lb([01])E")
_BEFORE = ("live_tiles_kernel", "split_planes_kernel")
_AFTER = ("merge_splits_kernel",)


class Op(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    device: list  # Op, sorted by start
    host: list  # Op of the host's operations, sorted by start
    annotations: list  # Op of the named ranges (record_function), sorted by start


# named ranges of the program's (`utils.profiling.annotate`) and the
# benchmark's, for a profiler that does not say which events are ranges
_RANGE_PREFIXES = ("port_bench.", "machine_step_", "train_step", "ProfilerStep")


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


def _flag(ev, method: str):
    f = getattr(ev, method, None)
    return f() if f is not None else None


def collect(prof) -> Trace:
    """The device operations, host operations and named ranges of a finished
    `torch.profiler.profile` (a range's mirror on the device is no device
    operation)."""
    import torch

    device, host, ranges = [], [], []
    for ev in prof.profiler.kineto_results.events():
        op = Op(ev.name(), _ns(ev, "start"), _ns(ev, "duration"))
        act = _flag(ev, "activity_type")
        act = None if act is None else str(act)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if act is None or act in DEVICE_ACTIVITIES:
                device.append(op)
            continue
        user = _flag(ev, "is_user_annotation")
        if act == "user_annotation" or user or (
                act is None and user is None and op.name.startswith(_RANGE_PREFIXES)):
            ranges.append(op)
        else:
            host.append(op)
    names = {r.name for r in ranges}
    device = [op for op in device if op.name not in names]

    def by_start(ops):
        return sorted(ops, key=lambda o: o.start_ns)

    return Trace(by_start(device), by_start(host), by_start(ranges))


def main_family(name: str):
    """The family of a main-loop kernel's name (demangled, or mangled as
    `..rows_kernelILi3ELi0ELb0EEv..`), or None."""
    m = _MAIN.search(name)
    if m is not None:
        split, listed = m.group(1), m.group(2).split(",")[-1].strip() in ("true", "1")
    else:
        m = _MANGLED.search(name)
        if m is None:
            return None
        split, listed = "cdt_split_rows" in name, m.group(1) == "1"
    return ("split" if split else "k1") + ("_list" if listed else "")


def families(device: list) -> list:
    """The family of each device op (None: not a flash-score kernel)."""
    fam = [main_family(op.name) for op in device]
    nxt = None
    for i in range(len(device) - 1, -1, -1):  # passes before a main loop
        if fam[i] is not None:
            nxt = fam[i]
        elif any(p in device[i].name for p in _BEFORE):
            fam[i] = nxt
    prev = None
    for i, op in enumerate(device):  # the merge pass after it
        if main_family(op.name) is not None:
            prev = fam[i]
        elif any(p in op.name for p in _AFTER):
            fam[i] = prev
    return fam


def family_seconds(device: list) -> dict:
    """Device seconds by family ('other' for operations with none)."""
    out: dict = {}
    for op, f in zip(device, families(device)):
        key = f or "other"
        out[key] = out.get(key, 0.0) + op.dur_ns * 1e-9
    return out


def busy_intervals(device: list) -> np.ndarray:
    """The union of the device operations' intervals, [n, 2] ns."""
    merged = []
    for op in device:
        a, b = op.start_ns, op.start_ns + op.dur_ns
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return np.asarray(merged, dtype=np.int64).reshape(-1, 2)


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.sub(r"\(.*", "", name)[:120]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations with the most time, by short name, and the
    longest idle gaps between busy intervals, each named by the innermost
    named range and the innermost host operation under way at its
    middle."""
    by_name: dict = {}
    for op in trace.device:
        key = short_name(op.name)
        by_name[key] = by_name.get(key, 0.0) + op.dur_ns * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace.device)
    gaps = []
    events = trace.annotations + trace.host
    if len(busy) > 1 and events:
        starts, ends = busy[1:, 0], busy[:-1, 1]
        order = np.argsort(-(starts - ends))[:top]
        h0 = np.array([o.start_ns for o in events], dtype=np.int64)
        h1 = h0 + np.array([o.dur_ns for o in events], dtype=np.int64)
        dur = h1 - h0
        annot = np.arange(len(events)) < len(trace.annotations)
        for g in order:
            mid = (ends[g] + starts[g]) // 2
            inside = (h0 <= mid) & (h1 >= mid)
            names = []
            for sel in (inside & annot, inside & ~annot):
                if sel.any():
                    j = np.flatnonzero(sel)[np.argmin(dur[sel])]
                    names.append(events[j].name)
            gaps.append([" / ".join(names) or "no host event", float(starts[g] - ends[g]) * 1e-9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}
