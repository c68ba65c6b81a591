"""The comparison that decides `correct` fails what it must, at a size the
CPU holds: each cell's run with the timed path broken underneath, and its
control in the program's place, judged by the cell's own limits. One chip
and no exchange between chips, so that fault is not the cells' to have."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from port_bench import calibrate, check, run

from convolutional_diffusion_tpu_torch.scores import ScheduledScoreMachine
from convolutional_diffusion_tpu_torch.scores import els as port_els
from convolutional_diffusion_tpu_torch.scores import machine as port_machine

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell):
    return run.run_cell(cell, 2**31 + 3, 0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    result = _run(tiny_cell(name))
    assert result["correct"] and result["failed"] == 0, result["checks"]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(port_machine, "ddim_step", lambda x, eps, beta_t, beta_prev: x)


def _half_bank(monkeypatch):
    inner = port_els.flash_score_update

    def half(q, qn, bank, pn, values, w, *args, **kw):
        w = w.clone()
        w[..., w.shape[-1] // 2:] = 0.0  # the mean over the first half alone
        return inner(q, qn, bank, pn, values, w, *args, **kw)

    monkeypatch.setattr(port_els, "flash_score_update", half)


def _answer_altered(monkeypatch):
    inner = ScheduledScoreMachine.__call__

    def altered(self, x, *args, **kw):
        out = inner(self, x, *args, **kw).clone()
        out[:, 0, 0, 0] += 2e-2
        return out

    monkeypatch.setattr(ScheduledScoreMachine, "__call__", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_bank, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
    fault(monkeypatch)
    result = _run(tiny_cell(name))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, monkeypatch, name):
    """The configuration's control (TF32 products in the reference, or the
    program at the tier below) in the program's place fails the cell's
    limit on each of three seeds."""
    cell = tiny_cell(name)
    monkeypatch.setattr(calibrate.spec, "load", lambda workload, root: cell)
    for seed in (1, 2, 2**31 + 5):
        reading = calibrate.reading(cell, seed, "cpu", control=True)
        ok, checks = check.verdict({k: reading[k] for k in cell.limits}, cell.limits)
        assert not ok, checks
