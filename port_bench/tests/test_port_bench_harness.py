"""CPU tests of the harness: resolving cells by name, the yardstick's
arithmetic, the window's arithmetic, the trace's reading, and the refusal to
run without a card."""

from __future__ import annotations

import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import devtrace, roofline, run, spec, window
from port_bench.work import sweeps_fn

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves(workload):
    cell = spec.load(workload, ROOT)
    assert cell.chips == 1 and cell.traffic["batch"] >= 1
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s", "setup_s"}
    assert cell.per_layer and all(callable(spec.reader(m["name"])) for m in cell.per_layer)
    assert set(cell.limits) == {"sample_gap", "seed_mismatch", "label_mismatch",
                                "missing_samples"}


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        spec.load("no-such.cell", ROOT)
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_benchmark_file_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).exists()
        assert set(json.loads((ROOT / c["file"]).read_text())["reduced"]) == set(c["reduced"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}


def test_bound_of_k1_at_k17():
    """K1 at M = 8192, P = 65536, k = 17 (d = 867): 2 M P d + 12 M P flops
    at 67 TFLOP/s is 13.99 ms; K2's three bf16 products at 989 TFLOP/s
    2.824 ms."""
    assert roofline.bound(8192, 65536, 867, 3, "highest") == pytest.approx(13.99e-3, rel=1e-3)
    assert roofline.bound(8192, 65536, 867, 3, "high") == pytest.approx(2.824e-3, rel=1e-3)


def test_bound_counts_admitted_pairs_only():
    full = roofline.bound(1024, 65536, 27, 3, "highest")
    assert roofline.bound(1024, 65536, 27, 3, "highest", pairs=0.1) == pytest.approx(full / 10)


def _config(n, scales, ref="els", precision="highest"):
    return dict(reference=ref, precision=precision, image_size=8, channels=1, num_images=n,
                scales=scales, target_block=36 * 4, scorebatchsize=4, max_samples=100)


def test_label_filtered_sweeps_count_admitted_pairs():
    """Two seeds with labels 0 and 1 over 10 images (labels 0, 1, 1, 0, 2,
    ...): each chunk of 4 images at k = 3 (36 rows an image) counts the
    pairs of each seed's own images, and reads the rows some seed admits."""
    labels = np.array([0, 1, 1, 0, 2, 2, 0, 1, 2, 2])
    cfg = _config(10, [3, 3])
    got = sweeps_fn("els")(cfg, lambda lab: labels == lab, [0, 1])
    assert [s.family for s in got] == ["k1_list"] * 3
    per_img, M = 36, 2 * 64
    for (i0, i1), s in zip([(0, 4), (4, 8), (8, 10)], got):
        adm = np.stack([labels[i0:i1] == 0, labels[i0:i1] == 1])
        P = (i1 - i0) * per_img
        want = roofline.bound(M, P, 9, 1, "highest", S=2, pairs=adm.mean(),
                              rows=adm.any(0).mean())
        assert s.seconds == pytest.approx(want)
    one = sweeps_fn("els")(cfg, lambda lab: np.ones(10, bool), [None, None])
    assert [s.family for s in one] == ["k1"] * 3
    assert one[0].seconds == pytest.approx(roofline.bound(M, 4 * per_img, 9, 1, "highest"))


def test_bbels_sweeps_have_border_regions():
    cfg = _config(6, [3, 5], ref="bbels", precision="high")
    got = sweeps_fn("bbels")(cfg, lambda lab: np.ones(6, bool), [None] * 3)
    fams = [s.family for s in got]
    assert fams.count("border") == 1 and set(fams) == {"split", "border"}
    border = next(s for s in got if s.family == "border")
    want = (4 * roofline.bound(3 * 4, 6 * 4, 25, 1, "highest") * 2
            + 16 * roofline.bound(3, 6, 25, 1, "highest"))
    assert border.seconds == pytest.approx(want)


def test_closed_loop_on_a_fake_clock():
    now = [100.0]
    calls = []

    def call(i):
        calls.append(i)
        now[0] += 3.0

    t0, ends = window.closed_loop(call, 10.0, clock=lambda: now[0])
    assert calls == [0, 1, 2, 3] and t0 == 100.0 and ends == [103.0, 106.0, 109.0, 112.0]
    assert window.rate(8, t0, ends) == pytest.approx(32 / 12)
    t0, ends = window.closed_loop(call, 0.0, clock=lambda: now[0])
    assert len(ends) == 1  # at least one call


def _op(name, start, dur):
    return devtrace.Op(name, start, dur)


def test_trace_families_and_busy_time():
    k1 = "void (anonymous namespace)::rows::rows_kernel<3, 0, false>(float const*)"
    k5 = "void (anonymous namespace)::rows::rows_kernel<3, 0, true>(float const*)"
    k2 = "void cdt_split_rows::rows_kernel<3, 1, false>(unsigned int const*)"
    ops = [_op("void cdt_splitbank::live_tiles_kernel<128>(float const*)", 0, 10),
           _op(k5, 10, 100), _op("void cdt_splitbank::merge_splits_kernel<3>(float)", 110, 5),
           _op("elementwise", 200, 20), _op(k1, 230, 50), _op("merge_splits_kernel", 280, 4),
           _op("void cdt_split_rows::split_planes_kernel(float const*)", 300, 6),
           _op(k2, 306, 60), _op("_ZN12_GLOBAL__N_14rows11rows_kernelILi3ELi0ELb1EEEvPKf", 400, 7)]
    assert devtrace.families(ops) == ["k1_list", "k1_list", "k1_list", None, "k1", "k1",
                                      "split", "split", "k1_list"]
    secs = devtrace.family_seconds(ops)
    assert secs["k1_list"] == pytest.approx(122e-9) and secs["other"] == pytest.approx(20e-9)
    busy = devtrace.busy_intervals(ops)
    assert busy.tolist() == [[0, 115], [200, 220], [230, 284], [300, 366], [400, 407]]
    host = [devtrace.Op("aten::copy_", 120, 70), devtrace.Op("aten::mul", 0, 300)]
    ranges = [devtrace.Op("port_bench.pipeline", 0, 500), devtrace.Op("machine_step_k3", 0, 300)]
    bd = devtrace.breakdown(devtrace.Trace(ops, host, ranges), top=2)
    assert bd["idle_gaps"][0][0] == "machine_step_k3 / aten::copy_"
    assert bd["idle_gaps"][0][1] == pytest.approx(85e-9)


def _ctx(**kw):
    base = dict(calls=2, batch=8, window_s=10.0, sweeps=[], family_seconds={}, busy_s=0.0,
                launches={}, spans=window.Spans(), peak_bytes=0, precision="highest")
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_readers_leave_out_what_they_cannot_read(metric):
    assert spec.reader(metric)(_ctx()) is None


def test_readers_arithmetic():
    ctx = _ctx(sweeps=[roofline.Sweep("k1", 2.0), roofline.Sweep("border", 1.0)],
               family_seconds={"k1": 4.0, "other": 0.5}, busy_s=9.0,
               launches={"flash_score": 3520}, peak_bytes=47e9)
    assert spec.reader("mfu_pct")(ctx) == pytest.approx(30.0)
    assert spec.reader("k1_roofline")(ctx) == pytest.approx(50.0)
    assert spec.reader("device_idle_pct")(ctx) == pytest.approx(10.0)
    assert spec.reader("nonflash_device_ms_per_call")(ctx) == pytest.approx(250.0)
    assert spec.reader("flash_launches_per_call")(ctx) == 1760
    assert spec.reader("peak_mem_gb")(ctx) == pytest.approx(47.0)
    assert spec.reader("k2_roofline")(ctx) is None  # not at 'high'


def test_run_without_a_card_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short run of the first cell on the card: correct, with both
    end-to-end metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.load(BENCH["workloads"][0]["name"], ROOT)
    result = run.run_cell(cell, 2**31 + 11, 1.0, False, "cuda", run.process_start())
    assert result["correct"] and set(result["metrics"]) == {"images_per_s", "setup_s"}
