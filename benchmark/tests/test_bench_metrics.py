"""The metric arithmetic: the trace reduction on a hand-made timeline and on
one recorded on an H100, the readers, the work counts."""

import json
from pathlib import Path

import numpy as np
import pytest

from harness import spec, trace, work
from harness.cell import Reservoir, Run

DATA = Path(__file__).resolve().parent / "data"


def _run(**kw):
    run = Run()
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_reduce_hand_made():
    # window [0, 100); problems [10, 50) and [60, 95); steps inside them
    events = [("k1(double*)", 12, 20), ("k2", 15, 30), ("void k1(double*)", 40, 45),
              ("k3", 70, 90), ("k4", 98, 120), ("k0", -10, 5)]
    spans = [("problem", 10, 50), ("problem", 60, 95), ("sep.schur", 10, 35),
             ("sep.eigenvalues", 35, 50), ("sep.schur", 60, 95)]
    r = trace.reduce(events, spans, (0, 100))
    assert r["window_s"] == pytest.approx(100e-9)
    # busy: [0,5) [12,30) [40,45) [70,90) [98,100) = 5 + 18 + 5 + 20 + 2
    assert r["busy_s"] == pytest.approx(50e-9)
    assert r["in_problems_s"] == pytest.approx(43e-9)
    assert dict(r["device_ops"]) == pytest.approx(
        {"k1": 13e-9, "k2": 15e-9, "k3": 20e-9, "k4": 2e-9, "k0": 5e-9})
    gaps = dict(r["idle_gaps"])
    # idle: [5,10) between, [10,12) schur, [30,35) schur, [35,40)
    # eigenvalues, [45,50) eigenvalues, [50,60) between, [60,70) schur,
    # [90,95) schur, [95,98) between
    assert gaps == pytest.approx({"idle in between steps": 18e-9,
                                  "idle in sep.schur": 22e-9,
                                  "idle in sep.eigenvalues": 10e-9})
    assert sum(gaps.values()) + r["busy_s"] == pytest.approx(r["window_s"])


def _brute_union(events, lo, hi, step=100):
    grid = np.zeros((hi - lo) // step + 1, bool)
    for _n, s, e in events:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            grid[(s - lo) // step:(e - lo + step - 1) // step] = True
    return grid.sum() * step * 1e-9


def test_reduce_recorded_h100_trace():
    """A timeline recorded on an H100 (two sep.hessenberg calls at n=600
    under torch.profiler's CUDA activity; 136 device operations)."""
    d = json.loads((DATA / "trace_h100_hessenberg_n600.json").read_text())
    events = [tuple(e) for e in d["events"]]
    lo, hi = d["window"]
    r = trace.reduce(events, [tuple(s) for s in d["spans"]], (lo, hi))
    assert len(events) == 136
    assert r["busy_s"] == pytest.approx(_brute_union(events, lo, hi), abs=len(events) * 2e-7)
    assert 0 < r["in_problems_s"] <= r["busy_s"] < r["window_s"]
    assert sum(v for _k, v in r["device_ops"]) >= r["busy_s"] - 1e-12
    assert r["device_ops"][0][0] == "hess_panel_kernel<true>"
    idle = sum(v for _k, v in r["idle_gaps"])
    assert idle + r["busy_s"] == pytest.approx(r["window_s"])
    # every device operation ran inside the window: the two clocks agree
    assert min(e[1] for e in events) >= lo and max(e[2] for e in events) <= hi


def test_readers():
    run = _run(window_s=10.0, durations=[0.1] * 19 + [0.5], launches=280, setup_s=12.5,
               spans={"sep.hessenberg": [0.1] * 20}, backward_error_u=42.0,
               stats={"sep.schur": [{"rounds": 20}, {"rounds": 30}] * 10})
    read = {m: spec.reader(m)(run) for m in (
        "solve_ms", "solve_p95_ms", "launches_per_solve", "hessenberg_ms", "setup_s",
        "backward_error_u", "aed_rounds", "schur_ms")}
    assert read["solve_ms"] == pytest.approx(500.0)
    assert read["solve_p95_ms"] == pytest.approx(100.0)         # rank 19 of 20
    assert read["launches_per_solve"] == 14
    assert read["hessenberg_ms"] == pytest.approx(100.0)
    assert read["aed_rounds"] == 25
    assert (read["setup_s"], read["backward_error_u"], read["schur_ms"]) == (12.5, 42.0, None)
    run.durations = [0.1] * 18 + [0.5, 0.6]
    assert spec.reader("solve_p95_ms")(run) == pytest.approx(500.0)


def test_device_readers():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    run = _run(durations=[0.1, 0.1], peak=peak,
               trace={"busy_s": 0.15, "window_s": 0.2, "in_problems_s": 0.12},
               work={"sep.hessenberg": [2 * 67e12 * 0.003, 1e6]})
    assert spec.reader("device_idle_pct")(run) == pytest.approx(25.0)
    assert spec.reader("roofline_pct")(run) == pytest.approx(100 * 0.006 / 0.12)
    run.work = {"sep.hessenberg": [1.0, 3.35e12 * 0.06]}       # bound by bytes
    assert spec.reader("roofline_pct")(run) == pytest.approx(50.0)
    assert work.peaks("a card not listed") is None             # no fallback peak
    run.peak = None
    assert spec.reader("roofline_pct")(run) is None


def test_work_counts():
    n = 100
    f, b = work.step_work("sep.hessenberg", n, {})
    assert (f, b) == (pytest.approx(14 * n ** 3 / 3), 8 * 3 * n * n)
    f, _b = work.step_work("sep.schur", n, {"aed_log": [(30, 20, 1), (0, 0, 0)]})
    assert f == 2 * 900 * 70 + 2 * 100 * 900
    f, _b = work.step_work("gep.schur", n, {"qz_log": [(30, 20, 1, False), (30, 0, 0, True)]})
    assert f == 2 * (2 * 900 * 70 + 2 * 100 * 900)
    f, _b = work.step_work("gep.reorder_schur", n, {"W": 10, "windows": 3})
    assert f == 3 * 2 * (2 * 100 * 90 + 2 * 100 * 100)
    f, b = work.step_work("gep.eigenvectors", n, {}, [(0, 1), (1, 2), (3, 1)])
    assert f == (0 + 2 * n * 1) + (2 * 2 * 1 + 2 * 2 * n * 3) + (2 * 9 + 2 * n * 4)
    assert b == 8 * (2 * 16 // 2 + 2 * n * 4)
    assert work.ht_cascade_flops(4) == 6 * 2 * 22 + 6 * 1 * 21
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.least_seconds(67e12, 0.0, peak) == pytest.approx(1.0)


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(40)
    for seed in range(400):
        r = Reservoir(8, seed)
        for k in range(40):
            r.offer(k)
        assert len(r.items) == 8 and len(set(r.items)) == 8
        counts[r.items] += 1
    assert counts.min() > 40 and counts.max() < 120          # 80 expected each
    a, b = Reservoir(4, 7), Reservoir(4, 7)
    for k in range(30):
        a.offer(k)
        b.offer(k)
    assert a.items == b.items
