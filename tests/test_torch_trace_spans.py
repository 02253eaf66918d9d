"""The port's tracer on the device trace's clock, and the spans and counters
its drivers place in their host loops (CPU).

* the tracer stamps ``time.time_ns()``: ``events_ns()`` returns the spans
  on that clock and agrees with the dumped seconds since
  ``enable_tracing()``; with tracing off ``trace_span`` is one shared
  context manager that reads no clock and records nothing;
* ``ops.schur.schur`` and ``ops.qz_driver.qz_schur`` above their small
  limits (the AED path) with tracing on: each round is one ``*.scan``
  span and then ``*.window`` + ``*.apply`` or ``qz.infinite``; the sweep
  spans match the trains of ``stats["round_log"]``; one ``round_log``
  entry a round, ``chase_steps`` its sum; ``aed_log`` and ``qz_log`` keep
  their entries; the outputs are bit-identical with tracing on and off;
* the HT reduction's ``ht.qr`` and ``ht.block`` spans and the pencil
  reordering's ``reorder.window`` spans;
* ``gpu_gep.ht_step_launches``, the kernels G1's C entries launch a call;
* ``chip_ab.idle_by_span`` on a hand-made timeline: idle time inside a
  step goes to the innermost program span over it, the rest to the step,
  and each step's total is the benchmark's (``harness/trace.py:reduce``).
"""

import contextlib
import time
import tracemalloc

import numpy as np
import pytest
import torch

from starneig_tpu_torch.api import gep
from starneig_tpu_torch.config import SchurConf
from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import qz_driver as tqd
from starneig_tpu_torch.ops import schur as tschur
from starneig_tpu_torch.ops.hess_triangular import NB, blocks
from starneig_tpu_torch.testing.generators import known_spectrum_pencil
from starneig_tpu_torch.tools import trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable_tracing()
    yield
    trace.disable_tracing()


def _traced(fn):
    """fn() with tracing on: (its result, the events recorded)."""
    trace.enable_tracing()
    try:
        out = fn()
    finally:
        trace.disable_tracing()
    return out, list(trace._EVENTS)


def test_tracer_stamps_on_the_time_ns_clock(tmp_path):
    t0 = time.time_ns()
    trace.enable_tracing()
    with trace.trace_span("outer", (0, 0, 8, 8)):
        time.sleep(0.002)
        with trace.trace_span("inner"):
            time.sleep(0.001)
    trace.disable_tracing()
    t1 = time.time_ns()
    got = trace.events_ns()
    assert [g[0] for g in got] == ["inner", "outer"]
    (_, bi, ei), (_, bo, eo) = got
    assert t0 <= bo <= bi <= ei <= eo <= t1
    assert eo - bo >= 3_000_000 and ei - bi >= 1_000_000
    assert all(isinstance(x, int) for g in got for x in g[1:])
    dumped = __import__("json").loads(
        open(trace.dump_trace(str(tmp_path / "t.json"), n=8)).read())
    for (label, b, e), ev in zip(got, dumped["events"]):
        assert ev["label"] == label and set(ev) == {"label", "begin", "end", "rect"}
        assert abs((b - trace._T0) - ev["begin"] * 1e9) <= 1000
        assert abs((e - trace._T0) - ev["end"] * 1e9) <= 1000


def test_disabled_span_is_a_shared_no_op(monkeypatch):
    class NoClock:
        def time_ns(self):
            raise AssertionError("a disabled span read the clock")

        time = time_ns

    trace.enable_tracing()                 # clears what earlier tests recorded
    trace.disable_tracing()
    monkeypatch.setattr(trace, "time", NoClock())
    cm = trace.trace_span("a", (0, 0, 1, 1), extra=1)
    assert cm is trace.trace_span("b")
    assert not isinstance(cm, contextlib._GeneratorContextManager)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for k in range(2000):
            with trace.trace_span("loop", (k, k, 1, 1)):
                pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 1024
    assert trace._EVENTS == [] and trace.events_ns() == []


def _rounds(events, prefix):
    """The driver's round and sweep spans, grouped: a list of the round
    spans' label lists (each from its scan on), and the sweep spans."""
    rounds, sweeps = [], []
    for e in events:
        if e["label"] == f"{prefix}.sweep":
            sweeps.append(e)
        elif e["label"] == f"{prefix}.scan":
            rounds.append([e])
        elif e["label"].startswith(prefix + "."):
            rounds[-1].append(e)
    return rounds, sweeps


@pytest.fixture(scope="module")
def sep_runs():
    """schur at n=48 above its small limit (WA = 32, B = 4), traced and
    not."""
    n = 48
    A = np.random.default_rng(0).standard_normal((n, n))
    H = torch.as_tensor(np.triu(A, -1))
    conf = SchurConf(small_limit=32, aed_window_size=16, aed_shift_count=8)
    st_off, st_on = {}, {}
    off = tschur.schur(H, conf=conf, stats=st_off)
    on, events = _traced(lambda: tschur.schur(H, conf=conf, stats=st_on))
    return off, st_off, on, st_on, events


def test_schur_spans_and_round_log(sep_runs):
    off, st_off, on, st_on, events = sep_runs
    assert st_on["path"] == "aed" and int(on[4]) == 0
    rlog, alog = st_on["round_log"], st_on["aed_log"]
    assert len(rlog) == len(alog) == st_on["rounds"] > 1
    assert st_on["chase_steps"] == sum(r[3] for r in rlog) > 0
    rounds, sweeps = _rounds(events, "schur")
    assert len(rounds) == st_on["rounds"]
    for k, (spans, (l, ihi, ntr, steps), (w, kbot, ntr_a)) in enumerate(
            zip(rounds, rlog, alog)):
        labels = [e["label"] for e in spans]
        assert ntr == ntr_a and 0 <= l <= ihi and steps >= 0
        if labels == ["schur.scan"]:          # the scan deflated the rest
            assert k == len(rounds) - 1 and ihi == 0 and steps == 0
            continue
        assert labels == ["schur.scan", "schur.window", "schur.apply"]
        assert spans[1]["rect"][2:] == [w, w] and steps > 0
    # one wavefront a round with trains, over the round's segment
    assert [e["rect"] for e in sweeps] == [[l, l, ihi - l, ihi - l]
                                           for l, ihi, ntr, _s in rlog if ntr]


def test_schur_traced_is_bit_identical(sep_runs):
    off, st_off, on, st_on, events = sep_runs
    for a, b in zip(off[:4], on[:4]):
        assert torch.equal(a, b)
    assert off[4] == on[4]
    assert st_off == st_on
    assert all(len(r) == 3 for r in st_on["aed_log"])


@pytest.fixture(scope="module")
def gep_runs():
    """qz_schur at n=48 (WA = 32, B = 6) on the known pencil with infinite
    eigenvalues (the rounds take the infinite push), traced and not."""
    A, B, _a, _b = known_spectrum_pencil(48, complex_ratio=0.3, inf_ratio=0.1, seed=0)
    H, T, Q, Z = gep.hessenberg_triangular(A, B, device="cpu")
    st_off, st_on = {}, {}
    off = tqd.qz_schur(H, T, Q, Z, stats=st_off)
    on, events = _traced(lambda: tqd.qz_schur(H, T, Q, Z, stats=st_on))
    return off, st_off, on, st_on, events


def test_qz_spans_and_round_log(gep_runs):
    off, st_off, on, st_on, events = gep_runs
    assert on[7] == 0 and st_on["inf_rounds"] > 0
    rlog, qlog = st_on["round_log"], st_on["qz_log"]
    assert len(rlog) == len(qlog) == st_on["rounds"] > 1
    assert st_on["chase_steps"] == sum(r[3] for r in rlog) > 0
    rounds, sweeps = _rounds(events, "qz")
    assert len(rounds) == st_on["rounds"]
    for k, (spans, (l, ihi, ntr, steps), (w, kbot, ntr_q, do_inf)) in enumerate(
            zip(rounds, rlog, qlog)):
        labels = [e["label"] for e in spans]
        assert ntr == ntr_q and isinstance(do_inf, bool)
        if do_inf:
            assert labels == ["qz.scan", "qz.infinite"] and steps == 0 == ntr
        elif labels == ["qz.scan"]:           # the scan deflated the rest
            assert k == len(rounds) - 1 and ihi == 0 and steps == 0
        else:
            assert labels == ["qz.scan", "qz.window", "qz.apply"]
            assert spans[1]["rect"][2:] == [w, w] and steps > 0
    # one span a train, over the round's segment
    assert [e["rect"] for e in sweeps] == [[l, l, ihi - l, ihi - l]
                                           for l, ihi, ntr, _s in rlog for _t in range(ntr)]
    assert sum(r[2] for r in rlog) == len(sweeps) > 0


def test_qz_traced_is_bit_identical(gep_runs):
    off, st_off, on, st_on, events = gep_runs
    for a, b in zip(off[:7], on[:7]):
        assert torch.equal(a, b)
    assert off[7] == on[7]
    assert st_off == st_on
    assert all(len(r) == 4 for r in st_on["qz_log"])


def test_ht_and_reorder_spans():
    n = 40
    A, B, _a, _b = known_spectrum_pencil(n, complex_ratio=0.3, inf_ratio=0.0, seed=1)
    off = gep.hessenberg_triangular(A, B, device="cpu")
    on, events = _traced(lambda: gep.hessenberg_triangular(A, B, device="cpu"))
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    labels = [e["label"] for e in events]
    nblk = len(blocks(n, NB))
    assert labels == ["ht.qr"] + ["ht.block"] * (2 * nblk)
    S, T, Q, Z, *_rest = gep.schur(*on, device="cpu")
    sel = gep.select(S, T, lambda a, b: b != 0 and (a / b).real > 0)
    st = {}
    (_S, _T, _Q, _Z, m, _info), events = _traced(
        lambda: gep.reorder_schur(S, T, Q, Z, sel, stats=st, device="cpu"))
    wins = [e for e in events if e["label"] == "reorder.window"]
    assert len(wins) == st["windows"] > 0 and m > 0
    assert all(e["rect"][2:] == [st["W"], st["W"]] for e in wins)


@pytest.mark.parametrize("n", [5, 40, 2000])
def test_ht_step_launches(n):
    """Four kernels a cascade on a whole pencil, none past the last one
    (j > n - 3); a shard's masks launch their parts alone."""
    f = gpu_gep.ht_step_launches
    assert [f(n, n, 0, n, j, 7) for j in range(n)] == [4] * (n - 2) + [0, 0]
    assert f(n, n, 0, n, 0, 1) == 1 and f(n, n, 0, n, 0, 2) == 1
    assert f(n, n, 0, n, 0, 4) == 2
    # a shard left of the cascade's columns has no left pass
    assert f(n, 1, 0, 1, 2, 2) == 0 and f(n, 1, 0, 1, 2, 4) == 0
    if n == 2000:    # the whole reduction: 7,992 cascade kernels, 63 sliver launches
        assert sum(f(n, n, 0, n, j, 7) for j in range(n)) + len(blocks(n, NB)) == 8055


def test_idle_by_span_hand_made():
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "benchmark")]
    import chip_ab
    from harness.trace import reduce
    # window [0, 100); device busy [0,5) [12,30) [40,45) [70,90) [98,100)
    events = [("k1", 12, 20), ("k2", 15, 30), ("k1", 40, 45), ("k3", 70, 90),
              ("k4", 98, 120), ("k0", -10, 5)]
    spans = [("problem", 10, 50), ("problem", 60, 95), ("sep.schur", 10, 35),
             ("sep.eigenvalues", 35, 50), ("sep.schur", 60, 95)]
    # rounds [10, 34) and [60, 93): a scan, then a window holding a nested span
    prog = [("schur.scan", 10, 13), ("schur.window", 28, 34), ("inner", 31, 33),
            ("schur.scan", 60, 66), ("schur.window", 66, 93), ("inner", 88, 92)]
    got = chip_ab.idle_by_span(events, spans, prog, (0, 100))
    # idle in sep.schur: [10,12) scan; [30,31) window, [31,33) inner,
    # [33,34) window, [34,35) the step; [60,66) scan, [66,70) window;
    # [90,92) inner, [92,93) window, [93,95) the step
    assert got == {"sep.schur": {"schur.scan": 8, "schur.window": 7, "inner": 4,
                                 "sep.schur": 3},
                   "sep.eigenvalues": {"sep.eigenvalues": 10}}
    assert chip_ab.innermost(prog)[:3] == [[10, 13, "schur.scan"], [28, 31, "schur.window"],
                                           [31, 33, "inner"]]
    totals = dict(reduce(events, spans, (0, 100))["idle_gaps"])
    for step, parts in got.items():
        assert sum(parts.values()) * 1e-9 == pytest.approx(totals[f"idle in {step}"])
    assert chip_ab.idle_by_span(events, spans, [], (0, 100)) == {
        "sep.schur": {"sep.schur": 22}, "sep.eigenvalues": {"sep.eigenvalues": 10}}


def test_small_paths_count_chase_steps():
    """Below the small limit the one Francis or QZ solve's chase steps are
    the count, as its round's are on the AED path."""
    A, B, _a, _b = known_spectrum_pencil(24, complex_ratio=0.3, inf_ratio=0.0, seed=2)
    H, T, Q, Z = gep.hessenberg_triangular(A, B, device="cpu")
    st_sep, st_gep = {}, {}
    *_s, info = tschur.schur(H, stats=st_sep)
    *_g, ginfo = gep.schur(H, T, Q, Z, stats=st_gep, device="cpu")
    assert int(info) == 0 and ginfo == 0
    for st in (st_sep, st_gep):
        assert st["path"] == "small" and st["chase_steps"] > 0
