"""One run of one cell: set-up, a measured window of problems in a closed
loop, the judge, one result line.

A problem is one input, made on the device from the run's seed, carried
through the cell's chain of entry calls and ended by
``torch.cuda.synchronize()``.  One caller runs problems back to back and
starts none once ``--seconds`` have passed; the window ends when the last
one finishes.  A seeded reservoir keeps up to ``KEEP`` problems' inputs and
outputs (every problem, where the window holds no more), which the judge
compares once the window has closed, the peak memory has been read and
the rest of the program's state is freed.  The peak memory reported is
the program's: the most any problem had allocated on the card over what
the reservoir held when it started.  With ``--trace 1`` each step
ends in a synchronize inside a span of its own and ``torch.profiler``
records the device over the window.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

import torch

from harness import program, spec, trace, work
from reference import generators, judge

KEEP = 16
FORBIDDEN = ("jax", "jaxlib", "flax", "starneig_tpu")


class Run:
    """What a run measured: the metric readers' input."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.durations = []              # seconds a problem, in order
        self.spans = {}                  # step -> [seconds], traced runs
        self.stats = {}                  # step -> [program stats dict]
        self.work = {}                   # step -> [flops, bytes] summed
        self.launches = None             # kernel launches over the window
        self.trace = None                # trace.reduce(...)
        self.peak = None                 # work.peaks(kind)
        self.memory_peak = 0             # bytes: a problem's peak less the reservoir's
        self.memory_peak_all = 0         # bytes: the same with the reservoir's
        self.checks = {}                 # number -> worst value judged
        self.backward_error_u = None

    @property
    def problems(self) -> int:
        return len(self.durations)


class Reservoir:
    """A uniform sample of up to ``size`` items from a stream of unknown
    length, drawn from the seed (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, random.Random(seed), [], 0

    def offer(self, item):
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def held_bytes(items) -> int:
    """The card's bytes that the kept problems' tensors hold."""
    seen, total = set(), 0
    for inputs, st in items:
        for v in (*inputs.values(), *st.values()):
            if isinstance(v, torch.Tensor) and v.is_cuda:
                s = v.untyped_storage()
                if s.data_ptr() not in seen:
                    seen.add(s.data_ptr())
                    total += s.nbytes()
    return total


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _blocks(S, m: int):
    """(row, size) of the diagonal blocks of S's leading m rows."""
    sub = torch.diagonal(S, -1)[:m].cpu().numpy()
    out, i = [], 0
    while i < m:
        b = 2 if i + 1 < m and sub[i] != 0 else 1
        out.append((i, b))
        i += b
    return out


def solve(cell, conf, inputs, dev, tracing, run, spans):
    """Carry one problem through the chain; returns its state."""
    st = dict(inputs)
    n = int(conf["n"])
    for step in cell["chain"]:
        stats = {}
        if tracing:
            t0, w0 = time.perf_counter(), time.time_ns()
        st.update(program.STEPS[step](st, dev, cell.get("select"), stats))
        if tracing:
            _sync(dev)
            spans.append((step, w0, time.time_ns()))
            run.spans.setdefault(step, []).append(time.perf_counter() - t0)
            blocks = _blocks(st["S"], st["m"]) if step.endswith("eigenvectors") else ()
            f, b = work.step_work(step, n, stats, blocks)
            acc = run.work.setdefault(step, [0.0, 0.0])
            acc[0] += f
            acc[1] += b
        run.stats.setdefault(step, []).append(stats)
    return st


def window(cell, conf, seed, seconds, dev, tracing, run):
    """The measured window; returns (reservoir, spans, window bounds)."""
    keep = Reservoir(KEEP, seed)
    spans = []
    k = 0
    _sync(dev)
    t_start, w_start = time.perf_counter(), time.time_ns()
    while k == 0 or time.perf_counter() - t_start < seconds:
        if dev.type == "cuda":
            held = held_bytes(keep.items)
            torch.cuda.reset_peak_memory_stats(dev)
        inputs = generators.make_inputs(conf, generators.problem_seed(seed, k), dev)
        _sync(dev)
        t0, w0 = time.perf_counter(), time.time_ns()
        st = solve(cell, conf, inputs, dev, tracing, run, spans)
        _sync(dev)
        run.durations.append(time.perf_counter() - t0)
        spans.append(("problem", w0, time.time_ns()))
        keep.offer((inputs, st))
        del inputs, st
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
            run.memory_peak = max(run.memory_peak, peak - held)
            run.memory_peak_all = max(run.memory_peak_all, peak)
        k += 1
    run.window_s = time.perf_counter() - t_start
    return keep, spans, (w_start, time.time_ns())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge_kept(cell, conf, keep, run):
    """Judge every kept problem; returns the number that failed."""
    limits = conf["limits"]
    worst, failed = {}, 0
    problem = "gep" if cell["chain"][0].startswith("gep") else "sep"
    while keep.items:
        inputs, st = keep.items.pop()
        nums = judge.judge(problem, inputs, st, cell.get("select"))
        del inputs, st
        failed += bool(judge.failures(nums, limits))
        for name, v in nums.items():
            worst[name] = v if name not in worst or not v <= worst[name] else worst[name]
        be = judge.backward_error_u(nums)
        run.backward_error_u = be if run.backward_error_u is None else max(
            run.backward_error_u, be)
    run.checks = {name: {"value": v, "limit": limits[name]} for name, v in worst.items()}
    return failed


def metrics(bench, cell_name, run, tracing, bench_dir) -> dict:
    out = {}
    for m in spec.cell_metrics(bench, cell_name, tracing):
        v = spec.reader(m["name"], bench_dir)(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell_name, seed, seconds, tracing, t_start, device=None,
             require_card=True, out=None, err=None, root=spec.ROOT,
             bench_dir=spec.BENCH_DIR) -> int:
    """One run of the cell; prints the result line to ``out`` and returns
    the exit code.  ``device`` and ``require_card`` let a test drive a run
    on the CPU; ``root`` holds BENCHMARK.json, ``bench_dir`` the cells'
    files."""
    out = out or sys.stdout
    err = err or sys.stderr
    bench = spec.benchmark(root)
    cell = spec.workload(cell_name, bench_dir)
    conf = spec.config(cell["config"], bench_dir)
    need = spec.chips(bench, cell_name)
    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < need):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {need} CUDA card(s), found {have}", file=err)
        return 2
    dev = torch.device(device or "cuda")
    run = Run()
    if dev.type == "cuda":
        program.build_kernels()
    warm = generators.make_inputs(conf, generators.problem_seed(seed, -1), dev)
    solve(cell, conf, warm, dev, False, Run(), [])
    del warm
    _sync(dev)
    run.setup_s = time.perf_counter() - t_start
    launches0 = program.launches()
    if tracing and dev.type == "cuda":
        with trace.DeviceTrace() as tr:
            keep, spans, bounds = window(cell, conf, seed, seconds, dev, True, run)
        run.trace = trace.reduce(tr.events, spans, bounds)
    else:
        keep, spans, bounds = window(cell, conf, seed, seconds, dev, tracing, run)
    run.launches = program.launches() - launches0
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=err)
        return 3
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run.peak = work.peaks(kind)
    if tracing and dev.type == "cuda" and run.peak is None:
        print(f"benchmark: harness/peaks.json lists no card {kind!r}: no roofline", file=err)
    failed = judge_kept(cell, conf, keep, run)
    result = {"correct": failed == 0, "attempted": run.problems, "failed": failed,
              "metrics": metrics(bench, cell_name, run, tracing, bench_dir),
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": kind, "count": need, "memory_peak_bytes": run.memory_peak,
                         "memory_peak_with_sample_bytes": run.memory_peak_all,
                         "power": power_limit() if dev.type == "cuda" else "none"}}
    if run.trace is not None:
        result["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": run.trace["device_ops"][:10],
                               "idle_gaps": run.trace["idle_gaps"][:10]}
    result["checks"] = run.checks
    print("problems_ms " + " ".join(f"{d * 1e3:.1f}" for d in run.durations), file=err)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv, t_start) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
