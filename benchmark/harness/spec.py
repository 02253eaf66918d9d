"""Finding a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics.
A cell ``<name>`` is ``workloads/<name>.json``; it names its configuration
``configs/<config>.json``.  A metric ``<name>`` is read by
``metrics/<name>.py``.  Adding a cell, a configuration or a metric is
adding files: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(Path(root) / "BENCHMARK.json")


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    cell = _load(Path(bench_dir) / "workloads" / f"{name}.json")
    cell["name"] = name
    return cell


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    conf = _load(Path(bench_dir) / "configs" / f"{name}.json")
    conf["name"] = name
    return conf


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of this cell reports: the end-to-end ones
    (``trace`` false) or the per-layer ones, each kept where it has no
    ``workloads`` key or lists the cell."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def chips(bench: dict, cell: str) -> int:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return int(w["chips"])
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
