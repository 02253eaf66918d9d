"""Helpers the benchmark's CPU tests share."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# sizes at which every cell runs on the CPU in seconds: both take the
# drivers' small paths (one Francis solve, one small QZ)
SMALL_N = {"sep_random_n4000": 40, "gep_known_n2000": 36}


def copy_bench(dest: Path, small: bool = True) -> Path:
    """A copy of BENCHMARK.json and the benchmark folder under dest, its
    configurations cut to SMALL_N; returns dest."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if small:
        for f in (dest / "benchmark" / "configs").glob("*.json"):
            conf = json.loads(f.read_text())
            conf["n"] = SMALL_N.get(f.stem, 32)
            f.write_text(json.dumps(conf))
    return dest


def run_small(root: Path, cell: str, seed: int = 2 ** 33 + 17, seconds: float = 0.3,
              trace: bool = False):
    """One run of ``cell`` on the CPU from the copy at root; returns
    (exit code, result dict or None, standard error)."""
    import io
    import time
    from harness.cell import run_cell
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                  require_card=False, out=out, err=err, root=root,
                  bench_dir=root / "benchmark")
    text = out.getvalue().strip()
    return rc, (json.loads(text.splitlines()[-1]) if text else None), err.getvalue()
