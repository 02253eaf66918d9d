"""The control: the plain reference put in the program's place, in the
precision below the configuration's (float32 for float64), at the cell's
own size, judged as a run judges the program.  Its numbers are the upper
readings the limits of ``configs/<name>.json`` are set below (PERF.md).

    python3 benchmark/reference/control.py --workloads CELL[,CELL...] \
        --seeds S1,S2,S3 [--dtype float32|float64] [--device cuda|cpu] [--n N]

For each seed it makes the input of that seed's first problem, runs the
reference chain on the host (a chain that shares a prefix with another
runs the prefix once) and prints one JSON line a cell and seed with the
judge's numbers and the limits they fail.  ``--dtype float64`` runs the
reference itself, which has to pass.  ``--n`` overrides the configuration's
size (the CPU test's small run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import spec  # noqa: E402
from harness.program import PREDICATES  # noqa: E402
from reference import generators, judge, solvers  # noqa: E402


def control(cells, seeds, dtype, device, n=None):
    """Yield one record a (cell, seed)."""
    for seed in seeds:
        by_conf = {}
        for name in cells:
            cell = spec.workload(name)
            by_conf.setdefault(cell["config"], []).append(cell)
        for conf_name, group in by_conf.items():
            conf = spec.config(conf_name)
            if n is not None:
                conf["n"] = n
            inputs = generators.make_inputs(conf, generators.problem_seed(seed, 0), device)
            done = {(): solvers.host_state(inputs, dtype)}
            for cell in group:
                t0 = time.perf_counter()
                chain = tuple(cell["chain"])
                for i in range(1, len(chain) + 1):
                    if chain[:i] not in done:
                        st = dict(done[chain[:i - 1]])
                        solvers.run_step(chain[i - 1], st, PREDICATES.get(cell["select"]), dtype)
                        done[chain[:i]] = st
                out = solvers.to_device(done[chain], device)
                problem = "gep" if chain[0].startswith("gep") else "sep"
                nums = judge.judge(problem, inputs, out, cell["select"])
                yield {"cell": cell["name"], "seed": seed, "n": conf["n"],
                       "dtype": np.dtype(dtype).name, "numbers": nums,
                       "fails": judge.failures(nums, conf["limits"]),
                       "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    for rec in control(a.workloads.split(","), [int(s) for s in a.seeds.split(",")],
                       np.dtype(a.dtype).type, dev, a.n):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
