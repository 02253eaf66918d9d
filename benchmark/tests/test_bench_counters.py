"""The readers of the program's chase-step counters (`schur_chase_steps`,
`qz_chase_steps`) on hand-built runs, and their entries in BENCHMARK.json."""

import pytest

from harness import spec
from harness.cell import Run


def _run(stats, problems):
    run = Run()
    run.durations = [1.0] * problems
    run.stats = stats
    return run


@pytest.mark.parametrize("name,step", [("schur_chase_steps", "sep.schur"),
                                       ("qz_chase_steps", "gep.schur")])
def test_chase_step_readers(name, step):
    read = spec.reader(name)
    run = _run({step: [{"chase_steps": 400}, {"chase_steps": 600}],
                "gep.hessenberg_triangular": [{}, {}]}, 2)
    assert read(run) == 500
    # a program that does not count them (the parent of the counters): no reading
    assert read(_run({step: [{"rounds": 3}, {"rounds": 4}]}, 2)) is None
    assert read(_run({}, 2)) is None


def test_chase_step_entries():
    bench = spec.benchmark()
    cells = {"schur_chase_steps": ["sep4000.eigvals"],
             "qz_chase_steps": ["gep2000.chain"]}
    for m in bench["per_layer"]:
        if m["name"] in cells:
            assert m["workloads"] == cells.pop(m["name"])
            assert (m["source"], m["moves"], m["better"]) == ("program_counter", "solve_ms",
                                                              "lower")
    assert not cells
