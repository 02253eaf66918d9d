"""Every configuration, cell and metric of BENCHMARK.json loads by name, and
a cell added as files only is found."""

import json
import textwrap

import pytest

from bench_helpers import ROOT, copy_bench, run_small
from harness import program, spec, work
from harness.cell import Run
from reference import generators

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


@pytest.mark.parametrize("entry", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_loads(entry):
    conf = spec.config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert sorted(conf["reduced"]) == sorted(entry["reduced"])
    assert conf["generator"] in generators.GENERATORS
    assert conf["precision"] == "float64"
    for k in ("residual_u", "orthogonality_u", "structure", "info"):
        assert k in conf["limits"]
    assert set(conf["limits"]) == set(conf["limits_from"])


@pytest.mark.parametrize("entry", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_workload_loads(entry):
    cell = spec.workload(entry["name"])
    assert (cell["config"], cell["traffic"], cell["why"]) == (
        entry["config"], entry["traffic"], entry["why"])
    assert spec.config(cell["config"])
    for step in cell["chain"]:
        assert step in program.STEPS and step in work.WORK
    assert cell["select"] in (None, *program.PREDICATES)


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_loads(entry):
    assert spec.reader(entry["name"])(Run()) is None      # nothing to read


def test_cell_metrics_follow_workloads():
    names = [m["name"] for m in spec.cell_metrics(BENCHMARK, "sep4000.hessenberg", False)]
    assert names == ["solve_ms", "solve_p95_ms", "backward_error_u", "setup_s"]
    names = [m["name"] for m in spec.cell_metrics(BENCHMARK, "gep2000.eigvals", True)]
    assert names == ["ht_ms", "qz_ms", "qz_rounds", "launches_per_solve", "roofline_pct",
                     "device_idle_pct"]


def test_added_cell_is_found(tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    (and entries of BENCHMARK.json) run with no other change."""
    root = copy_bench(tmp_path)
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "gep_known_n2000.json").read_text())
    conf["n"] = 44
    (b / "configs" / "gep_known_n44.json").write_text(json.dumps(conf))
    (b / "workloads" / "gep44.subspace.json").write_text(json.dumps({
        "config": "gep_known_n44", "traffic": "subspace",
        "chain": ["gep.hessenberg_triangular", "gep.schur", "gep.select",
                  "gep.reorder_schur"],
        "select": "finite_right_half", "why": "a deflating subspace, no eigenvectors"}))
    (b / "metrics" / "reorder_only_ms.py").write_text(textwrap.dedent('''\
        from harness.readers import span_ms


        def read(run):
            return span_ms(run, "gep.reorder_schur")
        '''))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gep_known_n44", "source": "test", "reduced": ["n"],
                             "file": "benchmark/configs/gep_known_n44.json", "why": "test"})
    bench["workloads"].append({"name": "gep44.subspace", "config": "gep_known_n44",
                               "traffic": "subspace", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "reorder_only_ms", "unit": "ms/solve",
                               "better": "lower", "source": "host_clock", "layer": "ops.reorder",
                               "moves": "solve_ms", "workloads": ["gep44.subspace"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_small(root, "gep44.subspace", trace=True)
    assert rc == 0, err
    assert res["correct"], err
    assert res["metrics"]["reorder_only_ms"]["value"] > 0
    assert "misplaced" in res["checks"] and "eigenvector_u" not in res["checks"]

