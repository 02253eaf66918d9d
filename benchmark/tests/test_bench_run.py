"""Whole runs on the CPU at tiny sizes: each cell comes out correct with its
metrics; the measuring path refuses to run without a card; nothing of JAX
or the JAX package is loaded; the timed path broken underneath makes
``correct`` false."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from bench_helpers import BENCH, ROOT, run_small
from harness import program, spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
DEVICE_METRICS = {"launches_per_solve", "roofline_pct", "device_idle_pct"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_cpu(small_bench, cell, trace):
    rc, res, err = run_small(small_bench, cell, trace=trace)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, err
    want = {m["name"] for m in spec.cell_metrics(BENCHMARK, cell, trace)}
    # the CPU launches no kernel and records no device timeline
    assert set(res["metrics"]) == want - DEVICE_METRICS
    assert list(res)[-1] == "checks"
    assert err.rstrip().splitlines()[-1].startswith("check ")
    assert res["device"]["count"] == 1


def test_refuses_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "sep4000.hessenberg", "--seed", str(2 ** 35 + 1), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_loads_no_jax(tmp_path):
    """In a fresh process, after runs of every cell: no module whose
    top-level name is jax, jaxlib, flax or starneig_tpu (compared whole:
    starneig_tpu_torch is the program)."""
    code = textwrap.dedent(f"""
        import json, sys
        from pathlib import Path
        sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT)!r}]
        from bench_helpers import copy_bench, run_small
        root = copy_bench(Path({str(tmp_path)!r}))
        ok = [run_small(root, c, seconds=0.05)[1]["correct"] for c in {CELLS!r}]
        import reference.control
        tops = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"ok": ok, "tops": tops}}))
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert all(out["ok"])
    assert "starneig_tpu_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "starneig_tpu"} & set(out["tops"])


def _unchanged_schur(st, dev, pred, stats):
    H = st["H"]
    return {"S": H, "Q": st["Q"], "eig_real": torch.diagonal(H).clone(),
            "eig_imag": torch.zeros_like(torch.diagonal(H)), "info": 0}


def _unchanged_qz(st, dev, pred, stats):
    H = st["H"]
    z = torch.zeros_like(torch.diagonal(H))
    return {"S": H, "T": st["T"], "Q": st["Q"], "Z": st["Z"], "eig_real": torch.diagonal(H),
            "eig_imag": z, "eig_beta": torch.diagonal(st["T"]), "info": 0}


def _unchanged_reorder(st, dev, pred, stats):
    return {"S": st["S"], "T": st["T"], "Q": st["Q"], "Z": st["Z"],
            "m": int(st["sel"].sum()), "reorder_info": 0}


def _unchanged_hessenberg(st, dev, pred, stats):
    A = st["A"]
    return {"H": A.clone(), "Q": torch.eye(A.shape[0], dtype=A.dtype)}


def _select_infinite(st, dev, pred, stats):
    """The selection with the rule's beta != 0 clause left out: an infinite
    eigenvalue with Re(alpha) > 0 is taken into the subspace."""
    from starneig_tpu_torch.api import gep
    rule = program.PREDICATES[pred]
    return {"sel": gep.select(st["S"], st["T"],
                              lambda a, b: a.real > 0 if b == 0 else rule(a, b))}


def _altered(step, key, change):
    orig = program.STEPS[step]

    def broken(st, dev, pred, stats):
        out = orig(st, dev, pred, stats)
        change(out[key])
        return out
    return broken


def _bump(M):
    M[0, -1] += 1e-6 * M.abs().max()


def _bump_first(v):
    v[0] += 1e-3 * (1 + v.abs().max())


FAULTS = {
    "schur_unchanged": ("sep4000.eigvals", "sep.schur", lambda: _unchanged_schur),
    "eigenvalue_altered": ("sep4000.eigvals", "sep.eigenvalues",
                           lambda: _altered("sep.eigenvalues", "eig_real", _bump_first)),
    "hessenberg_unchanged": ("sep4000.hessenberg", "sep.hessenberg",
                             lambda: _unchanged_hessenberg),
    "hessenberg_altered": ("sep4000.hessenberg", "sep.hessenberg",
                           lambda: _altered("sep.hessenberg", "H", _bump)),
    "qz_unchanged": ("gep2000.eigvals", "gep.schur", lambda: _unchanged_qz),
    "qz_altered": ("gep2000.eigvals", "gep.schur",
                   lambda: _altered("gep.schur", "S", _bump)),
    "reorder_unchanged": ("gep2000.chain", "gep.reorder_schur", lambda: _unchanged_reorder),
    "select_takes_infinite": ("gep2000.chain", "gep.select", lambda: _select_infinite),
    "eigenvector_altered": ("gep2000.chain", "gep.eigenvectors",
                            lambda: _altered("gep.eigenvectors", "X", _bump)),
}


# a seed whose first problem has an infinite eigenvalue with Re(alpha) > 0
FAULT_SEEDS = {"select_takes_infinite": 2 ** 33 + 104}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(small_bench, monkeypatch, fault):
    """Each fault a cell can have, planted under the timed path: a step
    that returns its state unchanged, an answer altered where it is made.
    (No cell has a batch to halve or an exchange between chips to drop.)"""
    cell, step, make = FAULTS[fault]
    monkeypatch.setitem(program.STEPS, step, make())
    rc, res, err = run_small(small_bench, cell, seed=FAULT_SEEDS.get(fault, 2 ** 33 + 17))
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] >= 1
    assert any(not c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.bench_card
def test_cell_on_card(card, tmp_path):
    """One short run of the Hessenberg cell through run.py on the card."""
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "sep4000.hessenberg", "--seed", str(2 ** 35 + 3), "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in spec.cell_metrics(
        BENCHMARK, "sep4000.hessenberg", True)}
