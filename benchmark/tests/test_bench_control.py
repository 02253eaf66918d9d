"""The control: the plain reference in float32 in the program's place fails
the judge, the reference in float64 passes it (at a size a test run holds;
PERF.md gives the readings at the cells' own sizes on the card)."""

import json

import numpy as np
import pytest
import torch

from bench_helpers import ROOT
from reference import control

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def readings():
    out = {}
    for dtype in (np.float32, np.float64):
        for rec in control.control(CELLS, [2 ** 33 + 9], dtype, torch.device("cpu"), n=120):
            out[rec["cell"], rec["dtype"]] = rec
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails(readings, cell):
    rec = readings[cell, "float32"]
    assert {"residual_u", "orthogonality_u"} <= set(rec["fails"])
    assert rec["numbers"]["residual_u"] > 1e6


@pytest.mark.parametrize("cell", CELLS)
def test_float64_reference_passes(readings, cell):
    rec = readings[cell, "float64"]
    assert rec["fails"] == [], rec
