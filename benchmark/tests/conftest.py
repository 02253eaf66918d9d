"""CPU tests of the benchmark harness: ``python -m pytest benchmark/tests``.

Tests that need a CUDA card carry the ``bench_card`` marker and skip
without one; the card is looked for inside the ``card`` fixture, never
while a module is imported.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_helpers import copy_bench  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "bench_card: runs the benchmark on a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def small_bench(tmp_path):
    return copy_bench(tmp_path)
