"""The fp64 operations and HBM bytes each step of a chain has to do: a
lower bound of its work, from the problem's shape and the program's counts
of algorithmic steps (its ``stats``), never from kernel names or launches.

Bytes count each input matrix read once and each output written once.
Operations count what these inputs need of the step's algorithm; where
the program reports no count of a part's steps, that part counts 0, so
every figure is a lower bound (missing counts: the QR and QZ sweeps'
spans (l, ihi) a round, the Francis window solve's chase steps, the AED
swaps, the infinite push's steps).  ``ht_cascade_flops`` is a frozen copy
of ``chip_smoke.py``'s; the eigenvector count follows its ``e2_work``
from the selected blocks' positions alone.

``step_work(step, n, stats, blocks)`` returns (flops, bytes); ``blocks``
is the leading block structure an eigenvector step solved (a list of
(row, size) of the diagonal blocks of the leading m rows).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str):
    """The card's published peaks (``peaks.json``), or None for a card the
    table does not list: no roofline is read on it."""
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def ht_cascade_flops(n: int) -> int:
    """The Givens cascade of an n x n pencil: step (j, i) rotates A's and
    B's row pairs and the column pairs of A, Q, Z (n rows) and B (rows
    0..i), 6 operations an entry pair."""
    return sum(6 * (n - j - 2) * (5 * n - j + 2) for j in range(n - 2))


def _hessenberg(n, stats, blocks):
    # Householder reduction (10/3 n^3) and forming Q (4/3 n^3); A read, H and Q written
    return 14 * n ** 3 / 3, 8 * 3 * n * n


def _aed_rounds(n, log, sides):
    """The AED window transforms applied outside the window: rows right
    of and columns above an active window of size w (n - w of them, wherever
    the window sits) of each of the ``sides`` matrices (S; S and T), and
    the n rows of each orthogonal factor, 2 w^2 operations a row or column."""
    f = 0
    for r in log:
        w = r[0]
        if w > 0 and not (len(r) > 3 and r[3]):
            f += sides * (2 * w * w * (n - w) + 2 * n * w * w)
    return f


def _schur(n, stats, blocks):
    return _aed_rounds(n, stats.get("aed_log", []), 1), 8 * 4 * n * n


def _qz(n, stats, blocks):
    return _aed_rounds(n, stats.get("qz_log", []), 2), 8 * 8 * n * n


def _reorder(n, stats, blocks):
    """Each reordering window's transform applied outside the window to S
    and T and to the n rows of Q and Z (``windows`` of size ``W``)."""
    W = int(stats.get("W", 0))
    f = int(stats.get("windows", 0)) * 2 * (2 * W * W * (n - W) + 2 * n * W * W)
    return f, 8 * 8 * n * n


def _eigenvectors(n, stats, blocks):
    """The backsolve of each selected block (row p, size b): its triangular
    solve over rows < p (two dots, 2 p^2 operations, a real vector; twice
    that for a complex pair), then X = Z Y over Y's nonzero rows, 2 n
    (p + b) a real column; the leading rows of S and T read once, Z's
    leading columns read and X written once."""
    f, m = 0, 0
    for p, b in blocks:
        cols = 2 if b == 2 else 1
        f += 2 * cols * p * p + cols * 2 * n * (p + b)
        m = max(m, p + b)
    return f, 8 * (m * m + 2 * n * m)


def _ht(n, stats, blocks):
    # B's QR (4/3 n^3), Q^T A (2 n^3), forming Q (4/3 n^3), then the cascade
    return 14 * n ** 3 / 3 + ht_cascade_flops(n), 8 * 6 * n * n


def _diagonals(count):
    def f(n, stats, blocks):
        return 0, 8 * count * n
    return f


WORK = {
    "sep.hessenberg": _hessenberg,
    "sep.schur": _schur,
    "sep.eigenvalues": _diagonals(5),
    "gep.hessenberg_triangular": _ht,
    "gep.schur": _qz,
    "gep.eigenvalues": _diagonals(8),
    "gep.select": _diagonals(8),
    "gep.reorder_schur": _reorder,
    "gep.eigenvectors": _eigenvectors,
}


def step_work(step: str, n: int, stats: dict, blocks=()) -> tuple:
    f, b = WORK[step](n, stats, blocks)
    return float(f), float(b)


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: operations over the fp64 peak or
    bytes over HBM's bandwidth, whichever is longer."""
    return max(flops / peak["fp64_flops"], nbytes / peak["hbm_bytes_per_s"])
