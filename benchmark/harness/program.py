"""The system under test: each step of a cell's chain as a call of the
port's public entry points (``starneig_tpu_torch.api.sep`` and
``api.gep``).

A step takes the problem's state (a dict of tensors and ints) and returns
the entries it replaces.  The keys are those ``reference/judge.py`` reads:
``H``, ``S``, ``T``, ``Q``, ``Z``, ``eig_real``, ``eig_imag``, ``eig_beta``,
``info``, ``sel``, ``m``, ``reorder_info``, ``X``, ``eigenvectors_info``.
A step that moves the eigenvalues (a reordering) drops the stale ones.
``stats`` receives the program's own counters for the step.
"""

from __future__ import annotations

import numpy as np


def finite_right_half(alpha, beta) -> bool:
    return beta != 0 and (alpha / beta).real > 0


PREDICATES = {"finite_right_half": finite_right_half}
STALE = ("eig_real", "eig_imag", "eig_beta")


def _api():
    from starneig_tpu_torch.api import gep, sep
    return sep, gep


def sep_hessenberg(st, dev, pred, stats):
    sep, _ = _api()
    H, Q = sep.hessenberg(st["A"], device=dev)
    return {"H": H, "Q": Q}


def sep_schur(st, dev, pred, stats):
    sep, _ = _api()
    S, Q, er, ei, info = sep.schur(st.pop("H"), st["Q"], stats=stats, device=dev)
    return {"S": S, "Q": Q, "eig_real": er, "eig_imag": ei, "info": int(info)}


def sep_eigenvalues(st, dev, pred, stats):
    sep, _ = _api()
    er, ei = sep.eigenvalues(st["S"], device=dev)
    return {"eig_real": er, "eig_imag": ei}


def gep_hessenberg_triangular(st, dev, pred, stats):
    _, gep = _api()
    H, T, Q, Z = gep.hessenberg_triangular(st["A"], st["B"], device=dev)
    return {"H": H, "T": T, "Q": Q, "Z": Z}


def gep_schur(st, dev, pred, stats):
    _, gep = _api()
    S, T, Q, Z, ar, ai, bt, info = gep.schur(st.pop("H"), st["T"], st["Q"], st["Z"],
                                             stats=stats, device=dev)
    return {"S": S, "T": T, "Q": Q, "Z": Z, "eig_real": ar, "eig_imag": ai,
            "eig_beta": bt, "info": int(info)}


def gep_eigenvalues(st, dev, pred, stats):
    _, gep = _api()
    ar, ai, bt = gep.eigenvalues(st["S"], st["T"], device=dev)
    return {"eig_real": ar, "eig_imag": ai, "eig_beta": bt}


def gep_select(st, dev, pred, stats):
    _, gep = _api()
    return {"sel": gep.select(st["S"], st["T"], PREDICATES[pred])}


def gep_reorder_schur(st, dev, pred, stats):
    _, gep = _api()
    S, T, Q, Z, m, info = gep.reorder_schur(st["S"], st["T"], st["Q"], st["Z"], st["sel"],
                                            stats=stats, device=dev)
    for k in STALE:
        st.pop(k, None)
    return {"S": S, "T": T, "Q": Q, "Z": Z, "m": int(m), "reorder_info": int(info)}


def gep_eigenvectors(st, dev, pred, stats):
    _, gep = _api()
    n = st["S"].shape[0]
    X, info = gep.eigenvectors(st["S"], st["T"], st["Q"], st["Z"], np.arange(n) < st["m"],
                               device=dev)
    return {"X": X, "eigenvectors_info": int(info)}


STEPS = {
    "sep.hessenberg": sep_hessenberg,
    "sep.schur": sep_schur,
    "sep.eigenvalues": sep_eigenvalues,
    "gep.hessenberg_triangular": gep_hessenberg_triangular,
    "gep.schur": gep_schur,
    "gep.eigenvalues": gep_eigenvalues,
    "gep.select": gep_select,
    "gep.reorder_schur": gep_reorder_schur,
    "gep.eigenvectors": gep_eigenvectors,
}


def launches() -> int:
    """The program's kernel launches so far (``kernels.LAUNCHES``)."""
    from starneig_tpu_torch import kernels
    return sum(kernels.LAUNCHES.values())


def build_kernels():
    """Build (first run in a checkout) or load the program's kernels."""
    from starneig_tpu_torch import kernels
    kernels.lib()
