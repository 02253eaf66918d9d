"""SEP single-process interface of the PyTorch port.

Counterpart of ``starneig_tpu/api/sep.py`` (reference sep_sm.h:89-527):

  starneig_tpu.api.sep     here
  -----------------------  -----------------------
  hessenberg               hessenberg
  schur                    schur
  reorder_schur            reorder_schur
  eigenvectors             eigenvectors
  eigenvalues              eigenvalues
  select                   select
  reduce                   reduce

Functions take torch tensors and run on their device; inputs are not
modified.  Selections are host numpy bool arrays (a tensor is accepted
too).  The ``stats`` dicts are the port's own: they receive counts for
measurement and change no result.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from starneig_tpu_torch.config import (
    EigenvectorsConf,
    HessenbergConf,
    ReorderConf,
    SchurConf,
)
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import eigenvectors as _evec
from starneig_tpu_torch.ops import hessenberg as _hess
from starneig_tpu_torch.ops import reorder as _reorder
from starneig_tpu_torch.ops import schur as _schur
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues


def hessenberg(A, Q=None, conf: Optional[HessenbergConf] = None):
    """Reduce A to upper Hessenberg form: returns (H, Q), H = Q^T A Q
    (Q accumulates onto the given Q, if any)."""
    return _hess.hessenberg(A, Q=Q, conf=conf)


def schur(H, Q=None, conf: Optional[SchurConf] = None,
          stats: Optional[dict] = None):
    """Hessenberg -> real Schur form: returns (S, Q, eig_real, eig_imag,
    info).  ``stats``, if a dict, receives the geometry and round count."""
    return _schur.schur(H, Q=Q, conf=conf, stats=stats)


def reorder_schur(S, Q, select, conf: Optional[ReorderConf] = None,
                  stats: Optional[dict] = None):
    """Move the selected eigenvalues to the leading block (sep_sm.h:89-157)
    with the wave-parallel window grid; small problems take the sequential
    window chain inside.

    Returns (S, Q, num_selected, info), info Error.SUCCESS or
    Error.PARTIAL_REORDERING.  ``stats``, if a dict, receives the passes,
    windows, swaps and failed swaps.
    """
    return _reorder.reorder_schur_parallel(S, Q, select, conf=conf,
                                           stats=stats)


def eigenvectors(S, Q, select, conf: Optional[EigenvectorsConf] = None):
    """Eigenvectors for the selected eigenvalues (sep_sm.h:229-527).

    Returns (X, info): LAPACK-style real storage (Re/Im column pairs for
    complex conjugate pairs), info Error.SUCCESS or
    Error.CLOSE_EIGENVALUES.
    """
    return _evec.eigenvectors_schur(S, Q, select, conf=conf)


def eigenvalues(S):
    """Eigenvalues of a real Schur form: (real, imag)."""
    return extract_eigenvalues(S)


def select(S, predicate: Callable[[complex], bool]) -> np.ndarray:
    """Selection bitmap from a predicate over the eigenvalues
    (``starneig_SEP_SM_Select``, reference helpers.c:46-159).

    Reads S's three diagonals to the host once and walks the blocks; a
    2x2 complex-pair block is selected atomically.  Returns an (n,) bool
    numpy array.
    """
    n = S.shape[0]
    z = S.new_zeros(1)
    d, sub, sup = torch.stack([
        torch.diagonal(S), torch.cat([torch.diagonal(S, -1), z]),
        torch.cat([torch.diagonal(S, 1), z])]).cpu().numpy()
    sel = np.zeros(n, bool)
    i = 0
    while i < n:
        if sub[i] != 0:
            lam = 0.5 * (d[i] + d[i + 1]) + 1j * np.sqrt(np.abs(sup[i]) * np.abs(sub[i]))
            v = bool(predicate(lam))
            sel[i] = sel[i + 1] = v
            i += 2
        else:
            sel[i] = bool(predicate(complex(d[i])))
            i += 1
    return sel


def reduce(A, predicate: Optional[Callable[[complex], bool]] = None,
           hessenberg_conf: Optional[HessenbergConf] = None,
           schur_conf: Optional[SchurConf] = None,
           reorder_conf: Optional[ReorderConf] = None):
    """Full chain: Hessenberg -> Schur [-> select -> reorder_schur]
    (``starneig_SEP_SM_Reduce``, reference common/combined.c:47-90).

    Returns (S, Q, eig_real, eig_imag, num_selected, info).
    """
    H, Q = hessenberg(A, conf=hessenberg_conf)
    S, Q, er, ei, info = schur(H, Q, conf=schur_conf)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(S, predicate)
        S, Q, nsel, info = reorder_schur(S, Q, sel, conf=reorder_conf)
        er, ei = eigenvalues(S)
    return S, Q, er, ei, nsel, info
