"""SEP single-process interface of the PyTorch port.

Counterpart of ``starneig_tpu/api/sep.py`` for the main path:

  starneig_tpu.api.sep     here
  -----------------------  -----------------------
  hessenberg               hessenberg
  schur                    schur
  eigenvalues              eigenvalues

Functions take torch tensors and run on their device; inputs are not
modified.  ``reorder_schur``, ``eigenvectors``, ``select`` and ``reduce``
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

from starneig_tpu_torch.config import HessenbergConf, SchurConf
from starneig_tpu_torch.ops import hessenberg as _hess
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


def eigenvalues(S):
    """Eigenvalues of a real Schur form: (real, imag)."""
    return extract_eigenvalues(S)
