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

Every function but ``select`` takes ``device=None``, which means the
CUDA card (``torch.device("cuda")``): the card is the default, and the
hand-written kernels run there.  Inputs (tensors or array-likes) are
moved with ``.to(device, torch.float64)`` and are not modified.  A run on
the CPU, where each kernel's plain PyTorch version runs, is asked for
with ``device="cpu"``.  Without a CUDA card, a call that leaves the
device to its default raises ``RuntimeError``: nothing falls back to the
CPU.  ``select`` reads S's diagonals to the host wherever S lies.
Selections are host numpy bool arrays (a tensor is accepted too).  The
``stats`` dicts are the port's own: they receive counts for measurement
and change no result.
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
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues, schur_diagonals


def _device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "starneig_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return dev


def _to(x, dev):
    """x (a tensor or an array-like) as a float64 tensor on dev."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(dev, torch.float64)


def hessenberg(A, Q=None, conf: Optional[HessenbergConf] = None,
               device=None):
    """Reduce A to upper Hessenberg form: returns (H, Q), H = Q^T A Q
    (Q accumulates onto the given Q, if any)."""
    dev = _device(device)
    return _hess.hessenberg(_to(A, dev), Q=_to(Q, dev), conf=conf)


def schur(H, Q=None, conf: Optional[SchurConf] = None,
          stats: Optional[dict] = None, device=None):
    """Hessenberg -> real Schur form: returns (S, Q, eig_real, eig_imag,
    info).  ``stats``, if a dict, receives the geometry and round count."""
    dev = _device(device)
    return _schur.schur(_to(H, dev), Q=_to(Q, dev), conf=conf, stats=stats)


def reorder_schur(S, Q, select, conf: Optional[ReorderConf] = None,
                  stats: Optional[dict] = None, device=None):
    """Move the selected eigenvalues to the leading block (sep_sm.h:89-157)
    with the wave-parallel window grid; small problems take the sequential
    window chain inside.

    Returns (S, Q, num_selected, info), info Error.SUCCESS or
    Error.PARTIAL_REORDERING.  ``stats``, if a dict, receives the passes,
    windows, swaps and failed swaps.
    """
    dev = _device(device)
    return _reorder.reorder_schur_parallel(_to(S, dev), _to(Q, dev), select,
                                           conf=conf, stats=stats)


def eigenvectors(S, Q, select, conf: Optional[EigenvectorsConf] = None,
                 device=None):
    """Eigenvectors for the selected eigenvalues (sep_sm.h:229-527).

    Returns (X, info): LAPACK-style real storage (Re/Im column pairs for
    complex conjugate pairs), info Error.SUCCESS or
    Error.CLOSE_EIGENVALUES.
    """
    dev = _device(device)
    return _evec.eigenvectors_schur(_to(S, dev), _to(Q, dev), select,
                                    conf=conf)


def eigenvalues(S, device=None):
    """Eigenvalues of a real Schur form: (real, imag)."""
    return extract_eigenvalues(_to(S, _device(device)))


def select(S, predicate: Callable[[complex], bool]) -> np.ndarray:
    """Selection bitmap from a predicate over the eigenvalues
    (``starneig_SEP_SM_Select``, reference helpers.c:46-159).

    Reads S's three diagonals to the host once and walks the blocks; a
    2x2 complex-pair block is selected atomically.  Returns an (n,) bool
    numpy array.
    """
    d, sub, sup = torch.stack(schur_diagonals(S)).cpu().numpy()
    return select_from_diagonals(d, sub, sup, predicate)


def select_from_diagonals(d, sub, sup, predicate) -> np.ndarray:
    """:func:`select` from S's three diagonals on the host (numpy arrays,
    the off-diagonals' last entry 0), as the DM layer gathers them."""
    n = d.shape[0]
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
           reorder_conf: Optional[ReorderConf] = None, device=None):
    """Full chain: Hessenberg -> Schur [-> select -> reorder_schur]
    (``starneig_SEP_SM_Reduce``, reference common/combined.c:47-90).

    Returns (S, Q, eig_real, eig_imag, num_selected, info).
    """
    dev = _device(device)
    H, Q = hessenberg(A, conf=hessenberg_conf, device=dev)
    S, Q, er, ei, info = schur(H, Q, conf=schur_conf, device=dev)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(S, predicate)
        S, Q, nsel, info = reorder_schur(S, Q, sel, conf=reorder_conf,
                                         device=dev)
        er, ei = eigenvalues(S, device=dev)
    return S, Q, er, ei, nsel, info
