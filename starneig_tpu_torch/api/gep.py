"""GEP single-process interface of the PyTorch port.

Counterpart of ``starneig_tpu/api/gep.py`` (reference gep_sm.h:106-629):

  starneig_tpu.api.gep     here
  -----------------------  -----------------------
  hessenberg_triangular    hessenberg_triangular
  schur                    schur
  reorder_schur            reorder_schur
  eigenvectors             eigenvectors
  eigenvalues              eigenvalues
  select                   select
  reduce                   reduce

The device rules are ``api/sep.py``'s: ``device=None`` means the CUDA card,
where the hand-written kernels run; without a card such a call raises
``RuntimeError``, and ``device="cpu"`` runs the kernels' plain PyTorch
versions.  Inputs (tensors or array-likes) are moved with
``.to(device, torch.float64)`` and are not modified.  ``select`` reads the
Schur pair's diagonals to the host wherever they lie.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from starneig_tpu_torch.api.sep import _device, _to
from starneig_tpu_torch.config import EigenvectorsConf, ReorderConf, SchurConf
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import eigenvectors as _evec
from starneig_tpu_torch.ops import hess_triangular as _ht
from starneig_tpu_torch.ops import qz as _qz
from starneig_tpu_torch.ops import reorder as _reorder
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues_gen


def hessenberg_triangular(A, B, Q=None, Z=None, device=None):
    """(A, B) -> Hessenberg-triangular (H, T, Q, Z) with H = Q^T A Z and
    T = Q^T B Z (gep_sm.h:106-160); Q and Z accumulate onto the given ones."""
    dev = _device(device)
    return _ht.hessenberg_triangular(_to(A, dev), _to(B, dev), Q=_to(Q, dev),
                                     Z=_to(Z, dev))


def schur(H, T, Q=None, Z=None, conf: Optional[SchurConf] = None,
          stats: Optional[dict] = None, device=None):
    """Hessenberg-triangular -> generalized real Schur form by QZ
    (gep_sm.h:162-235).

    Returns (S, T, Q, Z, alpha_r, alpha_i, beta, info); beta == 0 marks an
    infinite eigenvalue.  Above the small limit the multishift QZ driver
    with AED runs; ``stats``, if a dict, receives its geometry and rounds.
    """
    dev = _device(device)
    H, T = _to(H, dev), _to(T, dev)
    n = H.shape[0]
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    Qm = eye if Q is None else _to(Q, dev)
    Zm = eye if Z is None else _to(Z, dev)
    conf = (conf or SchurConf()).resolve(n)
    if n > conf.small_limit:
        from starneig_tpu_torch.ops.qz_driver import qz_schur
        return qz_schur(H, T, Qm, Zm, conf=conf, stats=stats)
    u = torch.finfo(torch.float64).eps / 2
    th = u * float(torch.linalg.norm(H))
    tt = u * float(torch.linalg.norm(T))
    S, Tt, Qo, Zo, info_i = _qz.small_qz(H, T, Qm, Zm, n, th, tt)
    ar, ai, bt = extract_eigenvalues_gen(S, Tt)
    info = Error.SUCCESS if int(info_i) == 0 else Error.DID_NOT_CONVERGE
    if stats is not None:
        stats.update(path="small", rounds=0)
    return S, Tt, Qo, Zo, ar, ai, bt, info


def reorder_schur(S, T, Q, Z, select, conf: Optional[ReorderConf] = None,
                  stats: Optional[dict] = None, device=None):
    """Move the selected generalized eigenvalues to the leading block
    (gep_sm.h:237-320) with the sequential window chain.

    Returns (S, T, Q, Z, num_selected, info), info Error.SUCCESS or
    Error.PARTIAL_REORDERING.  ``stats``, if a dict, receives the windows,
    swaps and failed swaps.
    """
    dev = _device(device)
    return _reorder.reorder_schur_gep(_to(S, dev), _to(T, dev), _to(Q, dev),
                                      _to(Z, dev), select, conf=conf, stats=stats)


def eigenvectors(S, T, Q, Z, select, conf: Optional[EigenvectorsConf] = None,
                 device=None):
    """Generalized eigenvectors for the selected eigenvalues
    (gep_sm.h:400-629).

    Returns (X, info): X = Z Y in LAPACK-style real storage (Re/Im column
    pairs for complex conjugate pairs; an infinite eigenvalue's column
    solves B x = 0), info Error.SUCCESS or Error.CLOSE_EIGENVALUES.
    """
    dev = _device(device)
    return _evec.eigenvectors_schur_gep(_to(S, dev), _to(T, dev), _to(Q, dev),
                                        _to(Z, dev), select, conf=conf)


def eigenvalues(S, T, device=None):
    """(alpha_r, alpha_i, beta) from a generalized Schur form."""
    dev = _device(device)
    return extract_eigenvalues_gen(_to(S, dev), _to(T, dev))


def select(S, T, predicate: Callable[[complex, float], bool]) -> np.ndarray:
    """Selection bitmap from a predicate over the (alpha, beta) pairs
    (``starneig_GEP_SM_Select``, reference helpers.c:96-159): the predicate
    receives (alpha: complex, beta: float), beta == 0 meaning infinite; a
    2x2 block is selected atomically.  Returns an (n,) bool numpy array."""
    ar, ai, bt = extract_eigenvalues_gen(S, T.to(S.device))
    z = S.new_zeros(1)
    ar, ai, bt, sub = torch.stack([
        ar, ai, bt, torch.cat([torch.diagonal(S, -1), z])]).cpu().numpy()
    n = S.shape[0]
    sel = np.zeros(n, bool)
    i = 0
    while i < n:
        v = bool(predicate(complex(ar[i], ai[i]), float(bt[i])))
        if sub[i] != 0:
            sel[i] = sel[i + 1] = v
            i += 2
        else:
            sel[i] = v
            i += 1
    return sel


def reduce(A, B, predicate: Optional[Callable[[complex, float], bool]] = None,
           reorder_conf: Optional[ReorderConf] = None,
           schur_conf: Optional[SchurConf] = None, device=None):
    """Full GEP chain: HT -> QZ [-> select -> reorder_schur]
    (reference common/combined.c:98-154).

    Returns (S, T, Q, Z, alpha_r, alpha_i, beta, num_selected, info).
    """
    dev = _device(device)
    H, T, Q, Z = hessenberg_triangular(A, B, device=dev)
    S, T, Q, Z, ar, ai, bt, info = schur(H, T, Q, Z, conf=schur_conf, device=dev)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(S, T, predicate)
        S, T, Q, Z, nsel, info = reorder_schur(S, T, Q, Z, sel, conf=reorder_conf,
                                               device=dev)
        ar, ai, bt = eigenvalues(S, T, device=dev)
    return S, T, Q, Z, ar, ai, bt, nsel, info
