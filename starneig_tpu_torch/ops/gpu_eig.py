"""E1 and E2: the SEP and GEP eigenvector backsolves, one launch each.

Kernel E1 (``kernels/csrc/eig_backsolve.cu``) runs the JAX package's row
loop ``starneig_tpu/ops/eigenvectors.py:_backsolve_all`` (a ``fori_loop``
vmapped over the selected eigenvalues) on the card in LAPACK dtrevc3's
blocked form: a block per group of eigenvalues sorted by their block's
position, a warp each, rows in blocks of 64.
:func:`backsolve` is its wrapper, for CUDA tensors only;
``ops/eigenvectors.py:_backsolve_all`` calls it on the card and its plain
twin ``_backsolve_rows`` on the CPU.  Both take the same arguments.

Kernel E2 (``kernels/csrc/eig_backsolve_gep.cu``) does the same for the
pencil's row loop ``_backsolve_all_gep`` on (beta S - alpha T) x = 0, in
E1's blocked form: :func:`backsolve_gep`, called by
``ops/eigenvectors.py:_backsolve_all_gep`` on the card; its plain twin
``_backsolve_rows_gep`` (the GEP row loop) runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from starneig_tpu_torch import kernels


def _host_arrays(pos, is_pair, kind, dev):
    """(order, pos, pair, kind) as int32 tensors on dev: the eigenvalues
    sorted by pos, descending and stable (a block takes 8 consecutive
    ones), the positions, the pair flags and the row kinds."""
    as_i = dict(dtype=torch.int32, device=dev)
    return (torch.as_tensor(np.argsort(-pos, kind="stable"), **as_i),
            torch.as_tensor(pos, **as_i),
            torch.as_tensor(np.asarray(is_pair, bool), **as_i),
            torch.as_tensor(np.asarray(kind), **as_i))


def backsolve(S, lam_r, lam_i, pos, is_pair, kind, smin, omega, smlnum, xr, xi):
    """Backward substitution for m eigenvalues, in place on (xr, xi).

    Args:
      S: (n, n) real Schur form, contiguous float64 on the card.
      lam_r, lam_i, smin: (m,) float64 on S's device.
      pos, is_pair: (m,) host arrays: block starts and pair flags.
      kind: (n,) host ints (``eigenvectors._row_kinds``): 0 a 1x1 row, 1
        the first row of a 2x2 block, 2 its second row.
      omega, smlnum: the growth bound and the guard (floats or 0-dim).
      xr, xi: (m, n) float64 on S's device, holding the initial entries.

    Returns the (m,) bool close-eigenvalues flags; xr, xi hold the
    unnormalized vectors.
    """
    m, n = xr.shape
    dev = S.device
    close = torch.zeros(m, dtype=torch.int32, device=dev)
    if m == 0:
        return close.bool()
    kernels.require_cuda_f64("eig_backsolve", S, lam_r, lam_i, smin, xr, xi)
    pos = np.asarray(pos, np.int64)
    if (tuple(S.shape) != (n, n) or xi.shape != xr.shape or len(kind) != n
            or not all(len(v) == m for v in (lam_r, lam_i, smin, pos, is_pair))
            or pos.min() < 0 or pos.max() >= n):
        raise ValueError(f"eig_backsolve: shapes do not match S {tuple(S.shape)}, "
                         f"x {tuple(xr.shape)}, {m} eigenvalues")
    order, pos_d, pair_d, kind_d = _host_arrays(pos, is_pair, kind, dev)
    lib = kernels.lib()
    kernels.LAUNCHES["eig_backsolve"] += 1
    kernels.check(lib.eig_backsolve(
        S.data_ptr(), n, lam_r.data_ptr(), lam_i.data_ptr(), smin.data_ptr(),
        pos_d.data_ptr(), pair_d.data_ptr(), kind_d.data_ptr(), order.data_ptr(), m,
        float(omega), float(smlnum), xr.data_ptr(), xi.data_ptr(), close.data_ptr(),
        kernels.stream_ptr(S)), "eig_backsolve")
    return close.bool()


def backsolve_gep(S, T, ar, ai, bt, pos, is_pair, kind, smin, omega, smlnum, xr, xi):
    """Backward substitution for (beta S - alpha T) x = 0 for m
    eigenvalues, in place on (xr, xi).

    Args:
      S, T: (n, n) generalized Schur form, contiguous float64 on the card.
      ar, ai, bt, smin: (m,) float64 on S's device: alpha = ar + i ai and
        beta, scaled to magnitude about 1, and the perturbation floor.
      pos, is_pair: (m,) host arrays: block starts and pair flags.
      kind: (n,) host ints (``eigenvectors._row_kinds``): 0 a 1x1 row, 1
        the first row of a 2x2 block, 2 its second row.
      omega, smlnum: the growth bound and the guard (floats or 0-dim).
      xr, xi: (m, n) float64 on S's device, holding the start entries.

    Returns the (m,) bool close-eigenvalues flags; xr, xi hold the
    unnormalized vectors.
    """
    m, n = xr.shape
    dev = S.device
    close = torch.zeros(m, dtype=torch.int32, device=dev)
    if m == 0:
        return close.bool()
    kernels.require_cuda_f64("eig_backsolve_gep", S, T, ar, ai, bt, smin, xr, xi)
    pos = np.asarray(pos, np.int64)
    if (tuple(S.shape) != (n, n) or T.shape != S.shape or xi.shape != xr.shape
            or len(kind) != n
            or not all(len(v) == m for v in (ar, ai, bt, smin, pos, is_pair))
            or pos.min() < 0 or pos.max() >= n):
        raise ValueError(f"eig_backsolve_gep: shapes do not match S {tuple(S.shape)}, "
                         f"T {tuple(T.shape)}, x {tuple(xr.shape)}, {m} eigenvalues")
    order, pos_d, pair_d, kind_d = _host_arrays(pos, is_pair, kind, dev)
    lib = kernels.lib()
    kernels.LAUNCHES["eig_backsolve_gep"] += 1
    kernels.check(lib.eig_backsolve_gep(
        S.data_ptr(), T.data_ptr(), n, ar.data_ptr(), ai.data_ptr(), bt.data_ptr(),
        smin.data_ptr(), pos_d.data_ptr(), pair_d.data_ptr(), kind_d.data_ptr(),
        order.data_ptr(), m, float(omega), float(smlnum), xr.data_ptr(), xi.data_ptr(),
        close.data_ptr(), kernels.stream_ptr(S)), "eig_backsolve_gep")
    return close.bool()
