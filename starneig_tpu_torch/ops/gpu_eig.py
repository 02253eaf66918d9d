"""E1 and E2: the SEP and GEP eigenvector backsolves, one launch each.

Kernel E1 (``kernels/csrc/eig_backsolve.cu``) runs the JAX package's row
loop ``starneig_tpu/ops/eigenvectors.py:_backsolve_all`` (a ``fori_loop``
vmapped over the selected eigenvalues) on the card in LAPACK dtrevc3's
blocked form: a block per group of eigenvalues sorted by their block's
position, a warp each, rows in blocks of 64.
:func:`backsolve` is its wrapper, for CUDA tensors only;
``ops/eigenvectors.py:_backsolve_all`` calls it on the card and its plain
twin ``_backsolve_rows`` on the CPU.  Both take the same arguments.

Both take, for a column shard of the DM eigenvectors
(``parallel/dm_eig.py``), the far sums of the rows past the block solved
(``f0r``, ``f0i``) and give each vector's product of scalings
(``scale``); their twins take the same.

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


def _optional(name, m, n, f0r, f0i, scale):
    """The data pointers (0 for None) of the shard arguments, checked."""
    if (f0r is None) != (f0i is None):
        raise ValueError(f"{name}: f0r and f0i come together")
    for t, shape in ((f0r, (m, n)), (f0i, (m, n)), (scale, (m,))):
        if t is not None:
            kernels.require_cuda_f64(name, t)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: a shard argument of shape {tuple(t.shape)}, "
                                 f"not {shape}")
    return [0 if t is None else t.data_ptr() for t in (f0r, f0i, scale)]


def backsolve(S, lam_r, lam_i, pos, is_pair, kind, smin, omega, smlnum, xr, xi,
              f0r=None, f0i=None, scale=None):
    """Backward substitution for m eigenvalues, in place on (xr, xi).

    Args:
      S: (n, n) real Schur form, contiguous float64 on the card: the
        whole form, or the diagonal block of the rows a column shard
        solves (``parallel/dm_eig.py``).
      lam_r, lam_i, smin: (m,) float64 on S's device.
      pos, is_pair: (m,) host arrays: block starts and pair flags; pos = n
        marks a block past the rows solved here (every row is solved).
      kind: (n,) host ints (``eigenvectors._row_kinds``): 0 a 1x1 row, 1
        the first row of a 2x2 block, 2 its second row.
      omega, smlnum: the growth bound and the guard (floats or 0-dim).
      xr, xi: (m, n) float64 on S's device, holding the initial entries.
      f0r, f0i: None, or (m, n) float64: each vector's sums over the
        columns past n (rows of S beyond the block), taken with the
        vector's scalings as they happen.
      scale: None, or (m,) float64 that receives each vector's product of
        its scalings.

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
            or pos.min() < 0 or pos.max() > n):
        raise ValueError(f"eig_backsolve: shapes do not match S {tuple(S.shape)}, "
                         f"x {tuple(xr.shape)}, {m} eigenvalues")
    extra = _optional("eig_backsolve", m, n, f0r, f0i, scale)
    order, pos_d, pair_d, kind_d = _host_arrays(pos, is_pair, kind, dev)
    lib = kernels.lib()
    kernels.LAUNCHES["eig_backsolve"] += 1
    kernels.check(lib.eig_backsolve(
        S.data_ptr(), n, lam_r.data_ptr(), lam_i.data_ptr(), smin.data_ptr(),
        pos_d.data_ptr(), pair_d.data_ptr(), kind_d.data_ptr(), order.data_ptr(), m,
        float(omega), float(smlnum), xr.data_ptr(), xi.data_ptr(), close.data_ptr(),
        *extra, kernels.stream_ptr(S)), "eig_backsolve")
    return close.bool()


def backsolve_gep(S, T, ar, ai, bt, pos, is_pair, kind, smin, omega, smlnum, xr, xi,
                  f0r=None, f0i=None, scale=None):
    """Backward substitution for (beta S - alpha T) x = 0 for m
    eigenvalues, in place on (xr, xi).

    Args:
      S, T: (n, n) generalized Schur form, contiguous float64 on the card
        (or the diagonal blocks of the rows a column shard solves).
      ar, ai, bt, smin: (m,) float64 on S's device: alpha = ar + i ai and
        beta, scaled to magnitude about 1, and the perturbation floor.
      pos, is_pair: (m,) host arrays: block starts and pair flags; pos = n
        marks a block past the rows solved here.
      kind: (n,) host ints (``eigenvectors._row_kinds``): 0 a 1x1 row, 1
        the first row of a 2x2 block, 2 its second row.
      omega, smlnum: the growth bound and the guard (floats or 0-dim).
      xr, xi: (m, n) float64 on S's device, holding the start entries.
      f0r, f0i, scale: as :func:`backsolve`'s, the sums those of
        (beta S - alpha T) x.

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
            or pos.min() < 0 or pos.max() > n):
        raise ValueError(f"eig_backsolve_gep: shapes do not match S {tuple(S.shape)}, "
                         f"T {tuple(T.shape)}, x {tuple(xr.shape)}, {m} eigenvalues")
    extra = _optional("eig_backsolve_gep", m, n, f0r, f0i, scale)
    order, pos_d, pair_d, kind_d = _host_arrays(pos, is_pair, kind, dev)
    lib = kernels.lib()
    kernels.LAUNCHES["eig_backsolve_gep"] += 1
    kernels.check(lib.eig_backsolve_gep(
        S.data_ptr(), T.data_ptr(), n, ar.data_ptr(), ai.data_ptr(), bt.data_ptr(),
        smin.data_ptr(), pos_d.data_ptr(), pair_d.data_ptr(), kind_d.data_ptr(),
        order.data_ptr(), m, float(omega), float(smlnum), xr.data_ptr(), xi.data_ptr(),
        close.data_ptr(), *extra, kernels.stream_ptr(S)), "eig_backsolve_gep")
    return close.bool()
