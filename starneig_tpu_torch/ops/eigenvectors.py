"""Eigenvectors from a real Schur form (SEP): overflow-guarded backsolve.

Port of the SEP part of ``starneig_tpu/ops/eigenvectors.py``.  For each
selected eigenvalue, (S - lambda I) y = 0 is solved by backward
substitution over the quasi-triangular S, and X = Q Y is one GEMM.  All
selected eigenvalues run at once: the JAX package vmapped one recurrence
per eigenvalue and ran its row loop on the device.  On the card the row
loop is kernel E1 (:mod:`starneig_tpu_torch.ops.gpu_eig`, one launch); its
plain twin :func:`_backsolve_rows`, which runs on the CPU, batches each
row step over the eigenvalues in a host loop over the n - 1 rows.  Which
rows are 1x1 rows, 2x2 block rows or second rows of a block is decided on
the host from S's subdiagonal, read once; nothing in the loop reads the
device.

Robustness is the JAX package's (reference robust.h:185-381, recast per
column): each column is rescaled before a division whose result would
exceed the growth bound Omega = max / (16 n) / ||S||_max, and a shifted
diagonal (or 2x2 determinant) below smin = max(ulp |lambda|, tiny / eps)
is perturbed to smin and flagged, giving ``CLOSE_EIGENVALUES``.  Vectors
are normalized in two stages (by max |x|, then to unit 2-norm).

Output convention (LAPACK dtrevc style, as ``starneig_SEP_SM_Eigenvectors``,
reference sep_sm.h:229-527): one real column per selected real
eigenvalue; a selected complex pair gives two consecutive columns (real
part, imaginary part) for the eigenvalue with positive imaginary part.

The generalized (pencil) variant, :func:`eigenvectors_schur_gep`, solves
(beta S - alpha T) y = 0 by the same batched recurrence
(:func:`_backsolve_all_gep`, JAX ``eigenvectors.py:274-407``), infinite
eigenvalues (beta = 0) included, and returns X = Z Y.  On the card its
row loop is kernel E2 (``gpu_eig.backsolve_gep``, one launch); its plain
twin :func:`_backsolve_rows_gep` walks only the rows above the lowest
selected block, the rows below it being zero in every vector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.config import EigenvectorsConf
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import gpu_eig


def _cdiv(ar, ai, br, bi, guard: float):
    """Complex division (ar + i ai) / (br + i bi), Smith's algorithm,
    with a denominator below ``guard`` lifted by ``guard``."""
    babs = br.abs() + bi.abs()
    br = br + torch.where(babs < guard, guard, 0.0)
    big = br.abs() >= bi.abs()
    # |br| >= |bi| branch
    r1 = bi / torch.where(br == 0, 1.0, br)
    den1 = br + bi * r1
    den1 = torch.where(den1 == 0, guard, den1)
    xr1 = (ar + ai * r1) / den1
    xi1 = (ai - ar * r1) / den1
    # |bi| > |br| branch
    r2 = br / torch.where(bi == 0, 1.0, bi)
    den2 = bi + br * r2
    den2 = torch.where(den2 == 0, guard, den2)
    xr2 = (ar * r2 + ai) / den2
    xi2 = (ai * r2 - ar) / den2
    return torch.where(big, xr1, xr2), torch.where(big, xi1, xi2)


def _row_kinds(sub):
    """What the backsolve does at each row k of S, from its subdiagonal
    ``sub`` (length n, host): 0 a 1x1 row, 1 the first row of a 2x2 block
    (solved with the second), 2 a block's second row (skipped)."""
    sub = np.asarray(sub)
    kind = np.where(sub != 0, 1, 0).astype(np.int32)
    kind[1:][sub[:-1] != 0] = 2
    return kind


def _rescale(do, num, den, omega, smlnum):
    """fac <= 1 that keeps num * fac / den below omega where ``do``
    (robust.h's protect_update: solve only after the bound admits it)."""
    return torch.where(do & (num > den * omega),
                       den * omega / torch.clamp_min(num, smlnum), 1.0)


def _solve_row(S, k: int, two: bool, lam_r, lam_i, smin, omega, smlnum, do,
               rhs_r, rhs_i, rhs2_r=None, rhs2_i=None):
    """The guarded solve of row k (a 1x1 row), or of rows k, k+1 (``two``:
    a 2x2 block), for every eigenvalue at once, on the right-hand sides
    rhs = -(the row's dot).  Returns (fac, w1r, w1i, w2r, w2i, near): the
    scale the vectors take before the new entries join them (1 where not
    ``do``), x[k] (and x[k+1], None for a 1x1 row), and the close flags."""
    if not two:
        # 1x1 row: x[k] = rhs / (S[k, k] - lambda), protected
        d_r = S[k, k] - lam_r
        d_i = -lam_i
        dabs = d_r.abs() + d_i.abs()
        near = do & (dabs < smin)
        d_r = torch.where(near, smin, d_r)
        d_i = torch.where(near, 0.0, d_i)
        dabs = torch.maximum(dabs, smin)
        # scale the column before a growing division
        fac = _rescale(do, rhs_r.abs() + rhs_i.abs(), dabs, omega, smlnum)
        vr, vi = _cdiv(rhs_r * fac, rhs_i * fac, d_r, d_i, smlnum)
        return fac, vr, vi, None, None, near
    # 2x2 block rows (k, k+1): solve the complex 2x2 system
    n = S.shape[0]
    k1 = min(k + 1, n - 1)
    m11r, m11i = S[k, k] - lam_r, -lam_i
    m22r, m22i = S[k1, k1] - lam_r, -lam_i
    m12, m21 = S[k, k1], S[k1, k]
    # det = m11 m22 - m12 m21 (complex)
    detr = m11r * m22r - m11i * m22i - m12 * m21
    deti = m11r * m22i + m11i * m22r
    detabs = detr.abs() + deti.abs()
    blkscale = m11r.abs() + m11i.abs() + m12.abs() + m21.abs() \
        + m22r.abs() + m22i.abs() + smin
    near2 = do & (detabs < smin * blkscale)
    detr = torch.where(near2, smin * blkscale, detr)
    deti = torch.where(near2, 0.0, deti)
    detabs = torch.maximum(detabs, smin * blkscale)
    # x_k = (m22 r1 - m12 r2) / det ; x_k1 = (m11 r2 - m21 r1) / det
    n1r = m22r * rhs_r - m22i * rhs_i - m12 * rhs2_r
    n1i = m22r * rhs_i + m22i * rhs_r - m12 * rhs2_i
    n2r = m11r * rhs2_r - m11i * rhs2_i - m21 * rhs_r
    n2i = m11r * rhs2_i + m11i * rhs2_r - m21 * rhs_i
    nmax = torch.maximum(n1r.abs() + n1i.abs(), n2r.abs() + n2i.abs())
    fac = _rescale(do, nmax, detabs, omega, smlnum)
    w1r, w1i = _cdiv(n1r * fac, n1i * fac, detr, deti, smlnum)
    w2r, w2i = _cdiv(n2r * fac, n2i * fac, detr, deti, smlnum)
    return fac, w1r, w1i, w2r, w2i, near2


def _backsolve_rows(S, lam_r, lam_i, pos, is_pair, kind, smin, omega, smlnum,
                    xr, xi, f0r=None, f0i=None, scale=None):
    """The row loop of :func:`_backsolve_all`, in place on (xr, xi): the
    plain twin of kernel E1 (``gpu_eig.backsolve``, same arguments: pos =
    n marks a block past the rows solved; f0r, f0i the far sums from the
    columns past n, taken with the vector's scalings; scale receives each
    vector's product of scalings).  Returns the (m,) bool close-eigenvalues
    flags."""
    n = S.shape[0]
    m = len(pos)
    dev = S.device
    pos_t = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
    close = torch.zeros(m, dtype=torch.bool, device=dev)
    sc = torch.ones(m, dtype=S.dtype, device=dev)
    # rows at or below the lowest block start are in no vector's range
    for k in range(min(max(pos, default=0), n) - 1, -1, -1):
        if kind[k] == 2:
            continue        # rows of a 2x2 block are solved at its first row
        in_range = k < pos_t
        two = kind[k] == 1
        dot_r = xr[:, k + 1:] @ S[k, k + 1:]
        dot_i = xi[:, k + 1:] @ S[k, k + 1:]
        if f0r is not None:
            dot_r, dot_i = f0r[:, k] * sc + dot_r, f0i[:, k] * sc + dot_i
        rhs_r, rhs_i = -dot_r, -dot_i
        rhs2_r = rhs2_i = None
        if two:
            k1 = min(k + 1, n - 1)
            dot_r = xr[:, k1 + 1:] @ S[k1, k1 + 1:]
            dot_i = xi[:, k1 + 1:] @ S[k1, k1 + 1:]
            if f0r is not None:
                dot_r, dot_i = f0r[:, k1] * sc + dot_r, f0i[:, k1] * sc + dot_i
            rhs2_r, rhs2_i = -dot_r, -dot_i
        fac, w1r, w1i, w2r, w2i, near = _solve_row(
            S, k, two, lam_r, lam_i, smin, omega, smlnum, in_range, rhs_r, rhs_i,
            rhs2_r, rhs2_i)
        close |= near
        sc *= fac
        xr *= fac[:, None]
        xi *= fac[:, None]
        xr[:, k] = torch.where(in_range, w1r, xr[:, k])
        xi[:, k] = torch.where(in_range, w1i, xi[:, k])
        if two:
            xr[:, k + 1] = torch.where(in_range, w2r, xr[:, k + 1])
            xi[:, k + 1] = torch.where(in_range, w2i, xi[:, k + 1])
    if scale is not None:
        scale.copy_(sc)
    return close


def _backsolve_inputs(S, lam_r, lam_i, pos, is_pair):
    """The row loop's arguments after (S, lam_r, lam_i, pos, is_pair):
    (kind, smin, omega, smlnum, xr, xi), x holding the initial entries at
    each eigenvalue's own block."""
    n = S.shape[0]
    m = len(pos)
    dtype, dev = S.dtype, S.device
    finfo = torch.finfo(dtype)
    ulp = finfo.eps
    smlnum = finfo.tiny / finfo.eps
    snorm = S.abs().max() + smlnum
    # growth bound: keep max|x| below Omega so the row dot n snorm |x|
    # stays far from the overflow threshold
    omega = finfo.max / (16.0 * n) / snorm
    sub = np.concatenate([torch.diagonal(S, -1).cpu().numpy(), [0.0]])
    smin = torch.clamp_min(ulp * (lam_r.abs() + lam_i.abs()), smlnum)

    pos_t = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
    pair_t = torch.as_tensor(np.asarray(is_pair, bool), device=dev)
    cols = torch.arange(m, device=dev)
    xr = S.new_zeros((m, n))
    xi = S.new_zeros((m, n))
    p1 = torch.clamp_max(pos_t + 1, n - 1)
    xr[cols, pos_t] = torch.where(pair_t, S[pos_t, p1], 1.0)
    xi[cols, p1] += torch.where(pair_t, lam_i, 0.0)
    return _row_kinds(sub), smin, omega, smlnum, xr, xi


def _normalize(xr, xi):
    """Safe two-stage normalization of each row of (xr, xi): by max |x|,
    then to unit 2-norm."""
    mx = torch.maximum(xr.abs().amax(1), xi.abs().amax(1))
    mx = torch.where(mx == 0, 1.0, mx)
    xr, xi = xr / mx[:, None], xi / mx[:, None]
    nrm = torch.sqrt((xr * xr).sum(1) + (xi * xi).sum(1))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return xr / nrm[:, None], xi / nrm[:, None]


def _backsolve_all(S, lam_r, lam_i, pos, is_pair):
    """Backward substitution for a batch of m eigenvalues.

    Args:
      S: (n, n) real Schur form.
      lam_r, lam_i: (m,) eigenvalues (lam_i > 0 for pairs), on S's device.
      pos: (m,) host int block starts; is_pair: (m,) host bools.

    Returns:
      (xr, xi, close): (m, n) normalized eigenvector parts and an (m,)
      bool close-eigenvalues flag per column.  The row loop is kernel E1
      (``gpu_eig.backsolve``) for a CUDA S and :func:`_backsolve_rows` for
      a CPU one.
    """
    if S.is_cuda:
        S = S.contiguous()
    args = _backsolve_inputs(S, lam_r, lam_i, pos, is_pair)
    run = gpu_eig.backsolve if S.is_cuda else _backsolve_rows
    close = run(S, lam_r, lam_i, pos, is_pair, *args)
    return (*_normalize(*args[-2:]), close)


def _columns(xr, xi, is_pair):
    """Y (n, ncols): Re of every eigenvalue's vector, Im right after it for
    a pair (one gather of the rows of [xr; xi])."""
    m = len(is_pair)
    rows = [r for j, pr in enumerate(is_pair) for r in ((j, m + j) if pr else (j,))]
    return torch.cat([xr, xi])[torch.as_tensor(rows, device=xr.device)].T


def _backtransform(Q, Y):
    return Q @ Y


def eigenvectors_schur(S, Q, select, conf: Optional[EigenvectorsConf] = None):
    """Eigenvectors of A = Q S Q^T for the selected eigenvalues
    (``starneig_SEP_SM_Eigenvectors``, reference sep_sm.h:229-527).

    Args:
      S: (n, n) real Schur form; Q: (n, n) orthogonal, on S's device.
      select: (n,) bool array or tensor, 2x2 blocks selected atomically.
      conf: accepted for parity with the JAX package (its tile size is not
        used by the batched backsolve).

    Returns:
      (X, info): X (n, ncols) on S's device, one column per selected real
      eigenvalue and (Re, Im) column pairs per selected complex pair; info
      Error.SUCCESS or Error.CLOSE_EIGENVALUES.
    """
    n = S.shape[0]
    entries = _selected_blocks(S, select)
    if not entries:
        return S.new_zeros((n, 0)), Error.SUCCESS

    pos, is_pair, lam_r, lam_i = (list(x) for x in zip(*entries))
    as_t = dict(dtype=S.dtype, device=S.device)
    xr, xi, close = _backsolve_all(S, torch.tensor(lam_r, **as_t),
                                   torch.tensor(lam_i, **as_t), pos, is_pair)
    X = _backtransform(Q, _columns(xr, xi, is_pair))
    # close-eigenvalue warning (reference: interface.c:57-88 + error.h:122)
    info = Error.CLOSE_EIGENVALUES if bool(close.any()) else Error.SUCCESS
    return X, info


def _diagonals(*Ms):
    """The diagonal, subdiagonal and superdiagonal of each M (the last two
    padded with 0), on the host: (len(Ms), 3, n)."""
    z = Ms[0].new_zeros(1)
    return torch.stack([torch.stack([torch.diagonal(M),
                                     torch.cat([torch.diagonal(M, -1), z]),
                                     torch.cat([torch.diagonal(M, 1), z])])
                        for M in Ms]).cpu().numpy()


def _selected_blocks(S, select):
    """The selected diagonal blocks of S, on the host: a list of (pos,
    is_pair, lam_r, lam_i), 2x2 blocks selected atomically (lam_i > 0)."""
    return _selected_blocks_from_diagonals(*_diagonals(S)[0], select)


def _selected_blocks_from_diagonals(diag, sub, sup, select):
    """:func:`_selected_blocks` from S's three diagonals (host arrays, the
    sub- and superdiagonal padded to n), as the DM eigenvectors gather
    them."""
    n = len(diag)
    if torch.is_tensor(select):
        select = select.cpu().numpy()
    select = np.asarray(select, bool)

    # the selected blocks, on the host: (pos, is_pair, lam_r, lam_i)
    entries = []
    i = 0
    while i < n:
        if sub[i] != 0:  # 2x2 block (i, i+1)
            if select[i] or select[i + 1]:
                lr = 0.5 * (diag[i] + diag[i + 1])
                li = np.sqrt(np.abs(sup[i])) * np.sqrt(np.abs(sub[i]))
                entries.append((i, True, lr, li))
            i += 2
        else:
            if select[i]:
                entries.append((i, False, diag[i], 0.0))
            i += 1
    return entries


# ===========================================================================
# generalized (pencil) eigenvectors: (beta S - alpha T) y = 0 (reference
# src/eigenvectors/generalized/, the robust solve of sirobust-geig.c:760)
# ===========================================================================

def _backsolve_inputs_gep(S, T, ar, ai, bt, pos, is_pair):
    """The GEP row loop's arguments after (S, T, ar, ai, bt, pos, is_pair):
    (kind, smin, omega, smlnum, xr, xi), x holding each eigenvalue's start
    entries at its own block."""
    n = S.shape[0]
    m = len(pos)
    dtype, dev = S.dtype, S.device
    finfo = torch.finfo(dtype)
    ulp = finfo.eps
    smlnum = finfo.tiny / finfo.eps
    pnorm = S.abs().max() + T.abs().max() + smlnum
    # growth bound, as the SEP backsolve's over the pencil's norm
    omega = finfo.max / (16.0 * n) / pnorm
    sub = np.concatenate([torch.diagonal(S, -1).cpu().numpy(), [0.0]])
    smin = torch.clamp_min(ulp * (ar.abs() + ai.abs() + bt.abs()), smlnum)

    pos_t = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
    pair_t = torch.as_tensor(np.asarray(is_pair, bool), device=dev)
    cols = torch.arange(m, device=dev)
    xr = S.new_zeros((m, n))
    xi = S.new_zeros((m, n))
    p1 = torch.clamp_max(pos_t + 1, n - 1)
    w0r, w0i, w1r, w1i = _start_gep(ar, ai, bt, S[pos_t, pos_t], S[pos_t, p1],
                                    S[p1, pos_t], S[p1, p1], T[pos_t, pos_t],
                                    T[pos_t, p1], T[p1, p1])
    xr[cols, pos_t] = torch.where(pair_t, w0r, 1.0)
    xi[cols, pos_t] = torch.where(pair_t, w0i, 0.0)
    xr[cols, p1] += torch.where(pair_t, w1r, 0.0)
    xi[cols, p1] += torch.where(pair_t, w1i, 0.0)
    return _row_kinds(sub), smin, omega, smlnum, xr, xi


def _start_gep(ar, ai, bt, s11, s12, s21, s22, t11, t12, t22):
    """A pair's start entries (w0r, w0i, w1r, w1i) at its block (p, p+1):
    the null vector of the singular 2x2 of M = beta S - alpha T there, from
    the row of larger magnitude, out of the block's entries of S and T."""
    m11r = bt * s11 - ar * t11
    m11i = -ai * t11
    m12r = bt * s12 - ar * t12
    m12i = -ai * t12
    m21r = bt * s21
    m21i = 0.0 * m21r
    m22r = bt * s22 - ar * t22
    m22i = -ai * t22
    row0 = m11r * m11r + m11i * m11i + m12r * m12r + m12i * m12i
    row1 = m21r * m21r + m22r * m22r + m22i * m22i
    use0 = row0 >= row1
    return (torch.where(use0, -m12r, m22r), torch.where(use0, -m12i, m22i),
            torch.where(use0, m11r, -m21r), torch.where(use0, m11i, -m21i))


def _solve_row_gep(S, T, k: int, two: bool, ar, ai, bt, smin, omega, smlnum, do,
                   rhs_r, rhs_i, rhs2_r=None, rhs2_i=None):
    """The guarded solve of row k (a 1x1 row), or of rows k, k+1 (``two``:
    a 2x2 block), of M = beta S - alpha T, for every eigenvalue at once, on
    the right-hand sides rhs = -(the row's sum), with the robust.h
    protections (perturb a near-singular diagonal or determinant, scale
    before a growing division).  Returns (fac, w1r, w1i, w2r, w2i, near):
    the scale the vectors take before the new entries join them (1 where
    not ``do``), x[k] (and x[k+1], None for a 1x1 row), and the close
    flags."""

    def mentry(i, j):
        return bt * S[i, j] - ar * T[i, j], -ai * T[i, j]

    if not two:
        # 1x1 row: x[k] = rhs / M[k, k], protected
        d_r, d_i = mentry(k, k)
        dabs = d_r.abs() + d_i.abs()
        near = do & (dabs < smin)
        d_r = torch.where(near, smin, d_r)
        d_i = torch.where(near, 0.0, d_i)
        dabs = torch.maximum(dabs, smin)
        fac = _rescale(do, rhs_r.abs() + rhs_i.abs(), dabs, omega, smlnum)
        vr, vi = _cdiv(rhs_r * fac, rhs_i * fac, d_r, d_i, smlnum)
        return fac, vr, vi, None, None, near
    # 2x2 block rows (k, k+1): the complex 2x2 system (M[k+1, k] stays a
    # formula although T[k+1, k] = 0)
    k1 = k + 1
    a11r, a11i = mentry(k, k)
    a12r, a12i = mentry(k, k1)
    a21r, a21i = mentry(k1, k)
    a22r, a22i = mentry(k1, k1)
    detr = a11r * a22r - a11i * a22i - (a12r * a21r - a12i * a21i)
    deti = a11r * a22i + a11i * a22r - (a12r * a21i + a12i * a21r)
    detabs = detr.abs() + deti.abs()
    blkscale = a11r.abs() + a11i.abs() + a12r.abs() + a12i.abs() \
        + a21r.abs() + a21i.abs() + a22r.abs() + a22i.abs() + smin
    near2 = do & (detabs < smin * blkscale)
    detr = torch.where(near2, smin * blkscale, detr)
    deti = torch.where(near2, 0.0, deti)
    detabs = torch.maximum(detabs, smin * blkscale)
    n1r = a22r * rhs_r - a22i * rhs_i - (a12r * rhs2_r - a12i * rhs2_i)
    n1i = a22r * rhs_i + a22i * rhs_r - (a12r * rhs2_i + a12i * rhs2_r)
    n2r = a11r * rhs2_r - a11i * rhs2_i - (a21r * rhs_r - a21i * rhs_i)
    n2i = a11r * rhs2_i + a11i * rhs2_r - (a21r * rhs_i + a21i * rhs_r)
    nmax = torch.maximum(n1r.abs() + n1i.abs(), n2r.abs() + n2i.abs())
    fac = _rescale(do, nmax, detabs, omega, smlnum)
    w1r, w1i = _cdiv(n1r * fac, n1i * fac, detr, deti, smlnum)
    w2r, w2i = _cdiv(n2r * fac, n2i * fac, detr, deti, smlnum)
    return fac, w1r, w1i, w2r, w2i, near2


def _backsolve_rows_gep(S, T, ar, ai, bt, pos, is_pair, kind, smin, omega, smlnum,
                        xr, xi, f0r=None, f0i=None, scale=None):
    """The row loop of :func:`_backsolve_all_gep`, in place on (xr, xi):
    the plain twin of kernel E2 (``gpu_eig.backsolve_gep``, same
    arguments, the shard arguments as :func:`_backsolve_rows`'s), a host
    loop over the rows above the lowest selected block.  Returns the (m,)
    bool close-eigenvalues flags."""
    n = S.shape[0]
    m = len(pos)
    dev = S.device
    # every vector is zero below its block: work on the leading N rows
    N = min(max(pos) + 2, n)
    S, T = S[:N, :N], T[:N, :N]
    pos_t = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
    close = torch.zeros(m, dtype=torch.bool, device=dev)
    sc = torch.ones(m, dtype=S.dtype, device=dev)
    bt_, ar_, ai_ = bt[:, None], ar[:, None], ai[:, None]

    def rhs(k):
        """-(M[k, k+1:] x[k+1:]) for every eigenvalue, M = beta S - alpha T
        (plus the far sums past n, scaled with the vector)."""
        mkr = bt_ * S[k, k + 1:] - ar_ * T[k, k + 1:]
        mki = -ai_ * T[k, k + 1:]
        xr_, xi_ = xr[:, k + 1:N], xi[:, k + 1:N]
        dot_r = (mkr * xr_).sum(1) - (mki * xi_).sum(1)
        dot_i = (mkr * xi_).sum(1) + (mki * xr_).sum(1)
        if f0r is not None:
            dot_r, dot_i = f0r[:, k] * sc + dot_r, f0i[:, k] * sc + dot_i
        return -dot_r, -dot_i

    # rows at or below the lowest block start are in no vector's range
    for k in range(min(max(pos), n) - 1, -1, -1):
        if kind[k] == 2:
            continue        # rows of a 2x2 block are solved at its first row
        in_range = k < pos_t
        two = kind[k] == 1
        rhs_r, rhs_i = rhs(k)
        rhs2_r, rhs2_i = rhs(k + 1) if two else (None, None)
        fac, w1r, w1i, w2r, w2i, near = _solve_row_gep(
            S, T, k, two, ar, ai, bt, smin, omega, smlnum, in_range, rhs_r, rhs_i,
            rhs2_r, rhs2_i)
        close |= near
        sc *= fac
        xr *= fac[:, None]
        xi *= fac[:, None]
        xr[:, k] = torch.where(in_range, w1r, xr[:, k])
        xi[:, k] = torch.where(in_range, w1i, xi[:, k])
        if two:
            xr[:, k + 1] = torch.where(in_range, w2r, xr[:, k + 1])
            xi[:, k + 1] = torch.where(in_range, w2i, xi[:, k + 1])
    if scale is not None:
        scale.copy_(sc)
    return close


def _backsolve_all_gep(S, T, ar, ai, bt, pos, is_pair):
    """Backward substitution for (beta S - alpha T) x = 0, batched over m
    eigenvalues.

    Args:
      S, T: (n, n) generalized Schur form.
      ar, ai, bt: (m,) alpha = ar + i ai and beta, scaled to magnitude
        about 1 (the pair case carries the alpha of the eigenvalue with
        positive imaginary part), on S's device.
      pos: (m,) host int block starts; is_pair: (m,) host bools.

    Returns:
      (xr, xi, close): (m, n) normalized eigenvector parts and an (m,)
      bool close-eigenvalues flag per column.  The row loop is kernel E2
      (``gpu_eig.backsolve_gep``) for a CUDA S and
      :func:`_backsolve_rows_gep` for a CPU one.
    """
    if S.is_cuda:
        S, T = S.contiguous(), T.contiguous()
    args = _backsolve_inputs_gep(S, T, ar, ai, bt, pos, is_pair)
    run = gpu_eig.backsolve_gep if S.is_cuda else _backsolve_rows_gep
    close = run(S, T, ar, ai, bt, pos, is_pair, *args)
    return (*_normalize(*args[-2:]), close)


def _selected_blocks_gep(S, T, select):
    """The selected diagonal blocks of the pencil (S, T), on the host: a
    list of (pos, is_pair, alpha_r, alpha_i, beta), (alpha, beta) scaled
    to magnitude about 1, 2x2 blocks selected atomically (the pair's alpha
    that of the eigenvalue with positive imaginary part)."""
    return _selected_blocks_gep_from_diagonals(*_diagonals(S, T), select)


def _selected_blocks_gep_from_diagonals(dS, dT, select):
    """:func:`_selected_blocks_gep` from the three diagonals of S and of T
    (host (3, n) arrays, as :func:`_diagonals` gives them)."""
    ds, sub, sup_s = dS
    dt, _sub_t, sup_t = dT
    n = len(ds)
    if torch.is_tensor(select):
        select = select.cpu().numpy()
    select = np.asarray(select, bool)

    entries = []
    i = 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                # complex pair of the 2x2 pencil block: M = adj(T2) S2 has
                # the eigenvalues det_t lambda
                t11, t22 = dt[i], dt[i + 1]
                det_t = t11 * t22
                m11 = ds[i] * t22
                m12 = -ds[i] * sup_t[i] + sup_s[i] * t11
                m21 = sub[i] * t22
                m22 = -sub[i] * sup_t[i] + ds[i + 1] * t11
                tr = 0.5 * (m11 + m22)
                disc = 0.25 * (m11 - m22) ** 2 + m12 * m21
                im = np.sqrt(max(-disc, 0.0))
                # the sign that gives lambda = alpha / beta a positive
                # imaginary part (the Re/Im column-pair convention)
                im_s = im if det_t >= 0 else -im
                entries.append((i, True, tr, im_s, det_t))
            i += 2
        else:
            if select[i]:
                entries.append((i, False, ds[i], 0.0, dt[i]))
            i += 1
    # (alpha, beta) scaled to magnitude about 1
    out = []
    for p, pr, r, im, b in entries:
        c = max(abs(r) + abs(im), abs(b), 1e-300)
        out.append((p, pr, r / c, im / c, b / c))
    return out


def eigenvectors_schur_gep(S, T, Q, Z, select,
                           conf: Optional[EigenvectorsConf] = None):
    """Right eigenvectors of the pencil (A, B) = (Q S Z^T, Q T Z^T) for the
    selected eigenvalues (``starneig_GEP_SM_Eigenvectors``, reference
    gep_sm.h:400-629).

    Args:
      S, T: (n, n) generalized Schur form; Q, Z: (n, n) orthogonal, on S's
        device (Q is not used: X = Z Y).
      select: (n,) bool array or tensor, 2x2 blocks selected atomically.
      conf: accepted for parity with the JAX package.

    Returns:
      (X, info): X (n, ncols) on S's device in LAPACK-style real storage,
      an infinite eigenvalue's column solving T x = 0 on its leading block;
      info Error.SUCCESS or Error.CLOSE_EIGENVALUES.
    """
    entries = _selected_blocks_gep(S, T, select)
    if not entries:
        return S.new_zeros((S.shape[0], 0)), Error.SUCCESS

    pos, is_pair, ar, ai, bt = (list(x) for x in zip(*entries))
    as_t = dict(dtype=S.dtype, device=S.device)
    xr, xi, close = _backsolve_all_gep(S, T, torch.tensor(ar, **as_t),
                                       torch.tensor(ai, **as_t),
                                       torch.tensor(bt, **as_t), pos, is_pair)
    X = _backtransform(Z, _columns(xr, xi, is_pair))
    info = Error.CLOSE_EIGENVALUES if bool(close.any()) else Error.SUCCESS
    return X, info
