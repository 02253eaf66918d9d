"""Eigenvectors from a real Schur form (SEP): overflow-guarded backsolve.

Port of the SEP part of ``starneig_tpu/ops/eigenvectors.py``.  For each
selected eigenvalue, (S - lambda I) y = 0 is solved by backward
substitution over the quasi-triangular S, and X = Q Y is one GEMM.  All
selected eigenvalues run at once: the JAX package vmapped one recurrence
per eigenvalue; here each row step is batched over the eigenvalues, and a
host loop walks the n - 1 rows.  Which rows are 1x1 rows, 2x2 block rows
or second rows of a block is decided on the host from S's subdiagonal,
read once; nothing in the loop reads the device.

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
(:func:`_backsolve_all_gep`, JAX ``eigenvectors.py:274-420``), infinite
eigenvalues (beta = 0) included, and returns X = Z Y.  Its backsolve
walks only the rows above the lowest selected block: the rows below it
are zero in every vector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.config import EigenvectorsConf
from starneig_tpu_torch.errors import Error


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


def _backsolve_all(S, lam_r, lam_i, pos, is_pair):
    """Backward substitution for a batch of m eigenvalues.

    Args:
      S: (n, n) real Schur form.
      lam_r, lam_i: (m,) eigenvalues (lam_i > 0 for pairs), on S's device.
      pos: (m,) host int block starts; is_pair: (m,) host bools.

    Returns:
      (xr, xi, close): (m, n) normalized eigenvector parts and an (m,)
      bool close-eigenvalues flag per column.
    """
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
    # initial entries at the eigenvalue's own block
    xr[cols, pos_t] = torch.where(pair_t, S[pos_t, p1], 1.0)
    xi[cols, p1] += torch.where(pair_t, lam_i, 0.0)
    close = torch.zeros(m, dtype=torch.bool, device=dev)

    for k in range(n - 2, -1, -1):
        is_second = k >= 1 and sub[max(k - 1, 0)] != 0
        if is_second:
            continue        # rows of a 2x2 block are solved at its first row
        in_range = k < pos_t
        rhs_r = -(xr[:, k + 1:] @ S[k, k + 1:])
        rhs_i = -(xi[:, k + 1:] @ S[k, k + 1:])
        if sub[k] == 0:
            # 1x1 row: x[k] = rhs / (S[k, k] - lambda), protected
            do_1 = in_range
            d_r = S[k, k] - lam_r
            d_i = -lam_i
            dabs = d_r.abs() + d_i.abs()
            near = do_1 & (dabs < smin)
            d_r = torch.where(near, smin, d_r)
            d_i = torch.where(near, 0.0, d_i)
            dabs = torch.maximum(dabs, smin)
            close |= near
            # scale the column before a growing division (robust.h's
            # protect_update: solve only after the bound admits it)
            rabs = rhs_r.abs() + rhs_i.abs()
            fac = torch.where(do_1 & (rabs > dabs * omega),
                              dabs * omega / torch.clamp_min(rabs, smlnum), 1.0)
            xr *= fac[:, None]
            xi *= fac[:, None]
            vr, vi = _cdiv(rhs_r * fac, rhs_i * fac, d_r, d_i, smlnum)
            xr[:, k] = torch.where(do_1, vr, xr[:, k])
            xi[:, k] = torch.where(do_1, vi, xi[:, k])
            continue
        # 2x2 block rows (k, k+1): solve the complex 2x2 system
        do_2 = in_range
        k1 = min(k + 1, n - 1)
        rhs2_r = -(xr[:, k1 + 1:] @ S[k1, k1 + 1:])
        rhs2_i = -(xi[:, k1 + 1:] @ S[k1, k1 + 1:])
        m11r, m11i = S[k, k] - lam_r, -lam_i
        m22r, m22i = S[k1, k1] - lam_r, -lam_i
        m12, m21 = S[k, k1], S[k1, k]
        # det = m11 m22 - m12 m21 (complex)
        detr = m11r * m22r - m11i * m22i - m12 * m21
        deti = m11r * m22i + m11i * m22r
        detabs = detr.abs() + deti.abs()
        blkscale = m11r.abs() + m11i.abs() + m12.abs() + m21.abs() \
            + m22r.abs() + m22i.abs() + smin
        near2 = do_2 & (detabs < smin * blkscale)
        detr = torch.where(near2, smin * blkscale, detr)
        deti = torch.where(near2, 0.0, deti)
        detabs = torch.maximum(detabs, smin * blkscale)
        close |= near2
        # x_k = (m22 r1 - m12 r2) / det ; x_k1 = (m11 r2 - m21 r1) / det
        n1r = m22r * rhs_r - m22i * rhs_i - m12 * rhs2_r
        n1i = m22r * rhs_i + m22i * rhs_r - m12 * rhs2_i
        n2r = m11r * rhs2_r - m11i * rhs2_i - m21 * rhs_r
        n2i = m11r * rhs2_i + m11i * rhs2_r - m21 * rhs_i
        nmax = torch.maximum(n1r.abs() + n1i.abs(), n2r.abs() + n2i.abs())
        fac = torch.where(do_2 & (nmax > detabs * omega),
                          detabs * omega / torch.clamp_min(nmax, smlnum), 1.0)
        xr *= fac[:, None]
        xi *= fac[:, None]
        w1r, w1i = _cdiv(n1r * fac, n1i * fac, detr, deti, smlnum)
        w2r, w2i = _cdiv(n2r * fac, n2i * fac, detr, deti, smlnum)
        xr[:, k] = torch.where(do_2, w1r, xr[:, k])
        xi[:, k] = torch.where(do_2, w1i, xi[:, k])
        xr[:, k1] = torch.where(do_2, w2r, xr[:, k1])
        xi[:, k1] = torch.where(do_2, w2i, xi[:, k1])

    # safe two-stage normalization
    mx = torch.maximum(xr.abs().amax(1), xi.abs().amax(1))
    mx = torch.where(mx == 0, 1.0, mx)
    xr, xi = xr / mx[:, None], xi / mx[:, None]
    nrm = torch.sqrt((xr * xr).sum(1) + (xi * xi).sum(1))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return xr / nrm[:, None], xi / nrm[:, None], close


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
    if torch.is_tensor(select):
        select = select.cpu().numpy()
    select = np.asarray(select, bool)
    diags = torch.stack([torch.diagonal(S),
                         torch.cat([torch.diagonal(S, -1), S.new_zeros(1)]),
                         torch.cat([torch.diagonal(S, 1), S.new_zeros(1)])])
    diag, sub, sup = diags.cpu().numpy()

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

    if not entries:
        return S.new_zeros((n, 0)), Error.SUCCESS

    pos, is_pair, lam_r, lam_i = (list(x) for x in zip(*entries))
    as_t = dict(dtype=S.dtype, device=S.device)
    xr, xi, close = _backsolve_all(S, torch.tensor(lam_r, **as_t),
                                   torch.tensor(lam_i, **as_t), pos, is_pair)
    # Y's columns: Re of every entry, Im right after it for a pair
    parts = []
    for j, pr in enumerate(is_pair):
        parts.append(xr[j])
        if pr:
            parts.append(xi[j])
    Y = torch.stack(parts, 1)
    X = _backtransform(Q, Y)
    # close-eigenvalue warning (reference: interface.c:57-88 + error.h:122)
    info = Error.CLOSE_EIGENVALUES if bool(close.any()) else Error.SUCCESS
    return X, info


# ===========================================================================
# generalized (pencil) eigenvectors: (beta S - alpha T) y = 0 (reference
# src/eigenvectors/generalized/, the robust solve of sirobust-geig.c:760)
# ===========================================================================

def _backsolve_all_gep(S, T, ar, ai, bt, pos, is_pair):
    """Backward substitution for (beta S - alpha T) x = 0, batched over m
    eigenvalues with a host loop over rows.

    Args:
      S, T: (n, n) generalized Schur form.
      ar, ai, bt: (m,) alpha = ar + i ai and beta, scaled to magnitude
        about 1 (the pair case carries the alpha of the eigenvalue with
        positive imaginary part), on S's device.
      pos: (m,) host int block starts; is_pair: (m,) host bools.

    Returns:
      (xr, xi, close): (m, n) normalized eigenvector parts and an (m,)
      bool close-eigenvalues flag per column.
    """
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
    # every vector is zero below its block: work on the leading N rows
    N = min(max(pos) + 2, n)
    S, T = S[:N, :N], T[:N, :N]

    pos_t = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
    pair_t = torch.as_tensor(np.asarray(is_pair, bool), device=dev)
    cols = torch.arange(m, device=dev)
    xr = S.new_zeros((m, n))
    xi = S.new_zeros((m, n))
    # starting vector: for a pair the null vector of the singular 2x2 of
    # M = beta S - alpha T at (p, p+1), from the row of larger magnitude
    p1 = torch.clamp_max(pos_t + 1, N - 1)
    m11r = bt * S[pos_t, pos_t] - ar * T[pos_t, pos_t]
    m11i = -ai * T[pos_t, pos_t]
    m12r = bt * S[pos_t, p1] - ar * T[pos_t, p1]
    m12i = -ai * T[pos_t, p1]
    m21r = bt * S[p1, pos_t]
    m21i = 0.0 * m21r
    m22r = bt * S[p1, p1] - ar * T[p1, p1]
    m22i = -ai * T[p1, p1]
    row0 = m11r * m11r + m11i * m11i + m12r * m12r + m12i * m12i
    row1 = m21r * m21r + m22r * m22r + m22i * m22i
    use0 = row0 >= row1
    w0r = torch.where(use0, -m12r, m22r)
    w0i = torch.where(use0, -m12i, m22i)
    w1r = torch.where(use0, m11r, -m21r)
    w1i = torch.where(use0, m11i, -m21i)
    xr[cols, pos_t] = torch.where(pair_t, w0r, 1.0)
    xi[cols, pos_t] = torch.where(pair_t, w0i, 0.0)
    xr[cols, p1] += torch.where(pair_t, w1r, 0.0)
    xi[cols, p1] += torch.where(pair_t, w1i, 0.0)
    close = torch.zeros(m, dtype=torch.bool, device=dev)
    bt_, ar_, ai_ = bt[:, None], ar[:, None], ai[:, None]

    def rhs(k):
        """-(M[k, k+1:] x[k+1:]) for every eigenvalue, M = beta S - alpha T."""
        mkr = bt_ * S[k, k + 1:] - ar_ * T[k, k + 1:]
        mki = -ai_ * T[k, k + 1:]
        xr_, xi_ = xr[:, k + 1:N], xi[:, k + 1:N]
        return (-((mkr * xr_).sum(1) - (mki * xi_).sum(1)),
                -((mkr * xi_).sum(1) + (mki * xr_).sum(1)))

    def mentry(k, j):
        return bt * S[k, j] - ar * T[k, j], -ai * T[k, j]

    # rows at or below the lowest block start are in no vector's range
    for k in range(min(max(pos) - 1, n - 2), -1, -1):
        is_second = k >= 1 and sub[max(k - 1, 0)] != 0
        if is_second:
            continue        # rows of a 2x2 block are solved at its first row
        in_range = k < pos_t
        rhs_r, rhs_i = rhs(k)
        if sub[k] == 0:
            # 1x1 row, with the robust.h protections (perturb a
            # near-singular diagonal, scale before a growing division)
            do_1 = in_range
            d_r, d_i = mentry(k, k)
            dabs = d_r.abs() + d_i.abs()
            near = do_1 & (dabs < smin)
            d_r = torch.where(near, smin, d_r)
            d_i = torch.where(near, 0.0, d_i)
            dabs = torch.maximum(dabs, smin)
            close |= near
            rabs = rhs_r.abs() + rhs_i.abs()
            fac = torch.where(do_1 & (rabs > dabs * omega),
                              dabs * omega / torch.clamp_min(rabs, smlnum), 1.0)
            xr *= fac[:, None]
            xi *= fac[:, None]
            vr, vi = _cdiv(rhs_r * fac, rhs_i * fac, d_r, d_i, smlnum)
            xr[:, k] = torch.where(do_1, vr, xr[:, k])
            xi[:, k] = torch.where(do_1, vi, xi[:, k])
            continue
        # 2x2 block rows (k, k+1): the complex 2x2 system
        do_2 = in_range
        k1 = k + 1
        rhs2_r, rhs2_i = rhs(k1)
        a11r, a11i = mentry(k, k)
        a12r, a12i = mentry(k, k1)
        a21r, a21i = mentry(k1, k)
        a22r, a22i = mentry(k1, k1)
        detr = a11r * a22r - a11i * a22i - (a12r * a21r - a12i * a21i)
        deti = a11r * a22i + a11i * a22r - (a12r * a21i + a12i * a21r)
        detabs = detr.abs() + deti.abs()
        blkscale = a11r.abs() + a11i.abs() + a12r.abs() + a12i.abs() \
            + a21r.abs() + a21i.abs() + a22r.abs() + a22i.abs() + smin
        near2 = do_2 & (detabs < smin * blkscale)
        detr = torch.where(near2, smin * blkscale, detr)
        deti = torch.where(near2, 0.0, deti)
        detabs = torch.maximum(detabs, smin * blkscale)
        close |= near2
        n1r = a22r * rhs_r - a22i * rhs_i - (a12r * rhs2_r - a12i * rhs2_i)
        n1i = a22r * rhs_i + a22i * rhs_r - (a12r * rhs2_i + a12i * rhs2_r)
        n2r = a11r * rhs2_r - a11i * rhs2_i - (a21r * rhs_r - a21i * rhs_i)
        n2i = a11r * rhs2_i + a11i * rhs2_r - (a21r * rhs_i + a21i * rhs_r)
        nmax = torch.maximum(n1r.abs() + n1i.abs(), n2r.abs() + n2i.abs())
        fac = torch.where(do_2 & (nmax > detabs * omega),
                          detabs * omega / torch.clamp_min(nmax, smlnum), 1.0)
        xr *= fac[:, None]
        xi *= fac[:, None]
        w1r, w1i = _cdiv(n1r * fac, n1i * fac, detr, deti, smlnum)
        w2r, w2i = _cdiv(n2r * fac, n2i * fac, detr, deti, smlnum)
        xr[:, k] = torch.where(do_2, w1r, xr[:, k])
        xi[:, k] = torch.where(do_2, w1i, xi[:, k])
        xr[:, k1] = torch.where(do_2, w2r, xr[:, k1])
        xi[:, k1] = torch.where(do_2, w2i, xi[:, k1])

    mx = torch.maximum(xr.abs().amax(1), xi.abs().amax(1))
    mx = torch.where(mx == 0, 1.0, mx)
    xr, xi = xr / mx[:, None], xi / mx[:, None]
    nrm = torch.sqrt((xr * xr).sum(1) + (xi * xi).sum(1))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return xr / nrm[:, None], xi / nrm[:, None], close


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
    n = S.shape[0]
    if torch.is_tensor(select):
        select = select.cpu().numpy()
    select = np.asarray(select, bool)
    z = S.new_zeros(1)
    ds, dt, sub, sup_s, sup_t = torch.stack([
        torch.diagonal(S), torch.diagonal(T), torch.cat([torch.diagonal(S, -1), z]),
        torch.cat([torch.diagonal(S, 1), z]),
        torch.cat([torch.diagonal(T, 1), z])]).cpu().numpy()

    # the selected blocks, on the host: (pos, is_pair, alpha_r, alpha_i, beta)
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

    if not entries:
        return S.new_zeros((n, 0)), Error.SUCCESS

    pos, is_pair, lr, li, b = (list(x) for x in zip(*entries))
    # (alpha, beta) scaled to magnitude about 1
    scale = [max(abs(r) + abs(im), abs(bb), 1e-300) for r, im, bb in zip(lr, li, b)]
    as_t = dict(dtype=S.dtype, device=S.device)
    ar = torch.tensor([r / c for r, c in zip(lr, scale)], **as_t)
    ai = torch.tensor([im / c for im, c in zip(li, scale)], **as_t)
    bt = torch.tensor([bb / c for bb, c in zip(b, scale)], **as_t)
    xr, xi, close = _backsolve_all_gep(S, T, ar, ai, bt, pos, is_pair)
    parts = []
    for j, pr in enumerate(is_pair):
        parts.append(xr[j])
        if pr:
            parts.append(xi[j])
    Y = torch.stack(parts, 1)
    X = _backtransform(Z, Y)
    info = Error.CLOSE_EIGENVALUES if bool(close.any()) else Error.SUCCESS
    return X, info
