"""Eigenvalue extraction from a real Schur form and a generalized one.

Port of ``starneig_tpu/ops/eigvals.py:extract_eigenvalues``: one
vectorized pass over the diagonal that computes both the 1x1 and the 2x2
hypothesis at every position and selects by block-membership masks.
Both read only the diagonals (:func:`schur_diagonals`), so the DM layer
gathers those and calls :func:`eigenvalues_from_diagonals` and
:func:`eigenvalues_gen_from_diagonals` on them.
"""

from __future__ import annotations

import torch

from starneig_tpu_torch.ops.primitives import eig2x2


def extract_eigenvalues(S):
    """Eigenvalues of a real Schur form S -> (real, imag), each of length n.

    2x2 diagonal blocks with a nonzero subdiagonal give conjugate pairs at
    their two positions.
    """
    return eigenvalues_from_diagonals(*schur_diagonals(S))


def schur_diagonals(S):
    """(diagonal, subdiagonal, superdiagonal) of S, each of length n (the
    last entry of the off-diagonals 0): all that the eigenvalues, the
    selection and the standardization read."""
    z1 = S.new_zeros(1)
    return (torch.diagonal(S), torch.cat([torch.diagonal(S, -1), z1]),
            torch.cat([torch.diagonal(S, 1), z1]))


def eigenvalues_from_diagonals(d, sub, sup):
    """:func:`extract_eigenvalues` from S's three diagonals
    (:func:`schur_diagonals`), so that a column-sharded S needs only
    them gathered."""
    z1 = d.new_zeros(1)
    f1 = torch.zeros(1, dtype=torch.bool, device=d.device)
    is_start = sub != 0
    prev_start = torch.cat([f1, is_start[:-1]])
    is_start = is_start & ~prev_start
    is_second = torch.cat([f1, is_start[:-1]])

    d_next = torch.cat([d[1:], z1])
    l1r, l1i, _l2r, _l2i = eig2x2(d, sup, sub, d_next)

    d_prev = torch.cat([z1, d[:-1]])
    sup_prev = torch.cat([z1, sup[:-1]])
    sub_prev = torch.cat([z1, sub[:-1]])
    _p1r, _p1i, p2r, p2i = eig2x2(d_prev, sup_prev, sub_prev, d)

    real = torch.where(is_start, l1r, torch.where(is_second, p2r, d))
    imag = torch.where(is_start, l1i, torch.where(is_second, p2i, 0.0))
    return real, imag


def extract_eigenvalues_gen(S, T):
    """Generalized eigenvalues of a pencil (S, T) in generalized real Schur
    form -> (real, imag, beta).

    Port of ``starneig_tpu/ops/eigvals.py:extract_eigenvalues_gen``:
    eigenvalue i is (real[i] + 1j imag[i]) / beta[i], beta == 0 for an
    infinite one.  A 1x1 block gives (s_ii, 0, t_ii); a 2x2 block (nonzero
    S subdiagonal, T upper triangular) gives the eigenvalues of
    S2 adj(T2) with beta = det(T2) at both positions.
    """
    ds, sub, sup = schur_diagonals(S)
    dt, _tsub, tsup = schur_diagonals(T)
    return eigenvalues_gen_from_diagonals(ds, sub, sup, dt, tsup)


def eigenvalues_gen_from_diagonals(ds, sub, sup, dt, tsup):
    """:func:`extract_eigenvalues_gen` from S's three diagonals and T's
    diagonal and superdiagonal (:func:`schur_diagonals`)."""
    z1 = ds.new_zeros(1)
    f1 = torch.zeros(1, dtype=torch.bool, device=ds.device)
    is_start = sub != 0
    prev_start = torch.cat([f1, is_start[:-1]])
    is_start = is_start & ~prev_start
    is_second = torch.cat([f1, is_start[:-1]])

    ds_next = torch.cat([ds[1:], z1])
    dt_next = torch.cat([dt[1:], z1 + 1.0])
    t11, t12, t22 = dt, tsup, dt_next
    beta2 = t11 * t22
    m11 = ds * t22
    m12 = -ds * t12 + sup * t11
    m21 = sub * t22
    m22 = -sub * t12 + ds_next * t11
    e1r, e1i, e2r, e2i = eig2x2(m11, m12, m21, m22)

    e2r_prev = torch.cat([z1, e2r[:-1]])
    e2i_prev = torch.cat([z1, e2i[:-1]])
    beta2_prev = torch.cat([z1 + 1.0, beta2[:-1]])
    real = torch.where(is_start, e1r, torch.where(is_second, e2r_prev, ds))
    imag = torch.where(is_start, e1i, torch.where(is_second, e2i_prev, 0.0))
    beta = torch.where(is_start, beta2, torch.where(is_second, beta2_prev, dt))
    return real, imag, beta
