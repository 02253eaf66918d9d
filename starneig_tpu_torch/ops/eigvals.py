"""Eigenvalue extraction from a real Schur form.

Port of ``starneig_tpu/ops/eigvals.py:extract_eigenvalues``: one
vectorized pass over the diagonal that computes both the 1x1 and the 2x2
hypothesis at every position and selects by block-membership masks.
"""

from __future__ import annotations

import torch

from starneig_tpu_torch.ops.primitives import eig2x2


def extract_eigenvalues(S):
    """Eigenvalues of a real Schur form S -> (real, imag), each of length n.

    2x2 diagonal blocks with a nonzero subdiagonal give conjugate pairs at
    their two positions.
    """
    z1 = S.new_zeros(1)
    f1 = torch.zeros(1, dtype=torch.bool, device=S.device)
    d = torch.diagonal(S)
    sub = torch.cat([torch.diagonal(S, -1), z1])
    sup = torch.cat([torch.diagonal(S, 1), z1])
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
