"""Kernels E1's and E2's blocked backsolves (``kernels/csrc/eig_backsolve.cu``,
``eig_backsolve_gep.cu``) in plain PyTorch, for the tests.

It takes the row loop's arguments (``ops/eigenvectors.py:_backsolve_rows``,
the kernel's plain twin and the CPU path) and runs the kernel's schedule:
the eigenvalues sorted by pos, descending, in groups of ``group``; each
group's rows from its largest pos down to row 0 in row blocks of at most
``nb`` rows (a boundary that would split a 2x2 block moves up one row).
For a row block [r0, r1) it first forms the far part of every row's dot,
F = X[:, r1:hi] S[r0:r1, r1:hi]^T, from the rows already solved, then runs
the near chain: row k's dot is F[:, k - r0] plus x[k+1 : r1] . S[k, k+1 : r1],
then the twin's guarded solve (``_solve_row``).  A rescale (fac < 1) at
row k scales the vectors and the F of the block's rows still to come, as
LAPACK's dtrevc3 scales its right-hand sides.  Only the summation order
differs from the twin's.

:func:`backsolve_blocked_gep` does the same for the pencil's row loop
(``_backsolve_rows_gep``, E2's twin) on M = beta S - alpha T: the far
products FS = S[r0:r1, r1:hi] X and FT = T[r0:r1, r1:hi] X of the group
and the near dots of S's and T's rows are combined into M x by
:func:`combine`, in E2's order, and the solve is the twin's
``_solve_row_gep``.
"""

from __future__ import annotations

import numpy as np
import torch

from starneig_tpu_torch.ops.eigenvectors import _solve_row, _solve_row_gep

NB = 64      # the kernel's row block (kNB)
GROUP = 8    # the kernel's eigenvalues a block (kG)


def row_blocks(top: int, kind, nb: int = NB):
    """The row blocks [r0, r1) of a group whose largest pos is ``top``, in
    the order they are solved: from top down, at most nb rows each, none
    splitting a 2x2 block (kind 2 marks a block's second row)."""
    out, r1 = [], top
    while r1 > 0:
        r0 = max(0, r1 - nb)
        if r0 > 0 and kind[r0] == 2:
            r0 += 1
        out.append((r0, r1))
        r1 = r0
    return out


def _blocked(n, pos, kind, xr, xi, nb, group, rows_dot, solve):
    """The blocked schedule both models share, in place on (xr, xi).
    ``rows_dot(idx, Xr, Xi)`` gives the group's ``dot(i0, i1, c0, c1)``:
    the rows i0:i1's sums over x[c0:c1], (Re, Im) each (group, i1 - i0);
    ``solve(idx, k, two, do, rhs_r, rhs_i, rhs2_r, rhs2_i)`` is the twin's
    guarded solve for the group.  Returns the (m,) bool close flags."""
    if nb < 2:
        raise ValueError("backsolve_blocked: nb must be at least 2")
    pos = np.asarray(pos, np.int64)
    close = torch.zeros(len(pos), dtype=torch.bool, device=xr.device)
    order = np.argsort(-pos, kind="stable")
    for g0 in range(0, len(pos), group):
        sel = order[g0:g0 + group]
        idx = torch.as_tensor(sel, device=xr.device)
        pg = torch.as_tensor(pos[sel], device=xr.device)
        top = int(pos[sel].max())
        hi = min(n, top + 2)
        Xr, Xi = xr[idx], xi[idx]
        dot = rows_dot(idx, Xr, Xi)
        cl = torch.zeros(len(sel), dtype=torch.bool, device=xr.device)
        for r0, r1 in row_blocks(top, kind, nb):
            # far: the rows already solved, for the whole group at once
            Fr, Fi = dot(r0, r1, r1, hi)
            for k in range(r1 - 1, r0 - 1, -1):
                if kind[k] == 2:
                    continue
                i, two = k - r0, kind[k] == 1
                d1r, d1i = dot(k, k + 1, k + 1, r1)
                d1r, d1i = Fr[:, i] + d1r[:, 0], Fi[:, i] + d1i[:, 0]
                d2r = d2i = None
                if two:
                    d2r, d2i = dot(k + 1, k + 2, k + 2, r1)
                    d2r, d2i = -(Fr[:, i + 1] + d2r[:, 0]), -(Fi[:, i + 1] + d2i[:, 0])
                do = k < pg
                fac, w1r, w1i, w2r, w2i, near = solve(idx, k, two, do, -d1r, -d1i, d2r, d2i)
                cl |= near
                Xr *= fac[:, None]
                Xi *= fac[:, None]
                Fr[:, :i] *= fac[:, None]
                Fi[:, :i] *= fac[:, None]
                Xr[:, k] = torch.where(do, w1r, Xr[:, k])
                Xi[:, k] = torch.where(do, w1i, Xi[:, k])
                if two:
                    Xr[:, k + 1] = torch.where(do, w2r, Xr[:, k + 1])
                    Xi[:, k + 1] = torch.where(do, w2i, Xi[:, k + 1])
        xr[idx] = Xr
        xi[idx] = Xi
        close[idx] = cl
    return close


def backsolve_blocked(S, lam_r, lam_i, pos, is_pair, kind, smin, omega, smlnum,
                      xr, xi, nb: int = NB, group: int = GROUP):
    """``_backsolve_rows`` in E1's blocked schedule, in place on (xr, xi).
    Returns the (m,) bool close-eigenvalues flags."""

    def rows_dot(_idx, Xr, Xi):
        def dot(i0, i1, c0, c1):
            s = S[i0:i1, c0:c1].T
            return Xr[:, c0:c1] @ s, Xi[:, c0:c1] @ s
        return dot

    def solve(idx, k, two, do, *rhs):
        return _solve_row(S, k, two, lam_r[idx], lam_i[idx], smin[idx], omega, smlnum, do,
                          *rhs)
    return _blocked(S.shape[0], pos, kind, xr, xi, nb, group, rows_dot, solve)


def combine(bt, ar, ai, sr, si, tr, ti):
    """(Re, Im) of M x = (bt S - (ar + i ai) T)(xr + i xi) from (sr, si) =
    S x and (tr, ti) = T x, in E2's order (``eig_backsolve_gep.cu``:
    combine); bt, ar, ai broadcast against the sums."""
    return bt * sr - ar * tr + ai * ti, bt * si - ar * ti - ai * tr


def backsolve_blocked_gep(S, T, ar, ai, bt, pos, is_pair, kind, smin, omega, smlnum,
                          xr, xi, nb: int = NB, group: int = GROUP):
    """``_backsolve_rows_gep`` in E2's blocked schedule, in place on (xr,
    xi).  Returns the (m,) bool close-eigenvalues flags."""

    def rows_dot(idx, Xr, Xi):
        coef = bt[idx, None], ar[idx, None], ai[idx, None]

        def dot(i0, i1, c0, c1):
            s, t = S[i0:i1, c0:c1].T, T[i0:i1, c0:c1].T
            return combine(*coef, Xr[:, c0:c1] @ s, Xi[:, c0:c1] @ s, Xr[:, c0:c1] @ t,
                           Xi[:, c0:c1] @ t)
        return dot

    def solve(idx, k, two, do, *rhs):
        return _solve_row_gep(S, T, k, two, ar[idx], ai[idx], bt[idx], smin[idx], omega,
                              smlnum, do, *rhs)
    return _blocked(S.shape[0], pos, kind, xr, xi, nb, group, rows_dot, solve)
