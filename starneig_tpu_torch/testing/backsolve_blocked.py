"""Kernel E1's blocked backsolve (``kernels/csrc/eig_backsolve.cu``) in
plain PyTorch, for the tests.

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
"""

from __future__ import annotations

import numpy as np
import torch

from starneig_tpu_torch.ops.eigenvectors import _solve_row

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


def backsolve_blocked(S, lam_r, lam_i, pos, is_pair, kind, smin, omega, smlnum,
                      xr, xi, nb: int = NB, group: int = GROUP):
    """``_backsolve_rows`` in E1's blocked schedule, in place on (xr, xi).
    Returns the (m,) bool close-eigenvalues flags."""
    if nb < 2:
        raise ValueError("backsolve_blocked: nb must be at least 2")
    n = S.shape[0]
    m = len(pos)
    pos = np.asarray(pos, np.int64)
    close = torch.zeros(m, dtype=torch.bool, device=S.device)
    order = np.argsort(-pos, kind="stable")
    for g0 in range(0, m, group):
        sel = order[g0:g0 + group]
        idx = torch.as_tensor(sel, device=S.device)
        pg = torch.as_tensor(pos[sel], device=S.device)
        top = int(pos[sel].max())
        hi = min(n, top + 2)
        Xr, Xi = xr[idx], xi[idx]
        lr, li, sm = lam_r[idx], lam_i[idx], smin[idx]
        cl = torch.zeros(len(sel), dtype=torch.bool, device=S.device)
        for r0, r1 in row_blocks(top, kind, nb):
            # far: the rows already solved, for the whole group at once
            Fr = Xr[:, r1:hi] @ S[r0:r1, r1:hi].T
            Fi = Xi[:, r1:hi] @ S[r0:r1, r1:hi].T
            for k in range(r1 - 1, r0 - 1, -1):
                if kind[k] == 2:
                    continue
                i, two = k - r0, kind[k] == 1
                d1r = Fr[:, i] + Xr[:, k + 1:r1] @ S[k, k + 1:r1]
                d1i = Fi[:, i] + Xi[:, k + 1:r1] @ S[k, k + 1:r1]
                d2r = d2i = None
                if two:
                    d2r = -(Fr[:, i + 1] + Xr[:, k + 2:r1] @ S[k + 1, k + 2:r1])
                    d2i = -(Fi[:, i + 1] + Xi[:, k + 2:r1] @ S[k + 1, k + 2:r1])
                do = k < pg
                fac, w1r, w1i, w2r, w2i, near = _solve_row(
                    S, k, two, lr, li, sm, omega, smlnum, do, -d1r, -d1i, d2r, d2i)
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
