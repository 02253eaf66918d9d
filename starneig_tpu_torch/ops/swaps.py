"""Adjacent diagonal-block swaps in a real Schur form (dlaexc semantics).

Port of ``starneig_tpu/ops/swaps.py``: a (1,1)+(1,1) pair swaps by an
exact Givens rotation; any other pair solves the Sylvester equation
T11 X - X T22 = -T12 as a padded 4x4 Kronecker system, orthogonalizes
[X; I] with two Householder reflectors and accepts the swap only if the
new (2,1) block is negligible.  Block sizes p, q in {1, 2} are host ints
here (the callers decide them on the host); the arithmetic on the padded
4x4 block is the JAX version's.  ``kernels/csrc/common.cuh`` carries the
device twin used by the AED deflation kernel.
"""

from __future__ import annotations

import torch

from starneig_tpu_torch.ops import primitives as prim


def _solve4(A, b):
    """Solve a 4x4 system by Gaussian elimination with partial pivoting."""
    M = torch.cat([A, b[:, None]], dim=1)
    idx = torch.arange(4, device=A.device)
    tiny = torch.finfo(M.dtype).tiny
    for k in range(4):
        col = torch.where(idx >= k, M[:, k].abs(), -1.0)
        piv = int(torch.argmax(col))
        rk, rp = M[k].clone(), M[piv].clone()
        M[k], M[piv] = rp, rk
        pivval = M[k, k]
        pivval = torch.where(pivval == 0, tiny, pivval)
        factors = torch.where(idx == k, 0.0, M[:, k] / pivval)
        M = M - factors[:, None] * M[k][None, :]
    diag = torch.diagonal(M[:, :4])
    diag = torch.where(diag == 0, tiny, diag)
    return M[:, 4] / diag


def _swap_11(D4):
    """Exact rotation swap of two 1x1 blocks (dlaexc J1 case)."""
    t11, t12, t22 = D4[0, 0], D4[0, 1], D4[1, 1]
    cs, sn, _ = prim.givens(t12, t22 - t11)
    Q = torch.eye(4, dtype=D4.dtype, device=D4.device)
    Q[0, 0], Q[1, 0], Q[0, 1], Q[1, 1] = cs, sn, -sn, cs
    Dh = Q.T @ D4 @ Q
    Dh[0, 0], Dh[1, 1], Dh[1, 0] = t22, t11, 0.0
    return Q, Dh, True


def _swap_general(D4, p: int, q: int):
    """Sylvester + QR swap for (p, q) with p * q > 1 on the padded 4x4."""
    dtype, dev = D4.dtype, D4.device
    d = p + q
    zero2 = torch.zeros((2, 2), dtype=dtype, device=dev)
    T11 = zero2.clone()
    T11[:p, :p] = D4[:p, :p]
    T22 = zero2.clone()
    T22[:q, :q] = D4[p:p + q, p:p + q]
    T12 = zero2.clone()
    T12[:p, :q] = D4[:p, p:p + q]

    # Kronecker system for vec(X), unknown k = 2 * j + i; inactive unknowns
    # (i >= p or j >= q) get identity rows
    A = torch.zeros((4, 4), dtype=dtype, device=dev)
    b = torch.zeros(4, dtype=dtype, device=dev)
    for k in range(4):
        i, j = k % 2, k // 2
        if i < p and j < q:
            A[k, 2 * j + 0] += T11[i, 0]
            A[k, 2 * j + 1] += T11[i, 1]
            A[k, 2 * 0 + i] += -T22[0, j]
            A[k, 2 * 1 + i] += -T22[1, j]
            b[k] = -T12[i, j]
        else:
            A[k, k] = 1.0
    x = _solve4(A, b)
    X = x.reshape(2, 2).T

    # M = [X; I_q] in the first d rows of a 4x2 array
    M = torch.zeros((4, 2), dtype=dtype, device=dev)
    M[:p] = X[:p]
    for c in range(q):
        M[p + c, c] += 1.0

    r4 = torch.arange(4, device=dev)
    rmask4 = r4 < d
    v1, tau1, _ = prim.householder(M[:, 0], rmask4)
    M1 = M - tau1 * torch.outer(v1, v1 @ M)
    m2 = torch.where(r4 >= 1, M1[:, 1], 0.0)
    v2r, tau2, _ = prim.householder(torch.roll(m2, -1),
                                    torch.roll(rmask4 & (r4 >= 1), -1))
    v2 = torch.roll(v2r, 1)
    if q <= 1:
        tau2 = torch.zeros_like(tau2)
    Q = torch.eye(4, dtype=dtype, device=dev)
    Q = Q - tau1 * torch.outer(v1, v1 @ Q)
    Q = Q - tau2 * torch.outer(v2, v2 @ Q)
    Q = Q.T

    Dh = Q.T @ D4 @ Q

    r = r4[:, None]
    c = r4[None, :]
    active = (r < d) & (c < d)
    block21 = active & (r >= q) & (c < q)
    dnorm = torch.where(active, D4.abs(), 0.0).max()
    err = torch.where(block21, Dh.abs(), 0.0).max()
    finfo = torch.finfo(dtype)
    accept = bool(err <= max(10.0 * finfo.eps * float(dnorm), finfo.tiny))
    Dh = torch.where(block21, 0.0, Dh)
    return Q, Dh, accept


def _standardize_at(Dh, Q, off: int):
    """Standardize the 2x2 block of Dh at (off, off); compose into Q."""
    blk = Dh[off:off + 2, off:off + 2]
    aa, bb, cc, dd, *_e, cs, sn = prim.standardize_2x2(
        blk[0, 0], blk[0, 1], blk[1, 0], blk[1, 1])
    G = torch.eye(4, dtype=Dh.dtype, device=Dh.device)
    G[off, off], G[off + 1, off] = cs, sn
    G[off, off + 1], G[off + 1, off + 1] = -sn, cs
    Dh2 = G.T @ Dh @ G
    Dh2[off:off + 2, off:off + 2] = torch.stack(
        [torch.stack([aa, bb]), torch.stack([cc, dd])])
    return Dh2, Q @ G


def swap_adjacent(D4, p: int, q: int):
    """Swap adjacent diagonal blocks of sizes (p, q) at the top of D4.

    Returns (Q, Dh, accept): Q is 4x4 orthogonal (identity outside the
    leading p + q), Dh = Q^T D4 Q swapped and standardized with exact zeros
    in its (2,1) block, and accept a host bool (False: the swap was
    rejected, Q is the identity and Dh == D4).  The JAX version masks the
    standardization of 1x1 blocks and of rejected swaps; skipping it gives
    the same result, since the masked rotation is the identity.
    """
    if p == 1 and q == 1:
        Q, Dh, accept = _swap_11(D4)
    else:
        Q, Dh, accept = _swap_general(D4, p, q)
    if not accept:
        return torch.eye(4, dtype=D4.dtype, device=D4.device), D4.clone(), False
    # standardize the two new blocks: upper now has size q, lower size p
    if q == 2:
        Dh, Q = _standardize_at(Dh, Q, 0)
    if p == 2:
        Dh, Q = _standardize_at(Dh, Q, q)
    return Q, Dh, True
