"""Adjacent diagonal-block swaps in a generalized real Schur form.

Port of ``starneig_tpu/ops/swaps_gep.py`` (dtgex2's semantics): to swap
adjacent diagonal blocks of sizes (p, q) of a pencil (A, B), A
quasi-triangular and B upper triangular, solve the coupled generalized
Sylvester equations

    A11 R - L A22 = -A12,      B11 R - L B22 = -B12

for R, L (p x q) through a padded 8x8 Kronecker system, take the right
transform Z from a Householder QR of [R; I] and the left transform Q from
one of [L; I], and accept only when the transformed (2,1) blocks of both
matrices are negligible.  The new diagonal blocks are standardized with
:func:`starneig_tpu_torch.ops.qz.standardize_gep_2x2`.

The block sizes are host ints here (the JAX version masks them); every
operation of an inactive branch there is an exact identity, which this
port skips.  Kernel G4 (``kernels/csrc/aed_deflate_gep.cu``) carries a
device twin of :func:`swap_adjacent_gep`.
"""

from __future__ import annotations

import torch

from starneig_tpu_torch.ops import primitives as prim
from starneig_tpu_torch.ops.qz import standardize_gep_2x2

TINY = torch.finfo(torch.float64).tiny
EPS = torch.finfo(torch.float64).eps


def _solve8(A, b):
    """Solve an 8x8 system by Gauss-Jordan elimination with partial pivoting."""
    M = torch.cat([A, b[:, None]], dim=1)
    idx = torch.arange(8, device=A.device)
    for k in range(8):
        col = torch.where(idx >= k, M[:, k].abs(), -1.0)
        piv = int(torch.argmax(col))
        if piv != k:
            M[[k, piv]] = M[[piv, k]]
        pivval = M[k, k]
        pivval = torch.where(pivval == 0, TINY, pivval)
        factors = M[:, k] / pivval
        factors[k] = 0.0
        M = M - factors[:, None] * M[k][None, :]
    diag = torch.diagonal(M[:, :8])
    diag = torch.where(diag == 0, TINY, diag)
    return M[:, 8] / diag


def _qr_cols(M4, d: int, q: int):
    """Orthogonal (4, 4) Q whose leading q columns span the columns of M4
    ((4, 2), rows >= d and columns >= q zero)."""
    ar = torch.arange(4, device=M4.device)
    rmask = ar < d
    v1, tau1, _ = prim.householder(M4[:, 0], rmask)
    M1 = M4 - tau1 * torch.outer(v1, v1 @ M4)
    m2 = torch.where(ar >= 1, M1[:, 1], 0.0)
    v2r, tau2, _ = prim.householder(torch.roll(m2, -1),
                                    torch.roll(rmask & (ar >= 1), -1))
    v2 = torch.roll(v2r, 1)
    if q <= 1:
        tau2 = torch.zeros_like(tau2)
    Q = torch.eye(4, dtype=M4.dtype, device=M4.device)
    Q = Q - tau1 * torch.outer(v1, v1 @ Q)
    Q = Q - tau2 * torch.outer(v2, v2 @ Q)
    return Q.T


def _pad_blocks(M4, p: int, q: int):
    M11 = M4.new_zeros((2, 2))
    M22 = M4.new_zeros((2, 2))
    M12 = M4.new_zeros((2, 2))
    M11[:p, :p] = M4[:p, :p]
    M22[:q, :q] = M4[p:p + q, p:p + q]
    M12[:p, :q] = M4[:p, p:p + q]
    return M11, M22, M12


def _kron_rows(M11, M22, M12, p: int, q: int, block: int):
    """The 4 rows of one matrix's Sylvester equation in the unknowns
    x = [vec(R); vec(L)] (vec index 2 j + i); an inactive row is a unit row."""
    rows = M11.new_zeros((4, 8))
    rhs = M11.new_zeros(4)
    for k in range(4):
        i, j = k % 2, k // 2
        if i < p and j < q:
            rows[k, 2 * j] += M11[i, 0]
            rows[k, 2 * j + 1] += M11[i, 1]
            rows[k, 4 + i] += -M22[0, j]
            rows[k, 6 + i] += -M22[1, j]
            rhs[k] = -M12[i, j]
        else:
            rows[k, block * 4 + k] = 1.0
    return rows, rhs


def _std_at(Ah, Bh, Qs, Zs, off: int):
    """Re-triangularize and standardize the 2x2 pencil block at off."""
    dt, dev = Ah.dtype, Ah.device
    A2 = Ah[off:off + 2, off:off + 2].clone()
    B2 = Bh[off:off + 2, off:off + 2].clone()
    c0, s0, _ = prim.givens(B2[0, 0], B2[1, 0])
    G0 = torch.stack([torch.stack([c0, -s0]), torch.stack([s0, c0])])
    A2 = G0.T @ A2
    B2 = G0.T @ B2
    B2[1, 0] = 0.0
    G0e = torch.eye(4, dtype=dt, device=dev)
    G0e[off:off + 2, off:off + 2] = G0
    Ah = G0e.T @ Ah
    Bh = G0e.T @ Bh
    Qs = Qs @ G0e
    A2n, B2n, cl, sl, cr, sr = standardize_gep_2x2(A2, B2)
    Gl = torch.eye(4, dtype=dt, device=dev)
    Gl[off:off + 2, off:off + 2] = torch.stack([torch.stack([cl, -sl]),
                                                torch.stack([sl, cl])])
    Gr = torch.eye(4, dtype=dt, device=dev)
    Gr[off:off + 2, off:off + 2] = torch.stack([torch.stack([cr, -sr]),
                                                torch.stack([sr, cr])])
    Ah = Gl.T @ Ah @ Gr
    Bh = Gl.T @ Bh @ Gr
    Ah[off:off + 2, off:off + 2] = A2n
    Bh[off:off + 2, off:off + 2] = B2n
    return Ah, Bh, Qs @ Gl, Zs @ Gr


def swap_adjacent_gep(A4, B4, p: int, q: int):
    """Swap adjacent diagonal blocks of a pencil (A4, B4) at the top.

    Args:
      A4, B4: (4, 4) slices; upper block rows/cols [0, p), lower [p, p+q).
      p, q: block sizes in {1, 2} (host ints).

    Returns:
      (Qs, Zs, Ah, Bh, accept): 4x4 orthogonal transforms (identity beyond
      p+q), the swapped blocks Ah = Qs^T A4 Zs, Bh = Qs^T B4 Zs with exact
      (2,1) zeros, and the acceptance flag (a host bool; rejected ->
      identities and the inputs unchanged).
    """
    dt, dev = A4.dtype, A4.device
    d = p + q
    A11, A22, A12 = _pad_blocks(A4, p, q)
    B11, B22, B12 = _pad_blocks(B4, p, q)
    ra, ba = _kron_rows(A11, A22, A12, p, q, 0)
    rb, bb = _kron_rows(B11, B22, B12, p, q, 1)
    x = _solve8(torch.cat([ra, rb]), torch.cat([ba, bb]))
    R = x[:4].reshape(2, 2).T
    L = x[4:].reshape(2, 2).T

    def embed(X):
        M = A4.new_zeros((4, 2))
        M[:p] = X[:p]
        for c in range(q):
            M[p + c, c] += 1.0
        return M

    Zs = _qr_cols(embed(R), d, q)
    Qs = _qr_cols(embed(L), d, q)
    Ah = Qs.T @ A4 @ Zs
    Bh = Qs.T @ B4 @ Zs

    r = torch.arange(4, device=dev)[:, None]
    c = torch.arange(4, device=dev)[None, :]
    act = (r < d) & (c < d)
    blk21 = act & (r >= q) & (c < q)
    nrm = max(float(torch.where(act, A4.abs(), 0.0).max()),
              float(torch.where(act, B4.abs(), 0.0).max()))
    err = max(float(torch.where(blk21, Ah.abs(), 0.0).max()),
              float(torch.where(blk21, Bh.abs(), 0.0).max()))
    accept = err <= max(20.0 * EPS * nrm, TINY)
    if not accept:
        eye = torch.eye(4, dtype=dt, device=dev)
        return eye, eye.clone(), A4.clone(), B4.clone(), False
    Ah = torch.where(blk21, 0.0, Ah)
    Bh = torch.where(blk21, 0.0, Bh)
    if q == 2:
        Ah, Bh, Qs, Zs = _std_at(Ah, Bh, Qs, Zs, 0)
    if p == 2:
        Ah, Bh, Qs, Zs = _std_at(Ah, Bh, Qs, Zs, q)
    return Qs, Zs, Ah, Bh, True
