"""Hessenberg-triangular reduction (GEP): (A, B) -> (H, T) = (Q^T A Z, Q^T B Z).

Port of ``starneig_tpu/ops/hess_triangular.py``:

  1. B = Q0 R (``torch.linalg.qr``), A <- Q0^T A: B triangular;
  2. the interleaved Givens cascade: for each column j, bottom-up left
     rotations G(i-1, i) zero A[i, j]; each fills B[i, i-1], which a right
     rotation on columns (i-1, i) zeroes at once (dgghrd's mathematics).

:func:`_ht_reduce` is the plain PyTorch cascade, a host loop over the
~n^2/2 rotation steps; :func:`ht_reduce` is the dispatcher: kernel G1
(:func:`starneig_tpu_torch.ops.gpu_gep.ht_cascade`) for a CUDA tensor, the
plain cascade for a CPU tensor.  The rotation helpers here also serve the
QZ driver's window re-reduction (``ops/qz_driver.py``), G1's window mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import primitives as prim


def rot_rows(M, i: int, c, s):
    """Rows (i-1, i) <- (c r0 + s r1, -s r0 + c r1), in place."""
    r0, r1 = M[i - 1], M[i]
    new0 = c * r0 + s * r1
    r1.copy_(-s * r0 + c * r1)
    r0.copy_(new0)


def rot_cols(M, i: int, c, s):
    """Columns (i-1, i) <- (c c0 + s c1, -s c0 + c c1), in place."""
    c0, c1 = M[:, i - 1], M[:, i]
    new0 = c * c0 + s * c1
    c1.copy_(-s * c0 + c * c1)
    c0.copy_(new0)


def cascade_step(A, B, Q, Z, i: int, c, s):
    """One rotation pair of the cascade, in place: the left rotation (c, s)
    on rows (i-1, i) of A and B and columns of Q, then the right rotation
    that zeroes the B[i, i-1] fill, on columns (i-1, i) of B, A and Z
    (B[i, i-1] planted 0).  The caller plants the zero of the column the
    left rotation reduced."""
    rot_rows(A, i, c, s)
    rot_rows(B, i, c, s)
    rot_cols(Q, i, c, s)
    cr, sr, _ = prim.givens(B[i, i], B[i, i - 1])
    rot_cols(B, i, cr, -sr)
    B[i, i - 1] = 0.0
    rot_cols(A, i, cr, -sr)
    rot_cols(Z, i, cr, -sr)


def _givens(f: float, g: float):
    """:func:`primitives.givens`' (c, s) on Python floats, same formulas."""
    if g == 0.0:
        return 1.0, 0.0
    if f == 0.0:
        return 0.0, 1.0
    w, z = max(abs(f), abs(g)), min(abs(f), abs(g))
    q = z / w
    r = w * math.sqrt(1.0 + q * q)
    r = r if f >= 0 else -r
    return f / r, g / r


def _ht_reduce(A, B, Q, Z):
    """Interleaved Givens HT reduction of CPU tensors (B upper triangular):
    the plain twin of kernel G1.  Returns new (A, B, Q, Z).

    The rotations are the cascade's, in its order.  A left rotation skips
    known zeros as the kernel does (A's row pair from column j, B's from
    column i-1); a right rotation takes whole column pairs of A, B and Z
    (B's are zero below row i).  For speed on the host most rotations move
    contiguous memory: R[r] = (A^T[r], B^T[r], Z^T[r]) holds the
    right-rotated operands, so a right rotation rotates two rows of R, and
    a left rotation two rows of Q^T and two short columns of A^T and B^T.
    Scalars are read and zeros planted through a numpy view of R."""
    n = A.shape[0]
    R = torch.stack((A.T, B.T, Z.T), 1).contiguous()     # (n, 3, n)
    Qt = Q.T.contiguous()
    At, Bt, Rn = R[:, 0], R[:, 1], R.numpy()
    g = np.empty(4)
    G = torch.from_numpy(g).view(2, 2)     # the current rotation, shared with g
    Gt = G.T
    rbuf = R.new_empty((2, 3 * n))
    qbuf = R.new_empty((2, n))
    for j in range(n - 2):
        for i in range(n - 1, j + 1, -1):
            # left rotation on rows (i-1, i) zeroing A[i, j] (= At[j, i])
            c, s = _givens(float(Rn[j, 0, i - 1]), float(Rn[j, 0, i]))
            g[:] = (c, s, -s, c)
            for Mt, lo in ((At, j), (Bt, i - 1)):
                cols = Mt[lo:, i - 1:i + 1]
                cols.copy_(cols @ Gt)
            rows = Qt[i - 1:i + 1]
            torch.mm(G, rows, out=qbuf)
            rows.copy_(qbuf)
            Rn[j, 0, i] = 0.0
            # right rotation on columns (i-1, i) zeroing the fill B[i, i-1]
            c, s = _givens(float(Rn[i, 1, i]), float(Rn[i - 1, 1, i]))
            g[:] = (c, -s, s, c)
            rows = R[i - 1:i + 1].view(2, 3 * n)
            torch.mm(G, rows, out=rbuf)
            rows.copy_(rbuf)
            Rn[i - 1, 1, i] = 0.0
    return (At.T.contiguous(), Bt.T.contiguous(), Qt.T.contiguous(),
            R[:, 2].T.contiguous())


def ht_reduce(A, B, Q, Z):
    """The Givens cascade: kernel G1 for a CUDA tensor, :func:`_ht_reduce`
    for a CPU tensor.  Returns new (A, B, Q, Z)."""
    if A.is_cuda:
        return gpu_gep.ht_cascade(A, B, Q, Z)
    return _ht_reduce(A, B, Q, Z)


def triangularize_b(A, B, Q=None, Z=None):
    """Stage 1: B = Q0 R, A <- Q0^T A, Q <- Q Q0.  Returns the cascade's
    input (A1, R, Q1, Z1), contiguous, on A's device."""
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Qin = eye if Q is None else Q
    Zin = eye.clone() if Z is None else Z.clone()
    Q0, R = torch.linalg.qr(B)
    return ((Q0.T @ A).contiguous(), torch.triu(R).contiguous(),
            (Qin @ Q0).contiguous(), Zin.contiguous())


def hessenberg_triangular(A, B, Q=None, Z=None):
    """Reduce (A, B) to Hessenberg-triangular form on A's device.

    Mirrors ``starneig_GEP_SM_HessenbergTriangular`` (reference
    gep_sm.h:106-160).  Returns (H, T, Q, Z) with H = Q^T A Z upper
    Hessenberg and T = Q^T B Z upper triangular (Q and Z accumulate onto
    the given matrices).
    """
    A1, R, Q1, Z1 = triangularize_b(A, B, Q, Z)
    if A.shape[0] <= 2:
        return A1, R, Q1, Z1
    H, T, Qo, Zo = ht_reduce(A1, R, Q1, Z1)
    return torch.triu(H, -1), torch.triu(T), Qo, Zo
