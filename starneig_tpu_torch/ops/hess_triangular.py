"""Hessenberg-triangular reduction (GEP): (A, B) -> (H, T) = (Q^T A Z, Q^T B Z).

Port of ``starneig_tpu/ops/hess_triangular.py``:

  1. B = Q0 R (``torch.linalg.qr``), A <- Q0^T A: B triangular;
  2. the interleaved Givens cascade: for each column j, bottom-up left
     rotations G(i-1, i) zero A[i, j]; each fills B[i, i-1], which a right
     rotation on columns (i-1, i) zeroes at once (dgghrd's mathematics).

:func:`_ht_reduce` is the plain PyTorch cascade in the JAX order, a host
loop over the ~n^2/2 rotation steps, kept as the oracle of the blocked
form; :func:`ht_reduce` runs the same rotations blocked
(:func:`ht_blocked`: a generation step a block of nb cascades, then the
deferred updates as products of sliver factors), through kernel G1
(:func:`starneig_tpu_torch.ops.gpu_gep.ht_cascade`) for a CUDA tensor and
the plain twins of its two steps for a CPU tensor.  The rotation helpers
here also serve the QZ driver's window re-reduction
(``ops/qz_driver.py``), G1's window mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import primitives as prim
from starneig_tpu_torch.tools.trace import trace_span


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


# -- the blocked reduction ----------------------------------------------------
#
# The cascades run in blocks of nb columns (dgghd3's blocking, Kagstrom,
# Kressner, Quintana-Orti and Quintana-Orti, BIT 48 (2008)).  Generation
# reads A's column j and B's diagonal, whose current values depend on
# every earlier rotation's effect on the whole trailing pencil (a right
# rotation at the bottom of cascade j moves column j + 1 through the chain
# of its neighbours), so the rows of A and B below the block's first row
# take each cascade's rotations at once: cascade j's left rotations in
# column passes, its right rotations in row passes.  What no later
# rotation reads is deferred: the rows of A and B at or above the block's
# first row take the block's right rotations, Q its left and Z its right
# rotations, as dense factors of parallelogram slivers (L positions of
# each of the block's cascades, the window sliding one row a cascade) in
# matrix products once every block is generated.
#
# The rotation log: rot[pos] = (c, s, cr, sr), pos = _rot_offset(n, j) +
# n - 1 - k for the rotation pair of cascade j at rows (k-1, k).

NB = 32                 # cascades a block


def sliver_len(nb: int) -> int:
    """Positions a sliver takes of each cascade: its factors are of order
    sliver_len + nb (128 at nb = 32)."""
    return 3 * nb


def _rot_offset(n: int, j: int) -> int:
    return j * (n - 2) - j * (j - 1) // 2


def blocks(n: int, nb: int):
    """The blocks [J0, J1) of the cascades 0 .. n-3."""
    return [(J0, min(J0 + nb, n - 2)) for J0 in range(0, max(n - 2, 0), nb)]


def sliver_windows(n: int, J0: int, J1: int, L: int):
    """[(lo_nom, lo, hi)] a sliver s = 1, 2, ...: its factor covers the
    indices lo_nom .. lo_nom + L + J1 - J0 - 1, of which [lo, hi) lie in
    the pencil (the rest of the factor is the identity)."""
    w = L + J1 - J0
    S = -(-(n - J0 - 2) // L)
    out = []
    for s in range(1, S + 1):
        lo_nom = n - s * L - 1
        out.append((lo_nom, max(J0 + 1, lo_nom), min(n, lo_nom + w)))
    return out


def sliver_range(n: int, J0: int, L: int, s: int, j: int):
    """(kmax, kmin): the positions k of cascade j in sliver s, from kmax
    down to kmin (empty when kmax < kmin)."""
    return (min(n - 1, n - (s - 1) * L + (j - J0) - 1),
            max(j + 2, n - s * L + (j - J0)))


def _ht_generate(A, B, rot, J0: int, J1: int):
    """Plain twin of the generation kernel (``gpu_gep.ht_generate``):
    cascades J0 .. J1-1 on CPU tensors, in place, logged into rot: each
    cascade's steps (:func:`_ht_step`) on the whole pencil."""
    n = A.shape[0]
    for j in range(J0, J1):
        _ht_step(A, B, rot, n, 0, n, j, J0, 7)


def _ht_step(A, B, rot, n: int, lo: int, hi: int, j: int, J0: int, steps: int,
             base: int = 0):
    """Plain twin of ``gpu_gep.ht_generate_shard``: the steps of cascade j
    on CPU buffers A, B (n, ld) that hold the pencil's columns lo ..
    lo+ld-1 (the whole pencil: lo = 0, hi = ld = n), lo .. hi-1 their own,
    in place, logged into rot.  ``steps`` a mask:

      1  the left rotations from A's column j (rows j+1 ..; j own);
      2  the left pass: A's own rows (columns >= j, the zeros planted) and
         B's (columns >= k-1, B turning upper Hessenberg);
      4  the right chain: bottom-up each right rotation k = lo+ld-1 ..
         max(j+2, lo+1) from B's row k, applied to B's rows J0+1 .. k (the
         fill planted 0); then the right rotations to A's rows J0+1 ...  On
         a column shard the last column held may be the carried one: the
         neighbour's first column swept by the rotations right of it.

    rot holds the log from its row ``base`` (a block's first row on a
    column shard).  Each rotation reads the values the JAX order gives it
    (a left rotation of cascade j touches no entry its earlier right
    rotations read)."""
    if j + 2 > n - 1:
        return
    R = rot.numpy()
    G = torch.empty((2, 2), dtype=A.dtype)
    g = G.numpy().reshape(-1)
    off = _rot_offset(n, j) - base
    cend = lo + A.shape[1]
    ks = range(n - 1, j + 1, -1)
    if steps & 1:
        x = A[j + 1:, j - lo].tolist()
        y = x[-1]
        for t, k in enumerate(ks):
            a = x[k - j - 2]
            c, s = _givens(a, y)
            R[off + t, :2] = (c, s)
            y = c * a + s * y
    if steps & 2:
        for t, k in enumerate(ks):
            c, s = R[off + t, :2]
            g[:] = (c, s, -s, c)
            for M, c0 in ((A, j), (B, k - 1)):
                a0 = max(c0, lo)
                if a0 < hi:
                    rows = M[k - 1:k + 1, a0 - lo:hi - lo]
                    rows.copy_(G @ rows)
            if lo <= j < hi:
                A[k, j - lo] = 0.0
    kmin = max(j + 2, lo + 1)
    if steps & 4 and kmin <= min(cend - 1, n - 1):
        kr = range(cend - 1, kmin - 1, -1)
        for k in kr:
            cr, sr = _givens(float(B[k, k - lo]), float(B[k, k - 1 - lo]))
            R[off + n - 1 - k, 2:] = (cr, sr)
            g[:] = (cr, sr, -sr, cr)
            cols = B[J0 + 1:k + 1, k - 1 - lo:k + 1 - lo]
            cols.copy_(cols @ G)
            B[k, k - 1 - lo] = 0.0
        for k in kr:
            cr, sr = R[off + n - 1 - k, 2:]
            g[:] = (cr, sr, -sr, cr)
            cols = A[J0 + 1:, k - 1 - lo:k + 1 - lo]
            cols.copy_(cols @ G)


def _ht_slivers(rot, n: int, J0: int, J1: int, L: int, base: int = 0):
    """Plain twin of the sliver kernel (``gpu_gep.ht_slivers``): the dense
    factors of block [J0, J1)'s slivers from the log (its rows from
    ``base`` on), (S, 2, w, w) with w = L + J1 - J0: [s, 0] accumulates the
    left rotations as Q takes them (Q <- Q U), [s, 1] the right ones as Z
    and the rows above take them."""
    wins = sliver_windows(n, J0, J1, L)
    w = L + J1 - J0
    U = torch.eye(w, dtype=rot.dtype).repeat(len(wins), 2, 1, 1)
    R = rot.numpy()
    G = torch.empty((2, 2), dtype=rot.dtype)
    g = G.numpy().reshape(-1)
    for s, (lo_nom, _lo, _hi) in enumerate(wins, 1):
        for j in range(J0, J1):
            off = _rot_offset(n, j) - base
            kmax, kmin = sliver_range(n, J0, L, s, j)
            for k in range(kmax, kmin - 1, -1):
                c, sn, cr, sr = R[off + n - 1 - k]
                a = k - 1 - lo_nom
                for f, vals in ((0, (c, -sn, sn, c)), (1, (cr, sr, -sr, cr))):
                    g[:] = vals
                    cols = U[s - 1, f, :, a:a + 2]
                    cols.copy_(cols @ G)
    return U


def ht_blocked(A, B, Q, Z, generate, slivers, nb: int = NB, log=None):
    """The blocked reduction of (A, B), B upper triangular, with the given
    generation and sliver steps (the kernels' wrappers or their plain
    twins) over blocks of nb cascades (NB; the tests vary it); the far
    updates are matrix products.  ``log``, if a list, receives the rotation
    log.  A block's generation, and then its slivers and deferred
    products, are each a span ``ht.block`` (``tools/trace.py``).  Returns
    new (A, B, Q, Z) (the zeros planted)."""
    n = A.shape[0]
    A, B, Q, Z = (M.contiguous().clone() for M in (A, B, Q, Z))
    if n <= 2:
        return A, B, Q, Z
    L = sliver_len(nb)
    rot = A.new_zeros((_rot_offset(n, n - 2), 4))
    if log is not None:
        log.append(rot)
    blks = blocks(n, nb)
    for J0, J1 in blks:
        with trace_span("ht.block", (J0, J0, n - J0, J1 - J0)):
            generate(A, B, rot, J0, J1)
    for J0, J1 in blks:
        with trace_span("ht.block", (0, J0, n, n - J0)):
            U = slivers(rot, n, J0, J1, L)
            for s, (lo_nom, lo, hi) in enumerate(sliver_windows(n, J0, J1, L)):
                a, b = lo - lo_nom, hi - lo_nom
                UQ, UZ = U[s, 0, a:b, a:b], U[s, 1, a:b, a:b]
                Q[:, lo:hi] = Q[:, lo:hi] @ UQ
                Z[:, lo:hi] = Z[:, lo:hi] @ UZ
                A[:J0 + 1, lo:hi] = A[:J0 + 1, lo:hi] @ UZ
                B[:J0 + 1, lo:hi] = B[:J0 + 1, lo:hi] @ UZ
    return A, B, Q, Z


def ht_reduce(A, B, Q, Z):
    """The blocked HT reduction: kernel G1 (generation and slivers,
    :func:`starneig_tpu_torch.ops.gpu_gep.ht_cascade`) for a CUDA tensor,
    the plain twins of both steps for a CPU tensor, with the same host
    orchestration and products.  Returns new (A, B, Q, Z)."""
    if A.is_cuda:
        return gpu_gep.ht_cascade(A, B, Q, Z)
    return ht_blocked(A, B, Q, Z, _ht_generate, _ht_slivers)


def triangularize_b(A, B, Q=None, Z=None):
    """Stage 1: B = Q0 R, A <- Q0^T A, Q <- Q Q0 (the span ``ht.qr``).
    Returns the cascade's input (A1, R, Q1, Z1), contiguous, on A's
    device."""
    n = A.shape[0]
    with trace_span("ht.qr", (0, 0, n, n)):
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
