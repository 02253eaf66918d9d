"""Blocked Hessenberg reduction (SEP): A -> Q^T A Q = H upper Hessenberg.

Port of ``starneig_tpu/ops/hessenberg.py`` (its XLA branch): the blocked
two-sided compact-WY algorithm.  Per panel of width nb the columns are
reduced one at a time, each needing one matrix-vector product against the
frozen panel-start matrix (the sequential part); the panel yields V, T and
Y = A V T, and the trailing matrix is then updated from the right and the
left by large GEMMs, with Q accumulated per panel.

On the card a panel is one launch of kernel H1
(:func:`starneig_tpu_torch.ops.gpu_hess.panel`), as the JAX package ran
it as one device loop; on the CPU it is the plain twin
:func:`panel_factor`, whose matrix-vector products go through
:func:`starneig_tpu_torch.ops.gpu_hess.gemv` (kernel B1 on CUDA tensors:
the distributed reduction runs ``panel_factor`` on the card).  The
per-panel GEMMs of :func:`_apply_panel` are ``torch.matmul``, as the JAX
package left them to XLA.  Tensors are updated in place where the JAX
version rebuilt them; :func:`hessenberg` works on copies of the caller's
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from starneig_tpu_torch.config import HessenbergConf
from starneig_tpu_torch.ops import gpu_hess
from starneig_tpu_torch.ops import primitives as prim
from starneig_tpu_torch.ops.gpu_hess import gemv


def _panel(A, k: int, nb: int, t0: int = 0, end: Optional[int] = None):
    """Factorize panel columns k..k+nb-1 of A (which stays unchanged).

    Returns (V, T, Y, P): reflectors (n, nb) with v_j supported on rows
    > k+j, the compact-WY T (nb, nb), Y = A V T on rows >= t0 (n, nb), and
    the final panel column values P (n, nb) with exact zeros below the
    subdiagonal.  Every reflector is supported on rows > t0 <= k, so the
    panel matvec contracts only over the trailing block A[t0:, t0:].
    A CUDA tensor goes to kernel H1, a CPU tensor to :func:`panel_factor`.
    """
    if A.is_cuda:
        return gpu_hess.panel(A, k, nb, t0, end)
    At = A[t0:, t0:]
    return panel_factor(A[:, k:k + nb], lambda x: gemv(At, x), k, t0, end)


def panel_plain(A, k: int, nb: int, t0: int = 0, end: Optional[int] = None):
    """:func:`_panel` in torch operations alone on any device: on the card,
    the plain twin of kernel H1 (its products ``torch.mv``, not B1)."""
    At = A[t0:, t0:]
    return panel_factor(A[:, k:k + nb], lambda x: At @ x, k, t0, end,
                        gemv=gpu_hess.gemv_plain)


def panel_factor(cols, matvec, k: int, t0: int = 0, end: Optional[int] = None,
                 gemv=gemv):
    """:func:`_panel` on the panel's columns ``cols`` = A[:, k:k+nb]; the
    rest of A enters only through ``matvec(x)`` = A[t0:, t0:] @ x (x of
    length n - t0).  The distributed reduction
    (``parallel/dm_hess.py``) passes a gathered panel and a matvec over
    column shards.  ``gemv`` computes the compact-WY products (B1's
    wrapper; :func:`panel_plain` passes ``gpu_hess.gemv_plain``)."""
    n, nb = cols.shape
    lim = n if end is None else end
    V = cols.new_zeros((n, nb))
    T = cols.new_zeros((nb, nb))
    U = cols.new_zeros((n, nb))
    Y = cols.new_zeros((n, nb))
    P = cols.new_zeros((n, nb))
    zero = cols.new_zeros(())
    for j in range(nb):
        c = k + j
        # the column corrected by the panel's previous reflectors
        # (columns >= j of Y, V and T are still zero)
        a = cols[:, j].contiguous()
        a = a - gemv(Y[:, :j], V[c, :j].contiguous())
        w1 = gemv(V[:, :j], a, trans=True)
        a = a - gemv(V[:, :j], gemv(T[:j, :j], w1, trans=True))
        shift = c + 1
        active = c < lim - 1 and c < n - 1
        v = cols.new_zeros(n)
        if active:
            vt, tau, beta = prim.householder(a[shift:])
            v[shift:] = vt
            pcol = cols.new_zeros(n)
            pcol[:shift] = a[:shift]
            pcol[shift] = beta
        else:
            # columns outside [begin, end) keep their corrected values
            tau = zero
            pcol = a
        u = cols.new_zeros(n)
        u[t0:] = matvec(v[t0:])
        tcol = -tau * gemv(T[:j, :j], gemv(V[:, :j], v, trans=True))
        V[:, j] = v
        T[:j, j] = tcol
        T[j, j] = tau
        U[:, j] = u
        Y[:, j] = gemv(U[:, :j + 1], T[:j + 1, j].contiguous())
        P[:, j] = pcol
    return V, T, Y, P


def _apply_panel(A, Q, V, T, Y, P, k: int, t0: int = 0):
    """Trailing update + panel write-back + Q accumulation, in place.

    All reflectors live on rows > t0: the right update touches columns
    >= t0, the left update the trailing block [t0:, t0:], and Q columns
    >= t0.  Rows < t0 of Y and of the panel values are rebuilt here with
    one GEMM (the panel loop's matvec covered rows >= t0 only).
    """
    nb = V.shape[1]
    Vt = V[t0:]
    Ytop = (A[:t0, t0:] @ Vt) @ T
    Vp = V[k:k + nb]
    P[:t0] = A[:t0, k:k + nb] - Ytop @ Vp.T
    A[:t0, t0:] -= Ytop @ Vt.T
    A[t0:, t0:] -= Y[t0:] @ Vt.T
    At = A[t0:, t0:]
    At -= Vt @ (T.T @ (Vt.T @ At))
    A[:, k:k + nb] = P
    Q[:, t0:] -= (Q[:, t0:] @ Vt) @ (T @ Vt.T)


def hessenberg(A, Q=None, conf: Optional[HessenbergConf] = None,
               begin: int = 0, end: Optional[int] = None):
    """Reduce A to upper Hessenberg form: returns (H, Q) with H = Q^T A Q.

    Only columns [begin, end) are reduced (LAPACK's ilo/ihi convention:
    A[begin:, :begin] is assumed zero below the subdiagonal).  ``Q`` may
    hold an initial orthogonal matrix to accumulate onto.  Runs on A's
    device; the caller's tensors are not modified.
    """
    A = A.clone()
    n = A.shape[0]
    if end is None:
        end = n
    Q = (torch.eye(n, dtype=A.dtype, device=A.device) if Q is None
         else Q.clone())
    if n <= 2 or end - begin <= 2:
        return A, Q
    conf = (conf or HessenbergConf()).resolve(end - begin)
    nb = min(conf.panel_width, max(8, n - 2), n)
    # trailing-range bucket: t0 <= k snapped down to multiples of BK
    BK = max(nb, ((n // 8) // 8 + 1) * 8)
    for k in range(begin, end - 2, nb):
        # keep the panel inside the matrix; re-processing already reduced
        # columns is an exact no-op
        k_eff = max(0, min(k, n - nb))
        t0 = (k_eff // BK) * BK
        V, T, Y, P = _panel(A, k_eff, nb, t0, end)
        _apply_panel(A, Q, V, T, Y, P, k_eff, t0)
    return A, Q
