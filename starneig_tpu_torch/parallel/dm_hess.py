"""Distributed-memory Hessenberg reduction on column shards.

Counterpart of ``starneig_tpu/api/sep_dm.py:hessenberg``, where XLA's SPMD
partitioner splits the single-process panel loop over column-sharded
arrays.  Here the algorithm of
:func:`starneig_tpu_torch.ops.hessenberg.hessenberg` (the same
``HessenbergConf().resolve(n)``, panel width nb, trailing buckets BK and
``t0``) runs on this rank's column shard, with explicit collectives
(``parallel/distr.py``):

  * a panel's columns, which lie on at most a few ranks, are gathered once
    a panel by one masked ``all_reduce`` (each rank adds the columns it
    owns, zeros elsewhere);
  * the panel's per-column work (the compact-WY corrections, dlarfg, the
    columns of T and Y: :func:`~starneig_tpu_torch.ops.hessenberg.panel_factor`)
    is replicated on every rank from identical inputs;
  * the panel matvec u = A[t0:, t0:] v runs kernel B1 (``gpu_hess.gemv``)
    on this rank's columns >= t0, a row-major view of the shard with unit
    column stride, and one ``all_reduce`` sums the partial products;
  * the trailing update needs Vᵀ A only on a rank's own columns; the
    partial products A[:t0, t0:] V and Q V are all-reduced, then each rank
    updates its own columns, and the panel's owners write it back.

Collectives: a panel n×nb, Ytop t0×nb and Q V n×nb a panel; one vector of
n - t0 a column.  A is never gathered.  Every rank must hold each panel's
V and T bit for bit, since the per-column decisions are replicated: the
sums arrive equal on every rank (an all-reduce hands every rank the same
result), and the replicated work runs the same kernels on the same
inputs.  With ``stats`` a SHA-256 of every panel's V and T is kept
(``stats["vt_sha256"]``) so that callers can compare the ranks.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from starneig_tpu_torch.config import HessenbergConf
from starneig_tpu_torch.ops.gpu_hess import gemv
from starneig_tpu_torch.ops.hessenberg import panel_factor
from starneig_tpu_torch.parallel.distr import Mesh, all_reduce, shard_range


def _gather_panel(A, lo: int, hi: int, k: int, nb: int, mesh: Mesh, stats):
    """A[:, k:k+nb] on every rank from the column shards [lo, hi)."""
    out = A.new_zeros((A.shape[0], nb))
    c0, c1 = max(k, lo), min(k + nb, hi)
    if c1 > c0:
        out[:, c0 - k:c1 - k] = A[:, c0 - lo:c1 - lo]
    return all_reduce(out, mesh, stats)


def _apply_panel_dm(A, Q, V, T, Y, P, cols, k: int, t0: int, lo: int,
                    hi: int, mesh: Mesh, stats):
    """``ops.hessenberg._apply_panel`` on the column shards A, Q (global
    columns [lo, hi)), in place; ``cols`` is the gathered panel."""
    nb = V.shape[1]
    a = min(max(lo, t0), hi)            # own global columns [a, hi) are >= t0
    Va, Vt = V[a:hi], V[t0:]
    Al = A[:, a - lo:]
    if t0 > 0:
        Ytop = all_reduce((Al[:t0] @ Va).contiguous(), mesh, stats) @ T
        P[:t0] = cols[:t0] - Ytop @ V[k:k + nb].T
        Al[:t0] -= Ytop @ Va.T
    Alt = Al[t0:]
    Alt -= Y[t0:] @ Va.T
    Alt -= Vt @ (T.T @ (Vt.T @ Alt))
    c0, c1 = max(k, lo), min(k + nb, hi)
    if c1 > c0:
        A[:, c0 - lo:c1 - lo] = P[:, c0 - k:c1 - k]
    Ql = Q[:, a - lo:]
    QV = all_reduce((Ql @ Va).contiguous(), mesh, stats)
    Ql -= QV @ (T @ Va.T)


def hessenberg_dm(A_loc, Q_loc, mesh: Mesh,
                  conf: Optional[HessenbergConf] = None,
                  stats: Optional[dict] = None):
    """Reduce the column-sharded A to upper Hessenberg form H = Qᵀ A Q.

    ``A_loc`` is this rank's columns of A (shard ``shard_range(n, size,
    rank)``), ``Q_loc`` this rank's columns of an initial orthogonal Q to
    accumulate onto (None: the identity).  Returns this rank's columns of
    H and Q; the inputs are not modified.  A collective: every rank calls
    it with its own shards.
    """
    n = A_loc.shape[0]
    lo, hi = shard_range(n, mesh.size, mesh.rank)
    if tuple(A_loc.shape) != (n, hi - lo):
        raise ValueError(f"hessenberg_dm: rank {mesh.rank} holds a shard of "
                         f"shape {tuple(A_loc.shape)}, not ({n}, {hi - lo})")
    A = A_loc.clone()
    if Q_loc is None:
        Q = A.new_zeros((n, hi - lo))
        Q[lo:hi] = torch.eye(hi - lo, dtype=A.dtype, device=A.device)
    else:
        Q = Q_loc.clone()
    if n <= 2:
        return A, Q
    conf = (conf or HessenbergConf()).resolve(n)
    nb = min(conf.panel_width, max(8, n - 2), n)
    BK = max(nb, ((n // 8) // 8 + 1) * 8)
    digest = hashlib.sha256() if stats is not None else None
    for k in range(0, n - 2, nb):
        k_eff = max(0, min(k, n - nb))
        t0 = (k_eff // BK) * BK
        cols = _gather_panel(A, lo, hi, k_eff, nb, mesh, stats)
        a = min(max(lo, t0), hi)
        At = A[t0:, a - lo:]

        def matvec(x, At=At, a=a, t0=t0):
            return all_reduce(gemv(At, x[a - t0:hi - t0].contiguous()), mesh, stats)

        V, T, Y, P = panel_factor(cols, matvec, k_eff, t0, n)
        _apply_panel_dm(A, Q, V, T, Y, P, cols, k_eff, t0, lo, hi, mesh, stats)
        if digest is not None:
            digest.update(V.cpu().numpy().tobytes())
            digest.update(T.cpu().numpy().tobytes())
    if digest is not None:
        stats["vt_sha256"] = digest.hexdigest()
    return A, Q
