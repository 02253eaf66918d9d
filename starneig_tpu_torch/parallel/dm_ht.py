"""Distributed-memory Hessenberg-triangular reduction on column shards.

Counterpart of ``starneig_tpu/api/gep_dm.py:hessenberg_triangular``, where
XLA's SPMD partitioner splits the single-process reduction over a pencil
placed with a ``NamedSharding``.  Here the two stages of
:func:`starneig_tpu_torch.ops.hess_triangular.hessenberg_triangular` run on
this rank's column shards (``distr.shard_range``), with explicit
collectives (``parallel/distr.py``):

  1. :func:`triangularize_b_dm`, B = Q0 R as a blocked Householder QR in
     ``dm_hess``'s panel pattern: B's panel (rows k .., nb columns) is
     gathered by one masked ``all_reduce`` and factored on every rank
     (``torch.geqrf``, the compact-WY T on the host), Q0ᵀ is applied to
     each rank's own columns of A and B, and Q ← Q (I - V T Vᵀ) needs Q V,
     summed over the ranks by one ``all_reduce``.
  2. :func:`ht_cascade_dm`, the blocked cascade of ``ht_blocked`` (kernel
     G1 on the card, its plain twins on the CPU), each rank launching it on
     its own columns.  A cascade j's four steps split along the cuts:

       * its left rotations come from A's column j: the rank that owns it
         generates them and broadcasts them (n - j - 2 pairs);
       * the left pass is column-local: each rank applies them to its own
         columns, with no message;
       * the right chain runs bottom-up across the ranks, right to left.
         A rank's buffer holds its own columns and, left of a cut c, one
         more: the carried column, its neighbour's column c swept by the
         rotations right of c.  The rank right of the cut runs its chain
         and its right pass on its columns and hands the column over (A's
         and B's, rows J0+1 ..); the rank left of it computes the rotation
         at k = c from the carried column and continues, and hands the new
         column c back;
       * the hand-back rides in the message that carries cascade j+1's left
         rotations (or the next carried column), so a cascade costs about
         one message a cut in each direction, O(n) each.

     Each block's rotation log (O(nb n)) is summed onto every rank by one
     masked ``all_reduce``; then each rank forms the sliver factors from it
     (G1's sliver kernel on the card) and applies them to Q, Z and the rows
     above the block as column panels, so that a rank keeps one block's
     log
     (:meth:`~starneig_tpu_torch.parallel.dm_core.ShardedExtent.mul_cols_pencil`:
     a window inside one shard with no message, one across a cut by one
     gathered panel of each matrix).

No rank holds a whole matrix: the messages are B's panels and Q V (n x
nb), the cascades' carried columns and rotations (O(n)), the blocks' logs
and the sliver panels that cross a cut (one panel of each of Q, Z, A, B).
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import hess_triangular as ht
from starneig_tpu_torch.parallel.distr import Mesh, all_reduce, broadcast
from starneig_tpu_torch.parallel.dm_core import (ShardedExtent, _to, check_shard,
                                                 eye_cols, split_cuts)

QR_NB = 64              # B's QR: columns a panel


def _larft(V, tau):
    """The upper triangular T of the compact-WY form H_1 ... H_kb = I - V T
    Vᵀ of the reflectors (V unit lower trapezoidal, tau), on the host."""
    G = (V.T @ V).cpu().numpy()
    t = tau.cpu().numpy()
    kb = len(t)
    T = np.zeros((kb, kb))
    for i in range(kb):
        T[i, i] = t[i]
        if i:
            T[:i, i] = -t[i] * (T[:i, :i] @ G[:i, i])
    return torch.as_tensor(T, device=V.device)


def triangularize_b_dm(A, B, Q, Z, mesh: Mesh, stats: Optional[dict] = None,
                       nb: int = QR_NB):
    """Stage 1 on column shards: B = Q0 R, A <- Q0ᵀ A, Q <- Q Q0 (Q, Z
    None: the identity).  A blocked Householder QR: each panel of B (rows
    k .., columns k .. k+nb-1) is gathered (one masked all_reduce) and
    factored on every rank from the same data (``torch.geqrf``); the owners
    write R into the panel's columns, every rank applies the panel's Q0ᵀ
    to its own columns of A and of B right of the panel, and Q's own
    columns take Q V (one all_reduce of n x nb).  Returns this rank's
    shards of (A1, R, Q1, Z1)."""
    n = A.shape[0]
    lo, hi = split_cuts(n, mesh.size)[mesh.rank:mesh.rank + 2]
    A, B = A.clone(), B.clone()
    Q = eye_cols(n, mesh) if Q is None else Q.clone()
    Z = eye_cols(n, mesh) if Z is None else Z.clone()
    for k in range(0, n, nb):
        kb = min(nb, n - k)
        panel = B.new_zeros((n - k, kb))
        c0, c1 = max(k, lo), min(k + kb, hi)
        if c1 > c0:
            panel[:, c0 - k:c1 - k] = B[k:, c0 - lo:c1 - lo]
        all_reduce(panel, mesh, stats)
        Rp, tau = torch.geqrf(panel)
        V = torch.tril(Rp, -1)
        V.diagonal().fill_(1.0)
        T = _larft(V, tau)
        # Q0ᵀ on the own columns: A's all, B's right of the panel
        Al = A[k:]
        Al -= V @ (T.T @ (V.T @ Al))
        b0 = max(k + kb, lo)
        if b0 < hi:
            Bl = B[k:, b0 - lo:]
            Bl -= V @ (T.T @ (V.T @ Bl))
        if c1 > c0:
            B[k:, c0 - lo:c1 - lo] = torch.triu(Rp)[:, c0 - k:c1 - k]
        # Q <- Q (I - V T Vᵀ): the own columns >= k, Q V summed over the ranks
        a = min(max(k, lo), hi)
        Ql = Q[:, a - lo:]
        Va = V[a - k:hi - k]
        QV = all_reduce((Ql @ Va).contiguous(), mesh, stats)
        Ql -= (QV @ T) @ Va.T
    # R exactly upper triangular
    rows = torch.arange(n, device=B.device)[:, None]
    cols = torch.arange(lo, hi, device=B.device)[None, :]
    B.masked_fill_(rows > cols, 0.0)
    return A, B, Q, Z


class _Steps:
    """The generation steps of this rank's buffers: kernel G1 on the card
    (``gpu_gep.ht_generate_shard``), the plain twin ``_ht_step`` on the
    CPU.  ``rot`` holds the log from its row ``base``."""

    def __init__(self, A, B, n: int, lo: int, hi: int):
        self.A, self.B, self.n, self.lo, self.hi = A, B, n, lo, hi
        self.rot, self.base = None, 0
        self.work = A.new_empty(A.shape[1]) if A.is_cuda else None

    def __call__(self, j: int, J0: int, steps: int):
        """Cascade j's steps (``_ht_step``'s mask) that have work here."""
        n, lo, hi = self.n, self.lo, self.hi
        cend = lo + self.A.shape[1]
        if j + 2 > n - 1:
            return
        if max(j + 2, lo + 1) > min(cend - 1, n - 1):
            steps &= ~4
        if hi <= j:
            steps &= ~2
        if not steps:
            return
        if self.A.is_cuda:
            gpu_gep.ht_generate_shard(self.A, self.B, self.rot, self.work, self.n,
                                      lo, hi, j, J0, steps, self.base)
        else:
            ht._ht_step(self.A, self.B, self.rot, n, lo, hi, j, J0, steps, self.base)


def ht_cascade_dm(A, B, Q, Z, mesh: Mesh, stats: Optional[dict] = None,
                  nb: int = ht.NB, log: Optional[list] = None):
    """Stage 2 on column shards: ``ht_blocked``'s cascade of the pencil
    whose column shards are A, B (B upper triangular), Q and Z, in blocks
    of nb cascades.  A rank keeps one block's rotation log: each block's
    deferred products are applied once it is generated (they touch the
    rows at or above its first row, Q and Z, which no later generation
    reads or writes, so they commute with it).  ``log``, if a list,
    receives each block's gathered log (host copies), in order.  Returns
    this rank's shards of new (A, B, Q, Z) (the zeros planted)."""
    n = A.shape[0]
    P, r = mesh.size, mesh.rank
    cuts = split_cuts(n, P)
    lo, hi = cuts[r], cuts[r + 1]
    w = hi - lo
    last = r == P - 1
    Ab, Bb = (M.new_zeros((n, w + (0 if last else 1))) for M in (A, B))
    Ab[:, :w], Bb[:, :w] = A, B
    Q, Z = Q.clone(), Z.clone()
    if n <= 2:
        return Ab[:, :w].clone(), Bb[:, :w].clone(), Q, Z
    step = _Steps(Ab, Bb, n, lo, hi)
    blks = ht.blocks(n, nb)
    off = ht._rot_offset
    L = ht.sliver_len(nb)
    ext = ShardedExtent(mesh, stats, cuts)
    Aw, Bw = Ab[:, :w], Bb[:, :w]
    messages = [0]

    def owner(j):
        return bisect.bisect_right(cuts, j) - 1

    def cutrot(s, j):
        """A rotation of cascade j crosses the cut at cuts[s]."""
        return 0 < s < P and cuts[s] >= j + 2

    def rots_of(j):
        o = off(n, j) - step.base
        return step.rot[o:o + n - j - 2, :2]

    def send(src, parts):
        """Broadcast from src the concatenation of parts [(tensor view, on
        src the data, elsewhere the destination or None)]."""
        sizes = [v.numel() for v, _dst in parts]
        if r == src:
            buf = torch.cat([v.reshape(-1) for v, _dst in parts])
        else:
            buf = A.new_empty(sum(sizes))
        broadcast(buf, mesh, src=src, stats=stats)
        messages[0] += 1
        if r != src:
            for (v, dst), piece in zip(parts, buf.split(sizes)):
                if dst:
                    v.copy_(piece.view(v.shape))

    def column(M, c, r0, r1):
        """Rows r0 .. r1-1 of the global column c in this rank's buffer
        (its own or, at hi, the carried one)."""
        return M[r0:r1, c - lo]

    for J0, J1 in blks:
        # this block's log, with room for the next block's first left
        # rotations (generated at the end of this block's last cascade)
        prev, prev_base = step.rot, step.base
        step.base = off(n, J0)
        step.rot = A.new_zeros((off(n, min(J1 + 1, n - 2)) - step.base, 4))
        if prev is None:
            if owner(0) == r:
                step(0, 0, 1)
            if owner(0) < P - 1:
                send(owner(0), [(rots_of(0), True)])
        else:
            k = n - J0 - 2
            step.rot[:k, :2] = prev[step.base - prev_base:step.base - prev_base + k, :2]
        for j in range(J0, J1):
            q = owner(j)
            if r >= q:
                step(j, J0, 2)
            qn = owner(j + 1) if j + 1 <= n - 3 else None
            for s in range(P - 1, q - 1, -1):
                if r == s:
                    step(j, J0, 4)
                    if s == qn:
                        step(j + 1, J0, 1)
                parts = []
                if s > q and cutrot(s, j):
                    # the carried column, to s-1: s's first column swept
                    c = cuts[s]
                    dst = r == s - 1
                    parts += [(column(Ab, c, J0 + 1, n), dst) if r in (s, s - 1)
                              else (A.new_empty(n - J0 - 1), False),
                              (column(Bb, c, J0 + 1, c + 1), dst) if r in (s, s - 1)
                              else (A.new_empty(c - J0), False)]
                if s < P - 1 and cutrot(s + 1, j):
                    # the hand-back, to s+1: its first column after the cut's rotation
                    c = cuts[s + 1]
                    dst = r == s + 1
                    parts += [(column(Ab, c, J0 + 1, n), dst) if r in (s, s + 1)
                              else (A.new_empty(n - J0 - 1), False),
                              (column(Bb, c, J0 + 1, c + 1), dst) if r in (s, s + 1)
                              else (A.new_empty(c - J0), False)]
                if s == qn and qn < P - 1:
                    parts.append((rots_of(j + 1), True))
                if parts:
                    send(s, parts)
        block = step.rot[:off(n, J1) - step.base]
        _gather_log(block, n, J0, J1, cuts, r, owner, mesh, stats)
        if log is not None:
            log.append(block.cpu().clone())
        # the block's deferred products: its sliver factors on Q, Z and the
        # rows above the block, as column panels
        U = (gpu_gep.ht_slivers if A.is_cuda else ht._ht_slivers)(
            step.rot, n, J0, J1, L, step.base)
        for s_, (lo_nom, a0, b0) in enumerate(ht.sliver_windows(n, J0, J1, L)):
            a, b = a0 - lo_nom, b0 - lo_nom
            UQ, UZ = U[s_, 0, a:b, a:b], U[s_, 1, a:b, a:b]
            ext.mul_cols_pencil((Q, Z, Aw, Bw), a0, b0 - a0, [UQ, UZ, UZ, UZ],
                                i1s=(None, None, J0 + 1, J0 + 1))
    if stats is not None:
        stats["ht_messages"] = stats.get("ht_messages", 0) + messages[0]
        stats["log_rows"] = max(stats.get("log_rows", 0), step.rot.shape[0])
    return Aw.clone(), Bw.clone(), Q, Z


def _gather_log(block, n, J0, J1, cuts, r, owner, mesh, stats):
    """Block [J0, J1)'s log (``block``, its rows) on every rank: each rank
    adds the entries it computed (the left rotations of its own cascades,
    the right rotations of its chain) and zeros elsewhere, in one
    all_reduce."""
    o0 = ht._rot_offset(n, J0)
    lo, hi = cuts[r], cuts[r + 1]
    kcap = min(hi, n - 1)          # the cut's rotation is the left rank's
    mask = torch.zeros(tuple(block.shape), dtype=torch.bool)
    for j in range(J0, J1):
        o = ht._rot_offset(n, j) - o0
        if owner(j) == r:
            mask[o:o + n - j - 2, :2] = True
        kmin = max(j + 2, lo + 1)
        if kmin <= kcap:
            mask[o + n - 1 - kcap:o + n - kmin, 2:] = True
    buf = torch.where(mask.to(block.device), block, 0.0).contiguous()
    all_reduce(buf, mesh, stats)
    block.copy_(buf)


def hessenberg_triangular_dm(A, B, mesh: Mesh, Q=None, Z=None,
                             stats: Optional[dict] = None, nb: int = ht.NB):
    """Reduce the column-sharded pencil (A, B) to Hessenberg-triangular
    form (H, T) = (Qᵀ A Z, Qᵀ B Z): :func:`triangularize_b_dm`, then
    :func:`ht_cascade_dm`.  A, B (and Q, Z: None, the identity) are this
    rank's column shards of (n, n) matrices; returns this rank's shards of
    (H, T, Q, Z), H exactly upper Hessenberg and T upper triangular.
    ``stats``, if a dict, receives this rank's collective counts, bytes,
    largest message and seconds, the cascades' messages and the working
    shards' bytes.  A collective: every rank calls it with its own
    shards."""
    n = _to(A, mesh).shape[0]
    A, B = (check_shard(M, n, mesh, "hessenberg_triangular_dm") for M in (A, B))
    Q, Z = (None if M is None else check_shard(M, n, mesh, "hessenberg_triangular_dm")
            for M in (Q, Z))
    lo, hi = split_cuts(n, mesh.size)[mesh.rank:mesh.rank + 2]
    A1, R, Q1, Z1 = triangularize_b_dm(A, B, Q, Z, mesh, stats)
    H, T, Qo, Zo = ht_cascade_dm(A1, R, Q1, Z1, mesh, stats, nb)
    rows = torch.arange(n, device=H.device)[:, None]
    cols = torch.arange(lo, hi, device=H.device)[None, :]
    H.masked_fill_(rows > cols + 1, 0.0)
    T.masked_fill_(rows > cols, 0.0)
    if stats is not None:
        # B's QR's four output shards, the cascade's A and B buffers (one
        # carried column each) and one block's log; Q, Z, H and T are the
        # stage's output shards
        w1 = hi - lo + (0 if mesh.rank == mesh.size - 1 else 1)
        stats.update(NP=n, shard_shape=tuple(H.shape),
                     work_bytes=8 * (n * (4 * (hi - lo) + 2 * w1)
                                     + 4 * stats.get("log_rows", 0)))
    return H, T, Qo, Zo
