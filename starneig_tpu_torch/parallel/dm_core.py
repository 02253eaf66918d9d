"""Distributed-memory Schur reduction and reordering on column shards.

Port of ``starneig_tpu/parallel/dm_core.py``.  The reference's DM layer
reruns the *same* task-insertion core with MPI (reference
``src/mpi/interface_schur.c:53-120``, window tasks owner-executed
``src/schur/core.c:1498-1545``).  Here the port's own drivers,
:func:`starneig_tpu_torch.ops.schur._schur_iter`,
:func:`starneig_tpu_torch.ops.qz_driver._qz_iter` and
:func:`starneig_tpu_torch.ops.reorder.reorder_gep_`, route every access to
the padded matrices through an extent strategy, and :class:`ShardedExtent`
carries those accesses out on column shards, one shard a rank, with
explicit collectives (``parallel/distr.py``):

  * row-strip updates (``mul_rows``/``mul_rows_batch``, ranged or not) and
    the standardization's row pairs are shard-local: each rank updates the
    rows of its own columns;
  * a column panel (``mul_cols_pencil``/``mul_cols_batch``) that lies
    inside one shard is multiplied by its owner, with no message; one
    across a cut, and every block read (``get_block``/``get_blocks``/
    ``get_diag_blocks``), is gathered by a masked ``all_reduce``: each
    rank adds the columns it owns and zeros elsewhere, so every rank
    holds bit-identical panels, and writes back only the columns it owns.
    One message holds the panels of all the matrices an operation takes
    (S and Q, or the pencil's four), and a batch of windows takes as many
    messages as it needs so that none holds more than one panel of width
    ``wmax`` (the widest window) of each matrix;
  * ``diagonals`` and ``zero_negligible`` gather the three diagonals of
    the inner block (O(n)); the latter writes back the owned subdiagonal
    entries;
  * ``rot_col_pairs`` rotates column pairs in place; a pair that straddles
    two shards takes one small exchange of its two columns;
  * the window math (``window``: an AED round's window solve, spike
    deflation, status read and recondense; a sweep's hop; the infinite
    push's chases and deflating rotation; a reordering window's bubble; the
    standardization's 2x2 rotations and the eigenvalues) runs on rank 0
    alone, which broadcasts its outputs.  The JAX package replicates that
    math on every shard, cheaper on a TPU mesh.  Here ranks may share one
    card, where replicas would launch the window kernels once a rank, and
    a replica that rounded differently would steer its host loop apart
    from the others: a hang, or a silently wrong matrix.  With one owner
    and a broadcast every rank takes the same decisions by construction.

Layout.  ``schur_dm``, ``reorder_dm`` and ``dm_gep``'s functions take
column shards in and give column shards out, ``distr.shard_range``'s
split of the n columns.  The padded buffer (NP = n + 2P columns) splits
at the same places: rank r holds the padded columns [P + lo_r, P + hi_r),
rank 0 also the left padding [0, P) and the last rank the right padding
[P + n, NP) (:func:`pad_cuts`).  Entering and leaving moves no data
between ranks: each rank copies its shard into its padded shard and
back.  Offsets are host ints (the iterations are host loops), so a
panel's overlap with a shard is index arithmetic on the host, and a
window may fall across any number of shards: shards need not be as wide
as a window.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.config import ReorderConf, SchurConf
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.node import log
from starneig_tpu_torch.ops.schur import DenseExtent, negligible_zeroed
from starneig_tpu_torch.parallel.distr import (DistrMatrix, Mesh, all_reduce,
                                               make_mesh, owner_call,
                                               shard_range)


def split_cuts(m: int, size: int):
    """[first column of each rank's shard of range(m)] + [m]."""
    return [shard_range(m, size, r)[0] for r in range(size)] + [m]


def pad_cuts(n: int, P: int, size: int):
    """The column cuts of the padded (n + 2P)-wide buffer: rank r holds
    [cuts[r], cuts[r+1]), its inner columns those of ``split_cuts(n)``
    shifted by P, rank 0 with the left padding, the last rank with the
    right."""
    cuts = [P + c for c in split_cuts(n, size)]
    cuts[0], cuts[-1] = 0, n + 2 * P
    return cuts


class ShardedExtent:
    """Extent ops on this rank's (rows, cuts[rank+1] - cuts[rank]) column
    shard of the padded buffers: rank d owns the global columns
    [cuts[d], cuts[d+1]).  Same methods and in-place semantics as
    ``DenseExtent``; every gather is a collective, so every rank calls
    every op in the same order."""

    def __init__(self, mesh: Mesh, stats: Optional[dict], cuts, wmax: int = 0):
        self.mesh, self.stats, self.cuts, self.wmax = mesh, stats, list(cuts), wmax
        self.base = self.cuts[mesh.rank]
        self.end = self.cuts[mesh.rank + 1]

    def _owned(self, j0: int, w: int):
        """(lo, hi, p0): this shard's local columns [lo, hi) are the panel
        columns [p0, p0 + hi - lo) of the global columns [j0, j0 + w)."""
        a, b = max(j0, self.base), min(j0 + w, self.end)
        return a - self.base, max(a, b) - self.base, a - j0

    def _reduce(self, t):
        return all_reduce(t, self.mesh, self.stats)

    def _gather(self, parts):
        """[M[i0:i1, j0:j0+w] for each (M, i0, i1, j0, w) of parts] on
        every rank, by one masked all_reduce."""
        M0 = parts[0][0]
        shapes = [(i1 - i0, w) for _M, i0, i1, _j0, w in parts]
        buf = M0.new_zeros(sum(h * w for h, w in shapes))
        views = [v.view(s) for v, s in
                 zip(buf.split([h * w for h, w in shapes]), shapes)]
        for v, (M, i0, i1, j0, w) in zip(views, parts):
            lo, hi, p0 = self._owned(j0, w)
            v[:, p0:p0 + hi - lo] = M[i0:i1, lo:hi]
        self._reduce(buf)
        return views

    # rows are unsharded under column sharding: fully local
    mul_rows_batch = staticmethod(DenseExtent.mul_rows_batch)
    rot_row_pairs = staticmethod(DenseExtent.rot_row_pairs)

    def mul_rows(self, S, i0: int, h: int, Qw, j0: int = 0):
        """S[i0:i0+h, j0:] = Qw^T S[i0:i0+h, j0:] on the own columns."""
        lo = max(j0 - self.base, 0)
        if lo < S.shape[1]:
            S[i0:i0 + h, lo:] = Qw.T @ S[i0:i0 + h, lo:]

    def get_block(self, S, i0: int, j0: int, h: int, w: int):
        """S[i0:i0+h, j0:j0+w] on every rank (one masked all_reduce)."""
        return self._gather([(S, i0, i0 + h, j0, w)])[0]

    def get_blocks(self, Ms, i0: int, j0: int, h: int, w: int):
        """[M[i0:i0+h, j0:j0+w] for each M of Ms] (one all_reduce)."""
        return self._gather([(M, i0, i0 + h, j0, w) for M in Ms])

    def set_block(self, S, M, i0: int, j0: int):
        """Write the columns of M (placed at global (i0, j0)) this shard
        owns."""
        lo, hi, p0 = self._owned(j0, M.shape[1])
        S[i0:i0 + M.shape[0], lo:hi] = M[:, p0:p0 + hi - lo]

    def set_entries(self, S, rows, cols, vals):
        """S[rows[k], cols[k]] = vals[k] where this shard owns cols[k]."""
        own = (cols >= self.base) & (cols < self.end)
        if not isinstance(vals, torch.Tensor):
            vals = torch.full(cols.shape, float(vals), dtype=S.dtype,
                              device=S.device)
        S[rows[own], cols[own] - self.base] = vals[own]

    def _inside(self, j0: int, w: int) -> Optional[int]:
        """The rank whose shard holds every column of [j0, j0 + w), None
        where they cross a cut."""
        for r in range(len(self.cuts) - 1):
            if self.cuts[r] <= j0 and j0 + w <= self.cuts[r + 1]:
                return r
        return None

    def mul_cols_pencil(self, Ms, j0: int, w: int, Xs, i1s=None):
        """M[:i1, j0:j0+w] = M[:i1, j0:j0+w] X for each M, X, i1: a panel
        inside one shard is multiplied there, with no message; across a
        cut the panels of every M are gathered in one all_reduce and each
        rank writes back its own columns."""
        i1s = [M.shape[0] if i1 is None else i1
               for M, i1 in zip(Ms, i1s or [None] * len(Ms))]
        r = self._inside(j0, w)
        if r is not None:
            if r == self.mesh.rank:
                DenseExtent.mul_cols_pencil(Ms, j0 - self.base, w, Xs, i1s)
            return
        panels = self._gather([(M, 0, i1, j0, w) for M, i1 in zip(Ms, i1s)])
        lo, hi, p0 = self._owned(j0, w)
        if hi > lo:
            for M, X, i1, panel in zip(Ms, Xs, i1s, panels):
                M[:i1, lo:hi] = (panel @ X)[:, p0:p0 + hi - lo]

    def get_diag_blocks(self, S, ws, w: int):
        out = S.new_zeros((len(ws), w, w))
        for g, s in enumerate(ws):
            lo, hi, p0 = self._owned(s, w)
            out[g, :, p0:p0 + hi - lo] = S[s:s + w, lo:hi]
        return self._reduce(out)

    def set_diag_blocks(self, S, Ms, ws):
        for g, s in enumerate(ws):
            self.set_block(S, Ms[g], s, s)

    def mul_cols_batch(self, Ms, ws, w: int, Qws):
        """``DenseExtent.mul_cols_batch``: a window inside one shard is
        multiplied there, with no message; for the windows across a cut
        each message gathers the panels of every M of Ms for as many
        windows as fit in one panel of width ``wmax`` (at least one)."""
        cross = []
        for g, s in enumerate(ws):
            r = self._inside(s, w)
            if r is None:
                cross.append(g)
            elif r == self.mesh.rank:
                DenseExtent.mul_cols_batch(Ms, [s - self.base], w, Qws[g:g + 1])
        k = max(1, self.wmax // w)
        for c in range(0, len(cross), k):
            chunk = cross[c:c + k]
            panels = iter(self._gather([(M, 0, M.shape[0], ws[g], w)
                                        for g in chunk for M in Ms]))
            for g in chunk:
                lo, hi, p0 = self._owned(ws[g], w)
                for M in Ms:
                    panel = next(panels)
                    if hi > lo:
                        M[:, lo:hi] = (panel @ Qws[g])[:, p0:p0 + hi - lo]

    def diagonals(self, Ms, p: int, n: int):
        """(len(Ms), 3, n) on every rank: the diagonal, the subdiagonal and
        the superdiagonal (last entries 0) of each global block
        M[p:p+n, p:p+n] (one all_reduce)."""
        out = Ms[0].new_zeros((len(Ms), 3, n))
        a, b = max(p, self.base), min(p + n, self.end)
        for k, M in enumerate(Ms):
            if a < b:
                loc = M[:, a - self.base:b - self.base]
                out[k, 0, a - p:b - p] = torch.diagonal(loc[a:b])
                b1 = min(b, p + n - 1)          # sub: columns [a, p+n-1)
                if a < b1:
                    out[k, 1, a - p:b1 - p] = torch.diagonal(loc[a + 1:b1 + 1])
                a1 = max(a, p + 1)              # sup: columns [p+1, b)
                if a1 < b:
                    out[k, 2, a1 - p - 1:b - p - 1] = torch.diagonal(
                        M[a1 - 1:b - 1, a1 - self.base:b - self.base])
        return self._reduce(out)

    def zero_negligible(self, Spad, P: int, n: int, ihi: int, thresh: float):
        """Sharded negligible-subdiagonal zeroing (JAX dm_core.py:173-208):
        gather the diagonals, decide on every rank from the same data,
        write back the owned subdiagonal entries.  Returns the (n,) updated
        subdiagonal (last entry 0), as ``DenseExtent`` does."""
        d, sub, _sup = self.diagonals((Spad,), P, n)[0]
        newsub = negligible_zeroed(d, sub[:n - 1], ihi, thresh)
        a, b = max(P, self.base), min(P + n - 1, self.end)
        if a < b:
            torch.diagonal(Spad[a + 1:b + 1, a - self.base:b - self.base]).copy_(
                newsub[a - P:b - P])
        return torch.cat([newsub, newsub.new_zeros(1)])

    def rot_col_pairs(self, items, cols):
        """``DenseExtent.rot_col_pairs`` on the own columns; a pair (j,
        j+1) across a cut exchanges its two columns of every matrix in one
        all_reduce, and each of its two ranks writes its own column."""
        js = cols.tolist()
        cross = set(self.cuts[1:-1])
        own = [k for k, j in enumerate(js) if self.base <= j and j + 1 < self.end]
        if own:
            kk = torch.tensor(own, device=cols.device)
            DenseExtent.rot_col_pairs([(M, c[kk], s[kk]) for M, c, s in items],
                                      cols[kk] - self.base)
        pairs = [(k, j) for k, j in enumerate(js) if j + 1 in cross]
        if not pairs:
            return
        rows = [M.shape[0] for M, _c, _s in items]
        buf = items[0][0].new_zeros((len(pairs), 2, sum(rows)))
        for q, (_k, j) in enumerate(pairs):
            for e in (0, 1):
                if self.base <= j + e < self.end:
                    buf[q, e] = torch.cat([M[:, j + e - self.base]
                                           for M, _c, _s in items])
        self._reduce(buf)
        for q, (k, j) in enumerate(pairs):
            x0s, x1s = buf[q, 0].split(rows), buf[q, 1].split(rows)
            for (M, c, s), x0, x1 in zip(items, x0s, x1s):
                if self.base <= j < self.end:
                    M[:, j - self.base] = c[k] * x0 + s[k] * x1
                if self.base <= j + 1 < self.end:
                    M[:, j + 1 - self.base] = -s[k] * x0 + c[k] * x1

    def window(self, fn, *inputs):
        """fn(*inputs) on rank 0; its outputs on every rank."""
        return owner_call(self.mesh, fn, *inputs, stats=self.stats)


def _to(x, mesh: Mesh):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(mesh.device, torch.float64)


def check_shard(M, n: int, mesh: Mesh, name: str, rows: Optional[int] = None):
    """M (moved to the mesh's device) after checking that it is this
    rank's column shard of an (rows, n) matrix (rows default n)."""
    lo, hi = shard_range(n, mesh.size, mesh.rank)
    want = (n if rows is None else rows, hi - lo)
    M = _to(M, mesh)
    if tuple(M.shape) != want:
        raise ValueError(f"{name}: rank {mesh.rank} holds a shard of shape "
                         f"{tuple(M.shape)}, not {want}")
    return M


def eye_cols(n: int, mesh: Mesh, dtype=torch.float64):
    """This rank's column shard of the (n, n) identity."""
    lo, hi = shard_range(n, mesh.size, mesh.rank)
    out = torch.zeros((n, hi - lo), dtype=dtype, device=mesh.device)
    out[lo:hi] = torch.eye(hi - lo, dtype=dtype, device=mesh.device)
    return out


def padded_shard(M, cuts, rank: int, rows: int, r0: int, c0: int, lo: int):
    """This rank's (rows, cuts[rank+1] - cuts[rank]) shard of the padded
    buffer that holds a column-sharded matrix at (r0, c0): M, this rank's
    shard of it (first column lo), at its rows and columns, zeros
    elsewhere."""
    out = M.new_zeros((rows, cuts[rank + 1] - cuts[rank]))
    off = c0 + lo - cuts[rank]
    out[r0:r0 + M.shape[0], off:off + M.shape[1]] = M
    return out


def inner_shard(Mpad, cuts, rank: int, r0: int, rows: int, c0: int, lo: int,
                hi: int):
    """A copy of this rank's columns [lo, hi) of the (rows, *) matrix held
    in the padded shard Mpad at (r0, c0)."""
    off = c0 + lo - cuts[rank]
    return Mpad[r0:r0 + rows, off:off + hi - lo].clone()


def frobenius(Ms, mesh: Mesh, stats: Optional[dict] = None):
    """[||M||_F of each column-sharded M] on every rank (one all_reduce of
    the shards' sums of squares)."""
    sq = torch.stack([(M * M).sum() for M in Ms])
    return [float(x) for x in all_reduce(sq, mesh, stats).sqrt()]


def gathered(M_loc, n: int, mesh: Mesh, stats: Optional[dict] = None):
    """The whole (rows, n) matrix of the column shards M_loc
    (``DistrMatrix.full``: only for the small problems that the owner
    solves alone)."""
    return DistrMatrix(M_loc, mesh, "cols", (M_loc.shape[0], n)).full(stats)


def shard_diagonals(Ms_loc, mesh: Mesh, stats: Optional[dict] = None):
    """(len(Ms), 3, n) on every rank: the three diagonals of each (n, n)
    matrix of the column shards Ms_loc (one all_reduce of O(n))."""
    n = Ms_loc[0].shape[0]
    ext = ShardedExtent(mesh, stats, split_cuts(n, mesh.size))
    return ext.diagonals(Ms_loc, 0, n)


def schur_dm(H, Q=None, mesh: Optional[Mesh] = None,
             conf: Optional[SchurConf] = None, stats: Optional[dict] = None):
    """Distributed Hessenberg -> Schur: the port's driver on column shards.

    H and Q (default the identity) are this rank's column shards of (n, n)
    matrices (``shard_range``).  The multishift-QR iteration (AED rounds +
    wavefront sweeps, :func:`starneig_tpu_torch.ops.schur._schur_iter`)
    runs on each rank's shard of the padded matrix (:func:`pad_cuts`) with
    a :class:`ShardedExtent`; the 2x2 blocks are standardized on the
    shards (``ops.schur.standardize_blocks_``) and the eigenvalues come
    from the gathered diagonals (reference ``starneig_SEP_DM_Schur``,
    mpi/interface_schur.c).  Up to ``min(small_limit, 300)``, or on one
    rank, rank 0 runs the single-process ``schur`` on the gathered
    matrices and every rank takes its shard of the result.  ``stats``, if
    a dict, receives this rank's collective counts, bytes and seconds, and
    (the AED path) the geometry, the cuts, the padded shard's shape, the
    rounds and ``aed_log``.

    Returns (S, Q, eig_real, eig_imag, info): this rank's column shards of
    S and Q, the eigenvalues whole on every rank.
    """
    from starneig_tpu_torch.ops.eigvals import eigenvalues_from_diagonals
    from starneig_tpu_torch.ops.schur import (_resolve_threshold, _schur_iter,
                                              aed_geometry, schur,
                                              standardize_blocks_)

    mesh = mesh if mesh is not None else make_mesh()
    nd, rank = mesh.size, mesh.rank
    n = _to(H, mesh).shape[0]
    H = check_shard(H, n, mesh, "schur_dm")
    Q = eye_cols(n, mesh) if Q is None else check_shard(Q, n, mesh, "schur_dm")
    conf = (conf or SchurConf()).resolve(n, workers=nd)
    lo, hi = shard_range(n, nd, rank)

    if n <= min(conf.small_limit, 300) or nd == 1:
        Hf, Qf = gathered(H, n, mesh, stats), gathered(Q, n, mesh, stats)
        S, Qo, er, ei, info = owner_call(
            mesh, lambda: schur(Hf, Qf, conf=conf, stats=stats), stats=stats)
        return S[:, lo:hi].clone(), Qo[:, lo:hi].clone(), er, ei, info

    WA, NS, B, WC, TMAX, P = aed_geometry(n, conf)
    NP = n + 2 * P
    cuts = pad_cuts(n, P, nd)
    thresh = _resolve_threshold(H, conf, norm=frobenius((H,), mesh, stats)[0])
    Spad = padded_shard(H, cuts, rank, NP, P, P, lo)
    Qpad = padded_shard(Q, cuts, rank, n, 0, P, lo)
    eyeW = torch.eye(WA, dtype=H.dtype, device=H.device)
    ext = ShardedExtent(mesh, stats, cuts, wmax=max(WA, WC))

    aed_log = []
    ihi, fail, rounds = _schur_iter(
        Spad, Qpad, thresh, eyeW, P=P, WA=WA, NS=NS, B=B, TMAX=TMAX,
        nibble=conf.aed_nibble, itmax=conf.iteration_limit, n=n, log=aed_log,
        ext=ext)
    info = Error.DID_NOT_CONVERGE if (fail or ihi > 0) else Error.SUCCESS
    standardize_blocks_(Spad, Qpad, P, n, ext)
    er, ei = ext.window(eigenvalues_from_diagonals,
                        *ext.diagonals((Spad,), P, n)[0])
    if stats is not None:
        stats.update(path="aed", rounds=rounds, WA=WA, NS=NS, B=B, WC=WC,
                     TMAX=TMAX, P=P, NP=NP, cuts=cuts,
                     shard_shape=tuple(Spad.shape),
                     work_bytes=8 * (Spad.numel() + Qpad.numel()),
                     aed_log=aed_log)
    return (inner_shard(Spad, cuts, rank, P, n, P, lo, hi),
            inner_shard(Qpad, cuts, rank, 0, n, P, lo, hi), er, ei, info)


# ---------------------------------------------------------------------------
# distributed reordering: the wave-parallel window grid of
# ops/reorder.py:reorder_schur_parallel with every matrix access routed
# through the sharded extent (reference: src/mpi/interface_reorder.c)
# ---------------------------------------------------------------------------

def reorder_dm(S, Q, select, mesh: Optional[Mesh] = None,
               conf: Optional[ReorderConf] = None,
               stats: Optional[dict] = None):
    """Distributed reordering: wave-parallel disjoint windows on column
    shards (JAX ``dm_core.reorder_dm``, decision for decision).

    S and Q are this rank's column shards of (n, n) matrices.  Each pass
    gathers its windows with one masked all_reduce; rank 0 bubbles them
    (``ops/reorder.window_bubble_batch``: the bubble kernel on the card)
    and broadcasts the windows, their transforms, the selections and the
    counters; each rank applies the transforms to its shards (row strips
    locally, each window's column panels of S and Q through one masked
    all_reduce) and
    the subdiagonal is gathered for the host's plan.  The windows lie
    inside the matrix, so the shards need no padding.  Small problems
    (n < 2W) and stragglers (after 8 (n / (W/2) + 2) passes) take one
    window a pass; a stall past twice that gives up with
    PARTIAL_REORDERING.  ``stats``, if a dict, receives the collective
    counts and the passes, windows, swaps and failed swaps.

    Returns (S, Q, num_selected, info), S and Q this rank's column shards.
    """
    from starneig_tpu_torch.ops.reorder import (_align_select, _as_host_bool,
                                                _count, _prefix_len,
                                                window_bubble_batch)

    mesh = mesh if mesh is not None else make_mesh()
    nd = mesh.size
    n = _to(S, mesh).shape[0]
    Sp = check_shard(S, n, mesh, "reorder_dm").clone()
    Qp = check_shard(Q, n, mesh, "reorder_dm").clone()
    ext = ShardedExtent(mesh, stats, split_cuts(n, nd))

    def host_subdiag():
        return ext.diagonals((Sp,), 0, n)[0, 1].cpu().numpy()

    subdiag = host_subdiag()
    sel = _align_select(subdiag, _as_host_bool(select))
    ratio = float(sel.sum()) / max(n, 1)
    rconf = (conf or ReorderConf()).resolve(n, workers=nd, select_ratio=ratio)
    W = min(rconf.window_size, n)
    ext.wmax = W
    GMAX = 1 if n < 2 * W else (n + W - 1) // W

    total_fail = 0
    offset_toggle = 0
    guard = 0
    seq_mode = False
    while True:
        m = _prefix_len(subdiag, sel)
        below = np.nonzero(sel[m:n])[0]
        if below.size == 0:
            break
        guard += 1
        if guard > 16 * (n // max(W // 2, 1) + 2):
            log.warning(
                "reorder_dm: window passes stalled after %d rounds (n=%d, "
                "W=%d, %d selected not yet in the leading block): giving up "
                "with PARTIAL_REORDERING", guard, n, W, int(sel[m:n].sum()))
            total_fail += 1
            break
        _count(stats, passes=1)
        tail_batch = []
        if n < 2 * W or seq_mode:
            # sequential window chain (small problems / stragglers)
            lowest = m + int(below[-1])
            bsz = 2 if subdiag[lowest] != 0 else 1
            if lowest > 0 and subdiag[lowest - 1] != 0:
                lowest, bsz = lowest - 1, 2
            ws_list = [min(max(m, lowest + bsz - W), n - W)]
        else:
            start = m + (offset_toggle * (W // 2))
            offset_toggle ^= 1
            ws_list = list(range(start, n - W + 1, W))
            if not ws_list:
                ws_list = [n - W]
            elif ws_list[-1] + W < n:
                # the leftover past the last disjoint window is < W; the
                # overlapping n-W window runs as its own second batch
                tail_batch = [n - W]
        for group in [ws_list[:GMAX]] + ([tail_batch] if tail_batch else []):
            wlo = [1 if (w0 > 0 and subdiag[w0 - 1] != 0) else 0 for w0 in group]
            wlim = [W - 1 if (w0 + W < n and subdiag[w0 + W - 1] != 0) else W
                    for w0 in group]
            sels = np.stack([sel[w0:w0 + W] for w0 in group])
            Tws = ext.get_diag_blocks(Sp, group, W)
            Tw2, Qw2, sel2, _dsts, nfails, nsw = ext.window(
                window_bubble_batch, Tws, sels, wlo, wlim, wlim)
            ext.mul_rows_batch(Sp, group, W, Qw2)
            ext.mul_cols_batch((Sp, Qp), group, W, Qw2)
            ext.set_diag_blocks(Sp, Tw2, group)
            total_fail += int(nfails.sum())
            _count(stats, windows=len(group), swaps=nsw.sum(),
                   failed_swaps=nfails.sum())
            for g, w0 in enumerate(group):
                sel[w0:w0 + W] = sel2[g]
            subdiag = host_subdiag()
        if guard > 8 * (n // max(W // 2, 1) + 2):
            seq_mode = True

    m = _prefix_len(subdiag, sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    if stats is not None:
        stats.update(W=W, NP=n, shard_shape=tuple(Sp.shape),
                     work_bytes=8 * (Sp.numel() + Qp.numel()))
    return Sp, Qp, m, info
