"""Distributed-memory Schur reduction and reordering on column shards.

Port of ``starneig_tpu/parallel/dm_core.py``.  The reference's DM layer
reruns the *same* task-insertion core with MPI (reference
``src/mpi/interface_schur.c:53-120``, window tasks owner-executed
``src/schur/core.c:1498-1545``).  Here the port's own driver,
:func:`starneig_tpu_torch.ops.schur._schur_iter`, routes every access to
the padded matrix through an extent strategy, and :class:`ShardedExtent`
carries those accesses out on column shards, one shard a rank, with
explicit collectives (``parallel/distr.py``):

  * row-strip updates (``mul_rows``/``mul_rows_batch``) are shard-local:
    each rank updates the rows of its own columns;
  * column panels (``mul_cols``/``mul_cols_batch``) and block reads
    (``get_block``/``get_diag_blocks``) are gathered by ONE masked
    ``all_reduce``: each rank adds the columns it owns and zeros elsewhere,
    so every rank holds bit-identical panels; each rank writes back only
    the columns it owns;
  * ``zero_negligible`` gathers the diagonal and subdiagonal once and
    writes back the owned subdiagonal entries;
  * the window math (``window``: an AED round's window solve, spike
    deflation, status read and recondense; a sweep's train hops; a
    reordering pass's window bubble) runs on rank 0 alone, which
    broadcasts its outputs.  The JAX package replicates that math on every
    shard, cheaper on a TPU mesh.  Here ranks may share one card, where
    replicas would launch B2-B5 once a rank, and a replica that rounded
    differently would steer its host loop apart from the others: a hang,
    or a silently wrong matrix.  With one owner and a broadcast every rank
    takes the same decisions by construction.

Offsets are host ints (the port's driver is a host loop), so a panel's
overlap with a shard is index arithmetic on the host, with no masked
blend of clamped dynamic slices.  The (NP, NP) padded matrix splits into
(NP, C) column blocks, C = NP / nshards, with NP padded so that C divides
evenly and C >= every window width, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.config import ReorderConf, SchurConf
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.node import log
from starneig_tpu_torch.ops.schur import DenseExtent, negligible_zeroed
from starneig_tpu_torch.parallel.distr import (Mesh, all_reduce, make_mesh,
                                               owner_call)


class ShardedExtent:
    """Extent ops on this rank's (rows, C) column shard of the padded
    buffers: shard d owns global columns [d*C, (d+1)*C).  Same methods and
    in-place semantics as ``DenseExtent``; every gather is a collective,
    so every rank calls every op in the same order."""

    def __init__(self, mesh: Mesh, stats: Optional[dict] = None):
        self.mesh, self.stats = mesh, stats

    def _owned(self, S, j0: int, w: int):
        """(lo, hi, p0): this shard's local columns [lo, hi) are the panel
        columns [p0, p0 + hi - lo) of the global columns [j0, j0 + w)."""
        C = S.shape[1]
        base = self.mesh.rank * C
        a, b = max(j0, base), min(j0 + w, base + C)
        return a - base, max(a, b) - base, a - j0

    def _reduce(self, t):
        return all_reduce(t, self.mesh, self.stats)

    # rows are unsharded under column sharding: fully local
    mul_rows = staticmethod(DenseExtent.mul_rows)
    mul_rows_batch = staticmethod(DenseExtent.mul_rows_batch)

    def get_block(self, S, i0: int, j0: int, h: int, w: int):
        """S[i0:i0+h, j0:j0+w] on every rank (one masked all_reduce)."""
        out = S.new_zeros((h, w))
        lo, hi, p0 = self._owned(S, j0, w)
        out[:, p0:p0 + hi - lo] = S[i0:i0 + h, lo:hi]
        return self._reduce(out)

    def set_block(self, S, M, i0: int, j0: int):
        """Write the columns of M (placed at global (i0, j0)) this shard
        owns."""
        lo, hi, p0 = self._owned(S, j0, M.shape[1])
        S[i0:i0 + M.shape[0], lo:hi] = M[:, p0:p0 + hi - lo]

    def mul_cols(self, S, j0: int, w: int, Qw):
        panel = self.get_block(S, 0, j0, S.shape[0], w)
        lo, hi, _p0 = self._owned(S, j0, w)
        if hi > lo:
            self.set_block(S, panel @ Qw, 0, j0)

    def get_diag_blocks(self, S, ws, w: int):
        out = S.new_zeros((len(ws), w, w))
        for g, s in enumerate(ws):
            lo, hi, p0 = self._owned(S, s, w)
            out[g, :, p0:p0 + hi - lo] = S[s:s + w, lo:hi]
        return self._reduce(out)

    def set_diag_blocks(self, S, Ms, ws):
        for g, s in enumerate(ws):
            self.set_block(S, Ms[g], s, s)

    def mul_cols_batch(self, S, ws, w: int, Qws):
        panels = S.new_zeros((len(ws), S.shape[0], w))
        for g, s in enumerate(ws):
            lo, hi, p0 = self._owned(S, s, w)
            panels[g, :, p0:p0 + hi - lo] = S[:, lo:hi]
        self._reduce(panels)
        for g, s in enumerate(ws):
            lo, hi, _p0 = self._owned(S, s, w)
            if hi > lo:
                self.set_block(S, panels[g] @ Qws[g], 0, s)

    def diagonals(self, S, p: int, n: int):
        """(2, n) on every rank: the diagonal and the subdiagonal (last
        entry 0) of the global block S[p:p+n, p:p+n]."""
        C = S.shape[1]
        base = self.mesh.rank * C
        out = S.new_zeros((2, n))
        a, b = max(p, base), min(p + n, base + C)
        if a < b:
            out[0, a - p:b - p] = torch.diagonal(S[a:b, a - base:b - base])
        b1 = min(b, p + n - 1)
        if a < b1:
            out[1, a - p:b1 - p] = torch.diagonal(S[a + 1:b1 + 1, a - base:b1 - base])
        return self._reduce(out)

    def zero_negligible(self, Spad, P: int, n: int, ihi: int, thresh: float):
        """Sharded negligible-subdiagonal zeroing (JAX dm_core.py:173-208):
        gather the diagonals, decide on every rank from the same data,
        write back the owned subdiagonal entries.  Returns the (n,)
        updated subdiagonal (last entry 0), as ``DenseExtent`` does."""
        dsub = self.diagonals(Spad, P, n)
        newsub = negligible_zeroed(dsub[0], dsub[1, :n - 1], ihi, thresh)
        C = Spad.shape[1]
        base = self.mesh.rank * C
        a, b = max(P, base), min(P + n - 1, base + C)
        if a < b:
            torch.diagonal(Spad[a + 1:b + 1, a - base:b - base]).copy_(
                newsub[a - P:b - P])
        return torch.cat([newsub, newsub.new_zeros(1)])

    def window(self, fn, *inputs):
        """fn(*inputs) on rank 0; its outputs on every rank."""
        return owner_call(self.mesh, fn, *inputs, stats=self.stats)


def make_sharded_extent(mesh: Mesh, stats: Optional[dict] = None):
    """The sharded extent strategy over mesh's ranks; its collectives
    count into ``stats``."""
    return ShardedExtent(mesh, stats)


def _to(x, mesh: Mesh):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(mesh.device, torch.float64)


def _padded_shards(M, mesh: Mesh, rows: int, NP: int, r0: int, c0: int):
    """This rank's (rows, NP / size) column shard of the (rows, NP) buffer
    holding M at (r0, c0), zeros elsewhere."""
    C = NP // mesh.size
    base = mesh.rank * C
    out = M.new_zeros((rows, C))
    a, b = max(c0, base), min(c0 + M.shape[1], base + C)
    if a < b:
        out[r0:r0 + M.shape[0], a - base:b - base] = M[:, a - c0:b - c0]
    return out


def _gather_inner(Spad, Qpad, mesh: Mesh, r0: int, c0: int, n: int,
                  stats: Optional[dict]):
    """(S, Q) on every rank: the (n, n) blocks of the shards at (r0, c0)
    and (0, c0), gathered by one all_reduce."""
    C = Spad.shape[1]
    base = mesh.rank * C
    both = Spad.new_zeros((2, n, n))
    a, b = max(c0, base), min(c0 + n, base + C)
    if a < b:
        both[0, :, a - c0:b - c0] = Spad[r0:r0 + n, a - base:b - base]
        both[1, :, a - c0:b - c0] = Qpad[:, a - base:b - base]
    all_reduce(both, mesh, stats)
    return both[0], both[1]


def schur_dm(H, Q=None, mesh: Optional[Mesh] = None,
             conf: Optional[SchurConf] = None, stats: Optional[dict] = None):
    """Distributed Hessenberg -> Schur: the port's driver on column shards.

    H and Q (default the identity) are whole (n, n) matrices, the same on
    every rank.  The multishift-QR iteration (AED rounds + wavefront
    sweeps, :func:`starneig_tpu_torch.ops.schur._schur_iter`) runs on each
    rank's column shard of the padded matrix with a :class:`ShardedExtent`
    (reference ``starneig_SEP_DM_Schur``, mpi/interface_schur.c).  Up to
    ``min(small_limit, 300)``, or on one rank, rank 0 runs the
    single-process ``schur`` and broadcasts its result.  ``stats``, if a
    dict, receives this rank's collective counts, bytes and seconds, and
    (the AED path) the geometry, the shard shape, the rounds and
    ``aed_log``.

    Returns (S, Q, eig_real, eig_imag, info), the whole matrices on every
    rank (gathered, then standardized).
    """
    from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
    from starneig_tpu_torch.ops.schur import (_resolve_threshold, _schur_iter,
                                              aed_geometry, schur,
                                              standardize_blocks)

    mesh = mesh if mesh is not None else make_mesh()
    nd = mesh.size
    H = _to(H, mesh)
    n = H.shape[0]
    Q = torch.eye(n, dtype=H.dtype, device=H.device) if Q is None else _to(Q, mesh)
    conf = (conf or SchurConf()).resolve(n, workers=nd)

    if n <= min(conf.small_limit, 300) or nd == 1:
        return owner_call(mesh, lambda: schur(H, Q, conf=conf, stats=stats),
                          stats=stats)

    # geometry as in the single-process driver, with the padding grown so
    # shards divide evenly and each is at least one window wide
    WA, NS, B, WC, TMAX, P = aed_geometry(n, conf)
    NP = -(-(n + 2 * P) // nd) * nd
    while NP // nd < max(WA, WC):
        NP += nd
    P = (NP - n) // 2  # left pad (right pad NP - n - P >= P)

    thresh = owner_call(mesh, _resolve_threshold, H, conf, stats=stats)
    Spad = _padded_shards(H, mesh, NP, NP, P, P)
    Qpad = _padded_shards(Q, mesh, n, NP, 0, P)
    eyeW = torch.eye(WA, dtype=H.dtype, device=H.device)

    aed_log = []
    ihi, fail, rounds = _schur_iter(
        Spad, Qpad, thresh, eyeW, P=P, WA=WA, NS=NS, B=B, TMAX=TMAX,
        nibble=conf.aed_nibble, itmax=conf.iteration_limit, n=n, log=aed_log,
        ext=make_sharded_extent(mesh, stats))
    info = Error.DID_NOT_CONVERGE if (fail or ihi > 0) else Error.SUCCESS
    if stats is not None:
        stats.update(path="aed", rounds=rounds, WA=WA, NS=NS, B=B, WC=WC,
                     TMAX=TMAX, P=P, NP=NP, shard_shape=tuple(Spad.shape),
                     aed_log=aed_log)

    S, Qf = _gather_inner(Spad, Qpad, mesh, P, P, n, stats)
    S, Qf = standardize_blocks(S, Qf)
    er, ei = extract_eigenvalues(S)
    return S, Qf, er, ei, info


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

    S and Q are whole (n, n) matrices, the same on every rank.  Each pass
    gathers its windows with one masked all_reduce; rank 0 bubbles them
    (``ops/reorder.window_bubble_batch``: the bubble kernel on the card)
    and broadcasts the windows, their transforms, the selections and the
    counters; each rank applies the transforms to its shards (row strips
    locally, column panels through one masked all_reduce) and the
    subdiagonal is gathered for the host's plan.  Small problems (n < 2W)
    and stragglers (after 8 (n / (W/2) + 2) passes) take one window a
    pass; a stall past twice that gives up with PARTIAL_REORDERING.
    ``stats``, if a dict, receives the collective counts and the passes,
    windows, swaps and failed swaps.

    Returns (S, Q, num_selected, info), the whole matrices on every rank.
    """
    from starneig_tpu_torch.ops.reorder import (_align_select, _as_host_bool,
                                                _count, _prefix_len,
                                                window_bubble_batch)

    mesh = mesh if mesh is not None else make_mesh()
    nd = mesh.size
    S, Q = _to(S, mesh), _to(Q, mesh)
    n = S.shape[0]

    subdiag = np.concatenate([torch.diagonal(S, -1).cpu().numpy(), [0.0]])
    sel = _align_select(subdiag, _as_host_bool(select))
    ratio = float(sel.sum()) / max(n, 1)
    rconf = (conf or ReorderConf()).resolve(n, workers=nd, select_ratio=ratio)
    W = min(rconf.window_size, n)

    # shard-divisible padding, each shard at least one window wide
    NP = -(-(n + W) // nd) * nd
    while NP // nd < W:
        NP += nd
    Sp = _padded_shards(S, mesh, NP, NP, 0, 0)
    Qp = _padded_shards(Q, mesh, n, NP, 0, 0)
    ext = make_sharded_extent(mesh, stats)
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
            ext.mul_cols_batch(Sp, group, W, Qw2)
            ext.set_diag_blocks(Sp, Tw2, group)
            ext.mul_cols_batch(Qp, group, W, Qw2)
            total_fail += int(nfails.sum())
            _count(stats, windows=len(group), swaps=nsw.sum(),
                   failed_swaps=nfails.sum())
            for g, w0 in enumerate(group):
                sel[w0:w0 + W] = sel2[g]
            subdiag = ext.diagonals(Sp, 0, n)[1].cpu().numpy()
        if guard > 8 * (n // max(W // 2, 1) + 2):
            seq_mode = True

    m = _prefix_len(subdiag, sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    S_out, Q_out = _gather_inner(Sp, Qp, mesh, 0, 0, n, stats)
    if stats is not None:
        stats.update(W=W, NP=NP, shard_shape=tuple(Sp.shape))
    return S_out, Q_out, m, info
