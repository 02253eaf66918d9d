"""Distributed-memory eigenvectors (SEP and GEP) on column shards.

The JAX package runs ``ops/eigenvectors.py``'s single-process programs on
arrays placed with a ``NamedSharding`` and lets XLA's SPMD partitioner
split them; the reference leaves DM eigenvectors unimplemented
(``sep_dm.h:232-238``, ``gep_dm.h``).  Here the backsolve runs as a
right-to-left pipeline over column shards, LAPACK dtrevc3's right-looking
form split along the cuts:

  * the selected blocks and the row kinds come from the gathered
    diagonals (``dm_core.shard_diagonals``, O(n)), ||S||_max (and ||T||_max)
    from one small all_reduce;
  * rank r solves the rows [e_r, e_{r+1}) of every vector whose block
    starts at or right of e_r: E1 (E2 for a pencil) on the card, their
    plain twins on the CPU, on the diagonal block of its shard.  e_r is its
    first column, or the next one where a 2x2 block straddles the cut: the
    rank left of the cut solves the block, with the straddling column of
    each matrix (one column, fetched once);
  * it starts from the far sum F, the product of the rows [e_r, e_{r+1})
    with the entries solved right of them ((beta S - alpha T) X for a
    pencil), which the rank on its right hands over; the kernel adds F to
    its own far products, scaled with the vector as it goes, and returns
    each vector's product of scalings.  The rank then adds its own columns'
    product with the rows above (``torch.matmul``) to F, scaled so too,
    and hands F to the rank on its left, in messages of at most
    ``EIG_PANEL // 2`` vectors (Re and Im: one n x EIG_PANEL panel);
  * a scaling on rank r must also reach the entries solved on the ranks to
    its right (dtrevc3 scales the whole vector): after the pipeline one
    all_reduce of the (m,) scale products lets each rank rescale, and the
    two-stage normalization takes its max and its 2-norm by one all_reduce
    each;
  * X = Q Y (Z Y for a pencil): each rank multiplies its columns of Q by
    its rows of Y, and the sums reach X's shards in column blocks of
    EIG_PANEL, one masked all_reduce each.

No rank holds a whole matrix: the messages are O(n) (the diagonals, the
straddling columns, the scale products) and panels of n x EIG_PANEL.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import eigenvectors as ev
from starneig_tpu_torch.ops import gpu_eig
from starneig_tpu_torch.parallel.distr import (Mesh, all_reduce, broadcast,
                                               shard_range)
from starneig_tpu_torch.parallel.dm_core import (_to, check_shard,
                                                 shard_diagonals, split_cuts)

EIG_PANEL = 64          # columns of a message: F's vectors (Re, Im), X's blocks


def _ranks_rows(x, mesh: Mesh, stats):
    """(size, *x.shape): every rank's x, by one all_reduce."""
    buf = x.new_zeros((mesh.size,) + tuple(x.shape))
    buf[mesh.rank] = x
    return all_reduce(buf, mesh, stats)


def flex_spec(n: int, ncols: int, size: int) -> str:
    """The finest sharding an (n, ncols) result allows: cols, rows, or
    replicated."""
    if ncols % size == 0:
        return "cols"
    if n % size == 0:
        return "rows"
    return "replicated"


def eigen_cuts(n: int, size: int, kind):
    """Each rank's first row of the backsolve (and n): its first column,
    or the next one where the cut would split a 2x2 block (kind 2)."""
    return [c + 1 if 0 < c < n and kind[c] == 2 else c
            for c in split_cuts(n, size)]


class _Problem:
    """The eigenvalues of the selection, from the gathered diagonals: the
    SEP's (lambda) or the pencil's (alpha, beta), their start entries and
    their far sums."""

    def __init__(self, mats, select, mesh: Mesh, stats):
        self.gep = len(mats) == 2
        n = mats[0].shape[0]
        dev = mats[0].device
        d = shard_diagonals(mats, mesh, stats)        # (k, 3, n) on the device
        self.d = d
        dh = d.cpu().numpy()
        finfo = torch.finfo(torch.float64)
        self.smlnum = finfo.tiny / finfo.eps
        as_t = dict(dtype=torch.float64, device=dev)
        if self.gep:
            entries = ev._selected_blocks_gep_from_diagonals(dh[0], dh[1], select)
        else:
            entries = ev._selected_blocks_from_diagonals(*dh[0], select)
        self.m = len(entries)
        self.kind = ev._row_kinds(dh[0][1])
        if not entries:
            return
        cols = list(zip(*entries))
        self.pos = np.asarray(cols[0], np.int64)
        self.pair = np.asarray(cols[1], bool)
        self.vals = [torch.tensor(list(v), **as_t) for v in cols[2:]]
        mx = _ranks_rows(torch.stack([M.abs().max() if M.numel() else d.new_zeros(())
                                      for M in mats]), mesh, stats).amax(0)
        norm = (mx[0] + mx[1] if self.gep else mx[0]) + self.smlnum
        self.omega = finfo.max / (16.0 * n) / norm
        self.smin = torch.clamp_min(finfo.eps * sum(v.abs() for v in self.vals),
                                    self.smlnum)

    def start(self, ids, e0: int, w: int, xr, xi):
        """The start entries of the vectors ids whose block lies in the rows
        [e0, e0 + w), as ``_backsolve_inputs`` (``_gep``) places them."""
        pos = self.pos[ids]
        here = np.nonzero(pos < e0 + w)[0]
        if not len(here):
            return
        dev = xr.device
        p = torch.as_tensor(pos[here], device=dev)
        n = self.d.shape[2]
        p1 = torch.clamp_max(p + 1, n - 1)
        rows = torch.as_tensor(here, device=dev)
        pair = torch.as_tensor(self.pair[ids][here], device=dev)
        vals = [v[torch.as_tensor(ids[here], device=dev)] for v in self.vals]
        if self.gep:
            dS, dT = self.d
            w0r, w0i, w1r, w1i = ev._start_gep(*vals, dS[0][p], dS[2][p], dS[1][p],
                                               dS[0][p1], dT[0][p], dT[2][p], dT[0][p1])
            xr[rows, p - e0] = torch.where(pair, w0r, 1.0)
            xi[rows, p - e0] = torch.where(pair, w0i, 0.0)
            pr, pp = rows[pair], (p1 - e0)[pair]
            xr[pr, pp] += w1r[pair]
            xi[pr, pp] += w1i[pair]
        else:
            xr[rows, p - e0] = torch.where(pair, self.d[0, 2][p], 1.0)
            xi[rows[pair], (p1 - e0)[pair]] += vals[1][pair]

    def solve(self, blocks, ids, e0: int, w: int, xr, xi, f0, scale):
        """The backsolve of the rows [e0, e0 + w) for the vectors ids, in
        place: E1 or E2 on the card, their twins on the CPU."""
        dev = xr.device
        sel = torch.as_tensor(ids, device=dev)
        vals = [v[sel] for v in self.vals]
        pos = np.minimum(self.pos[ids] - e0, w)
        args = (pos, self.pair[ids], self.kind[e0:e0 + w], self.smin[sel], self.omega,
                self.smlnum, xr, xi)
        kw = dict(scale=scale)
        if f0 is not None:
            kw.update(f0r=f0[0], f0i=f0[1])
        if self.gep:
            run = gpu_eig.backsolve_gep if xr.is_cuda else ev._backsolve_rows_gep
        else:
            run = gpu_eig.backsolve if xr.is_cuda else ev._backsolve_rows
        return run(*blocks, *vals, *args, **kw)

    def far(self, ups, ids, xr, xi):
        """(2, len(ids), rows): the sums of the rows ``ups`` (S's, and T's
        for a pencil, over this rank's columns) with the vectors' entries
        here: S x, or (beta S - alpha T) x."""
        if not self.gep:
            S = ups[0]
            return torch.stack((xr @ S.T, xi @ S.T))
        S, T = ups
        sel = torch.as_tensor(ids, device=xr.device)
        ar, ai, bt = (v[sel][:, None] for v in self.vals)
        sr, si, tr, ti = xr @ S.T, xi @ S.T, xr @ T.T, xi @ T.T
        return torch.stack((bt * sr - ar * tr + ai * ti, bt * si - ar * ti - ai * tr))


def _effective(Ms, cuts, ecuts, mesh: Mesh, stats):
    """Each M's columns [e_r, e_{r+1}) on this rank: its own from e_r on,
    and the straddling column past its shard where the next rank's range
    starts one later (fetched by one masked all_reduce for all cuts; then
    the columns are a copy)."""
    P, r = mesh.size, mesh.rank
    shifted = [s for s in range(1, P) if ecuts[s] != cuts[s]]
    extra = None
    if shifted:
        n = Ms[0].shape[0]
        buf = Ms[0].new_zeros((len(shifted), len(Ms), n))
        if r in shifted:
            buf[shifted.index(r)] = torch.stack([M[:, 0] for M in Ms])
        all_reduce(buf, mesh, stats)
        if r + 1 in shifted:
            extra = buf[shifted.index(r + 1)]
    lo = cuts[r]
    out = []
    for k, M in enumerate(Ms):
        E = M[:, ecuts[r] - lo:]
        if extra is not None:
            E = torch.cat([E, extra[k][:, None]], 1)
        out.append(E)
    return out


class _Clock:
    """Host seconds by phase, the device's queue drained at each mark."""

    def __init__(self, dev):
        self.dev, self.s = dev, {}
        self.t = self._now()

    def _now(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def mark(self, name):
        t = self._now()
        self.s[name] = self.s.get(name, 0.0) + t - self.t
        self.t = t


def _eigenvectors_dm(mats, back, select, mesh: Mesh, stats: Optional[dict]):
    clock = _Clock(mesh.device)
    n = _to(mats[0], mesh).shape[0]
    mats = [check_shard(M, n, mesh, "eigenvectors_dm") for M in mats]
    back = check_shard(back, n, mesh, "eigenvectors_dm")
    P, r = mesh.size, mesh.rank
    dev = mats[0].device
    prob = _Problem(mats, select, mesh, stats)
    if prob.m == 0:
        spec = flex_spec(n, 0, P)
        return mats[0].new_zeros((n, 0)), spec, (n, 0), Error.SUCCESS
    m = prob.m
    cuts = split_cuts(n, P)
    ecuts = eigen_cuts(n, P, prob.kind)
    e0, e1 = ecuts[r], ecuts[r + 1]
    w = e1 - e0
    *eff, beff = _effective(mats + [back], cuts, ecuts, mesh, stats)
    clock.mark("inputs")
    # the vectors with rows on each rank: block at or right of its first row
    idx = [np.nonzero(prob.pos >= ecuts[s])[0] for s in range(P)]
    G = EIG_PANEL // 2
    mine = idx[r]
    xr = mats[0].new_zeros((len(mine), w))
    xi = torch.zeros_like(xr)
    sc = mats[0].new_ones(len(mine))
    close = torch.zeros(len(mine), dtype=torch.bool, device=dev)
    F_in = None
    if r < P - 1 and len(idx[r + 1]):
        F_in = mats[0].new_zeros((2, len(idx[r + 1]), e1))
    for s in range(P - 1, -1, -1):
        ids = idx[s]
        F_out = None
        if r == s and len(ids):
            inner = None
            if F_in is not None:
                inner = np.searchsorted(ids, idx[s + 1])
            if w:
                prob.start(ids, e0, w, xr, xi)
                f0 = None
                if inner is not None:
                    f0 = xr.new_zeros((2, len(ids), w))
                    f0[:, inner] = F_in[:, :, e0:e1]
                    f0 = f0.contiguous()
                blocks = [M[e0:e1].contiguous() for M in eff]
                close = prob.solve(blocks, ids, e0, w, xr, xi, f0, sc)
            if s > 0 and e0 > 0:
                F_out = prob.far([M[:e0] for M in eff], ids, xr, xi)
                if inner is not None:
                    F_out[:, inner] += sc[inner][:, None] * F_in[:, :, :e0]
        if s > 0 and len(ids) and ecuts[s] > 0:
            # hand F to the rank on the left, at most G vectors a message
            for g0 in range(0, len(ids), G):
                g1 = min(g0 + G, len(ids))
                buf = F_out[:, g0:g1].contiguous() if r == s else \
                    mats[0].new_empty((2, g1 - g0, ecuts[s]))
                broadcast(buf, mesh, src=s, stats=stats)
                if r == s - 1:
                    F_in[:, g0:g1] = buf
    F_in = None
    clock.mark("pipeline")
    # each vector's scalings: the ranks left of this one scale its entries
    buf = mats[0].new_zeros((P + 1, m))
    buf[r] = 1.0
    sel = torch.as_tensor(mine, device=dev)
    if len(mine):
        buf[r, sel] = sc
        buf[P, sel] = close.to(buf.dtype)
    # the products on the host: a rank's first torch.prod on the card took
    # 1.6 s on an H100, eight times the rest of the stage
    bh = all_reduce(buf, mesh, stats).cpu()
    if r and len(mine):
        fac = bh[:r].prod(0)[torch.as_tensor(mine)].to(dev)
        xr *= fac[:, None]
        xi *= fac[:, None]
    close_all = (bh[P] > 0).numpy()
    # the two-stage normalization: by max |x|, then to unit 2-norm
    mx = xr.new_zeros(m)
    if len(mine) and w:
        mx[sel] = torch.maximum(xr.abs().amax(1), xi.abs().amax(1))
    mx = _ranks_rows(mx, mesh, stats).amax(0)
    mx = torch.where(mx == 0, 1.0, mx)
    xr, xi = xr / mx[sel][:, None], xi / mx[sel][:, None]
    nrm = xr.new_zeros(m)
    if len(mine):
        nrm[sel] = (xr * xr).sum(1) + (xi * xi).sum(1)
    nrm = torch.sqrt(all_reduce(nrm, mesh, stats))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    xr, xi = xr / nrm[sel][:, None], xi / nrm[sel][:, None]
    clock.mark("scale_normalize")
    # X = Q Y: each rank its columns' product, summed in blocks of columns
    yr, yi = xr.new_zeros((m, w)), xr.new_zeros((m, w))
    if len(mine):
        yr[sel], yi[sel] = xr, xi
    Y = ev._columns(yr, yi, prob.pair)
    ncols = Y.shape[1]
    spec = flex_spec(n, ncols, P)
    if spec == "cols":
        c_lo, c_hi = shard_range(ncols, P, r)
        X = Y.new_empty((n, c_hi - c_lo))
    elif spec == "rows":
        r_lo, r_hi = shard_range(n, P, r)
        X = Y.new_empty((r_hi - r_lo, ncols))
    else:
        X = Y.new_empty((n, ncols))
    for b0 in range(0, ncols, EIG_PANEL):
        b1 = min(b0 + EIG_PANEL, ncols)
        part = all_reduce((beff @ Y[:, b0:b1]).contiguous(), mesh, stats)
        if spec == "cols":
            a, b = max(b0, c_lo), min(b1, c_hi)
            if b > a:
                X[:, a - c_lo:b - c_lo] = part[:, a - b0:b - b0]
        elif spec == "rows":
            X[:, b0:b1] = part[r_lo:r_hi]
        else:
            X[:, b0:b1] = part
    clock.mark("back_transform")
    if stats is not None:
        # the copies: the effective columns where one was fetched, the
        # diagonal blocks, x and its start sums, F received, Y
        copies = (len(eff) + 1) * n * w if e1 > cuts[r + 1] else 0
        n_in = len(idx[r + 1]) if r < P - 1 else 0
        stats.update(NP=n, eig_rows=w, eig_vectors=int(len(mine)) if w else 0,
                     eig_cuts=ecuts, close=close_all.tolist(),
                     scale_min=float(sc.min()) if len(mine) else 1.0,
                     eig_phase_s=clock.s,
                     work_bytes=8 * (copies + len(eff) * w * w + 4 * len(mine) * w
                                     + 2 * n_in * e1 + 2 * m * w))
    info = Error.CLOSE_EIGENVALUES if close_all.any() else Error.SUCCESS
    return X, spec, (n, ncols), info


def eigenvectors_sep_dm(S, Q, select, mesh: Mesh, stats: Optional[dict] = None):
    """Eigenvectors of A = Q S Qᵀ for the selected eigenvalues, from the
    column shards S and Q (``ops.eigenvectors.eigenvectors_schur``'s
    result, its columns sharded): (X, spec, shape, info), X this rank's
    shard of the (n, ncols) result under spec (:func:`flex_spec`).
    ``stats``, if a dict, receives this rank's collective counts, bytes,
    largest message and seconds, its rows and vectors of the backsolve
    (``eig_rows``, ``eig_vectors``: the kernel ran here where both are
    nonzero), the ranks' first rows (``eig_cuts``), each vector's close
    flag (``close``), the smallest product of scalings of the vectors
    solved here (``scale_min``) and the host seconds by phase, each ended
    by draining the device's queue (``eig_phase_s``: inputs, pipeline,
    scale_normalize, back_transform).  A collective."""
    return _eigenvectors_dm([S], Q, select, mesh, stats)


def eigenvectors_gep_dm(S, T, Z, select, mesh: Mesh,
                        stats: Optional[dict] = None):
    """Right eigenvectors of the pencil (Q S Zᵀ, Q T Zᵀ) for the selected
    eigenvalues, infinite ones included, from the column shards S, T and
    Z (``eigenvectors_schur_gep``'s result, sharded), as
    :func:`eigenvectors_sep_dm` returns them."""
    return _eigenvectors_dm([S, T], Z, select, mesh, stats)
