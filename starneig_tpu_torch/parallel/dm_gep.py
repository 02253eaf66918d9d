"""Distributed-memory QZ and generalized reordering on column shards.

Counterpart of ``starneig_tpu/api/gep_dm.py``, where XLA's SPMD partitioner
splits the single-process GEP programs over a pencil placed with a
``NamedSharding``.  Here the port's own drivers run on this rank's column
shards of the pencil, every access to the matrices going through
:class:`~starneig_tpu_torch.parallel.dm_core.ShardedExtent`, as
``dm_core.schur_dm`` runs the SEP driver:

  * :func:`qz_dm`: the multishift-QZ iteration
    (:func:`starneig_tpu_torch.ops.qz_driver._qz_iter`: AED rounds, the
    windowed infinite push, B-bulge trains) on the shards of the padded
    (S, T, Q, Z) (``dm_core.pad_cuts``); its window math (G2, G4, the
    status read, G1's window mode, G5, G3, the deflating rotation) runs on
    rank 0 inside ``ext.window``; the 2x2 blocks are standardized on the
    shards and the eigenvalues come from the gathered diagonals;
  * :func:`reorder_gep_dm`: the sequential window chain
    (:func:`starneig_tpu_torch.ops.reorder.reorder_gep_`) on the shards,
    G6 on rank 0;
  * :func:`select_gep_dm` and :func:`eigenvalues_gep_dm`: the selection and
    the eigenvalues from the gathered diagonals (one all_reduce of O(n)).

No rank holds a whole matrix: the messages are the windows and panels of
the pencil (at most one NP x max(WA, WC) panel of each of its four
matrices), the diagonals, and the owner's window outputs.  Up to the small
limit, and on one rank, rank 0 runs ``api.gep.schur`` on the gathered
pencil instead (as ``schur_dm`` does), and every rank takes its shards of
the result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from starneig_tpu_torch.config import ReorderConf, SchurConf
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops.eigvals import eigenvalues_gen_from_diagonals
from starneig_tpu_torch.parallel.distr import Mesh, owner_call, shard_range
from starneig_tpu_torch.parallel.dm_core import (ShardedExtent, _to,
                                                 check_shard, eye_cols,
                                                 frobenius, gathered,
                                                 inner_shard, pad_cuts,
                                                 padded_shard,
                                                 shard_diagonals, split_cuts)


def _eigs(dS, dT):
    return eigenvalues_gen_from_diagonals(dS[0], dS[1], dS[2], dT[0], dT[2])


def qz_dm(H, T, Q, Z, mesh: Mesh, conf: Optional[SchurConf] = None,
          stats: Optional[dict] = None):
    """Distributed Hessenberg-triangular -> generalized real Schur form.

    H, T, Q and Z (Q, Z None: the identity) are this rank's column shards
    of (n, n) matrices (``shard_range``).  ``stats``, if a dict, receives
    this rank's collective counts, bytes and seconds and (the AED path)
    the geometry, the cuts, the padded shard's shape, the rounds,
    ``qz_log``, the recondense calls, the infinite push's window chases
    and rounds.

    Returns (S, T, Q, Z, alpha_r, alpha_i, beta, info): this rank's column
    shards, the eigenvalues whole on every rank.
    """
    from starneig_tpu_torch.ops.qz import ULP
    from starneig_tpu_torch.ops.qz_driver import (_Geometry, _qz_iter,
                                                  standardize_blocks_gep_)

    nd, rank = mesh.size, mesh.rank
    n = _to(H, mesh).shape[0]
    H, T = (check_shard(M, n, mesh, "qz_dm") for M in (H, T))
    Q, Z = (eye_cols(n, mesh) if M is None else check_shard(M, n, mesh, "qz_dm")
            for M in (Q, Z))
    conf = (conf or SchurConf()).resolve(n)
    lo, hi = shard_range(n, nd, rank)

    if n <= conf.small_limit or nd == 1:
        from starneig_tpu_torch.api import gep as _gep
        whole = [gathered(M, n, mesh, stats) for M in (H, T, Q, Z)]
        out = owner_call(mesh, lambda: _gep.schur(*whole, conf=conf, stats=stats,
                                                  device=mesh.device),
                         stats=stats)
        return (*(M[:, lo:hi].clone() for M in out[:4]), *out[4:])

    g = _Geometry(n, conf)
    P, NP = g.P, g.NP
    cuts = pad_cuts(n, P, nd)
    tiny = float(np.finfo(np.float64).tiny)
    nh, nt = frobenius((H, T), mesh, stats)
    thresh, thresh_t = max(ULP / 2 * nh, tiny), max(ULP / 2 * nt, tiny)
    Spad, Tpad = (padded_shard(M, cuts, rank, NP, P, P, lo) for M in (H, T))
    Qpad, Zpad = (padded_shard(M, cuts, rank, n, 0, P, lo) for M in (Q, Z))
    ext = ShardedExtent(mesh, stats, cuts)

    st = dict(qz_log=[], recondense_calls=0, inf_chase_calls=0)
    ihi, fail = _qz_iter(Spad, Tpad, Qpad, Zpad, n, thresh, thresh_t, g, st, ext)
    info = Error.DID_NOT_CONVERGE if (fail or ihi > 0) else Error.SUCCESS
    standardize_blocks_gep_(Spad, Tpad, Qpad, Zpad, P, n, ext)
    ar, ai, bt = ext.window(_eigs, *ext.diagonals((Spad, Tpad), P, n))
    if stats is not None:
        stats.update(path="aed", WA=g.WA, NS=g.NS, B=g.B, WC=g.WC,
                     TMAX=g.TMAX, P=P, NP=NP, INFW=g.INFW, cuts=cuts,
                     shard_shape=tuple(Spad.shape),
                     work_bytes=8 * sum(M.numel() for M in (Spad, Tpad, Qpad, Zpad)),
                     **st, inf_rounds=sum(r[3] for r in st["qz_log"]))
    outs = [inner_shard(M, cuts, rank, r0, n, P, lo, hi)
            for M, r0 in ((Spad, P), (Tpad, P), (Qpad, 0), (Zpad, 0))]
    return (*outs, ar, ai, bt, info)


def reorder_gep_dm(S, T, Q, Z, select, mesh: Mesh,
                   conf: Optional[ReorderConf] = None,
                   stats: Optional[dict] = None):
    """Distributed generalized reordering: the sequential window chain on
    column shards (its windows lie inside the matrix, so the shards need
    no padding).  Each window pair is gathered by one all_reduce, rank 0
    bubbles it (G6 on the card) and broadcasts the window, its transforms,
    the selection, the counters and the window's subdiagonal; every rank
    applies the transforms to its shards.  ``stats``, if a dict, receives
    the collective counts and the windows, swaps and failed swaps.

    Returns (S, T, Q, Z, num_selected, info), the first four this rank's
    column shards.
    """
    from starneig_tpu_torch.ops.reorder import reorder_gep_

    n = _to(S, mesh).shape[0]
    S, T, Q, Z = (check_shard(M, n, mesh, "reorder_gep_dm").clone()
                  for M in (S, T, Q, Z))
    ext = ShardedExtent(mesh, stats, split_cuts(n, mesh.size))
    m, info = reorder_gep_(S, T, Q, Z, select, conf=conf, stats=stats, ext=ext)
    if stats is not None:
        stats.update(shard_shape=tuple(S.shape),
                     work_bytes=8 * sum(M.numel() for M in (S, T, Q, Z)))
    return S, T, Q, Z, m, info


def eigenvalues_gep_dm(S, T, mesh: Mesh, stats: Optional[dict] = None):
    """(alpha_r, alpha_i, beta) of the generalized Schur form whose column
    shards are S and T, from their gathered diagonals, on every rank."""
    dS, dT = shard_diagonals((S, T), mesh, stats)
    return owner_call(mesh, _eigs, dS, dT, stats=stats)


def select_gep_dm(S, T, predicate, mesh: Mesh, stats: Optional[dict] = None):
    """The selection bitmap of ``api.gep.select`` for the generalized
    Schur form whose column shards are S and T, from their gathered
    diagonals (rank 0 walks the blocks), on every rank."""
    from starneig_tpu_torch.api.gep import select_from_eigenvalues

    dS, dT = shard_diagonals((S, T), mesh, stats)
    return owner_call(
        mesh, lambda: select_from_eigenvalues(*_eigs(dS, dT), dS[1], predicate),
        stats=stats)
