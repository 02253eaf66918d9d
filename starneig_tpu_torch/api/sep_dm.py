"""SEP distributed interface of the PyTorch port (reference:
starneig/sep_dm.h:86-427).

Counterpart of ``starneig_tpu/api/sep_dm.py``.  One process is one rank
(``node.node_init``); every function here is collective: each rank calls
it with its own shards (:class:`~starneig_tpu_torch.parallel.DistrMatrix`)
or with the same whole matrix, which each rank then shards by columns.

  * ``hessenberg`` runs the panel loop on column shards
    (:func:`starneig_tpu_torch.parallel.dm_hess.hessenberg_dm`: every rank
    launches B1 on its own columns), ``schur`` the Schur driver
    (:func:`starneig_tpu_torch.parallel.dm_core.schur_dm`) and
    ``reorder_schur`` the window grid
    (:func:`~starneig_tpu_torch.parallel.dm_core.reorder_dm`), each with
    column shards in and column shards out; ``select`` and the
    eigenvalues come from the gathered diagonals.  None of them gathers a
    whole matrix: a column-sharded input stays as it is, a row-sharded,
    replicated or whole one is moved to column shards first
    (``DistrMatrix.full`` for a row-sharded one, counted in ``stats``) and
    the result comes back under the input's spec.
  * ``eigenvectors`` (declared but unimplemented in the reference,
    sep_dm.h:232-238; in the JAX package XLA's SPMD partitioner splits the
    single-process program) runs the backsolve as a right-to-left pipeline
    over the column shards
    (:func:`starneig_tpu_torch.parallel.dm_eig.eigenvectors_sep_dm`: each
    rank launches E1 on the rows of its columns, the far sums handed to
    the left), and X = Q Y comes back sharded by columns where its width
    allows (``dm_eig.flex_spec``).

Every function takes ``device=None`` (the device of the mesh made when
none is given: the node's, else the card; ``RuntimeError`` without one
unless ``device="cpu"``) and ``stats=None`` (a dict that receives this
rank's collective counts, bytes and seconds, and the drivers' counts).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from starneig_tpu_torch.api import sep as _sep
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.parallel.distr import (DistrMatrix, make_mesh,
                                               owner_call, shard_of)


def _mesh_spec(A, mesh, device):
    """The mesh and spec of a call whose first matrix is A: A's own if it
    is a DistrMatrix, else ``mesh`` (default a new one on ``device``) and
    column sharding."""
    if isinstance(A, DistrMatrix):
        return A.mesh, A.spec
    return (mesh if mesh is not None else make_mesh(device=device)), "cols"


def _whole(M, mesh, stats):
    """M as the whole matrix on every rank, on the mesh's device: a
    DistrMatrix gathered (a collective), a whole matrix moved."""
    if M is None:
        return None
    if isinstance(M, DistrMatrix):
        return M.full(stats)
    if not isinstance(M, torch.Tensor):
        M = torch.as_tensor(np.asarray(M, dtype=np.float64))
    return M.to(mesh.device, torch.float64)


def _wrap(out, mesh, spec):
    """The whole matrix out (on every rank) as this rank's DistrMatrix."""
    return DistrMatrix(shard_of(out, mesh, spec), mesh, spec, tuple(out.shape))


def _cols(M, mesh, stats):
    """This rank's column shard of M: a column-sharded DistrMatrix's own
    data, or its columns of a replicated or whole matrix, with no
    collective; a row-sharded DistrMatrix is gathered first
    (``DistrMatrix.full``: one all_reduce, counted in ``stats``)."""
    if M is None:
        return None
    if isinstance(M, DistrMatrix):
        if M.spec == "cols":
            return M.data
        whole = M.data if M.spec == "replicated" else M.full(stats)
        return shard_of(whole, mesh, "cols")
    return shard_of(_whole(M, mesh, None), mesh, "cols")


def _from_cols(M_loc, mesh, spec, shape, stats):
    """The column shard M_loc as a DistrMatrix under spec: as it is for
    ``"cols"``, else gathered (one all_reduce, counted in ``stats``) and
    cut to spec."""
    M = DistrMatrix(M_loc, mesh, "cols", shape)
    return M if spec == "cols" else _wrap(M.full(stats), mesh, spec)


def hessenberg(A, Q=None, mesh=None, conf=None, device=None,
               stats: Optional[dict] = None):
    """Distributed Hessenberg reduction (sep_dm.h:86-130) on column shards
    (:func:`~starneig_tpu_torch.parallel.dm_hess.hessenberg_dm`).

    A and Q may be DistrMatrix under any spec or whole matrices; a
    row-sharded one is moved to column shards first.  Returns (H, Q) as
    DistrMatrix under A's spec (column shards for a whole A), as the JAX
    package's ``_wrap(H, Ad.mesh, Ad.spec)``."""
    from starneig_tpu_torch.parallel.dm_hess import hessenberg_dm

    mesh, spec = _mesh_spec(A, mesh, device)
    A_loc = _cols(A, mesh, stats)
    n = A_loc.shape[0]
    H, Qo = hessenberg_dm(A_loc, _cols(Q, mesh, stats), mesh, conf=conf,
                          stats=stats)
    return (_from_cols(H, mesh, spec, (n, n), stats),
            _from_cols(Qo, mesh, spec, (n, n), stats))


def schur(H, Q=None, mesh=None, conf=None, device=None,
          stats: Optional[dict] = None):
    """Distributed Schur reduction (sep_dm.h:132-196): the port's driver
    on column shards (:func:`~starneig_tpu_torch.parallel.dm_core.schur_dm`).

    Returns (S, Q, eig_real, eig_imag, info), S and Q under H's spec
    (column shards for a whole H); the eigenvalues are whole tensors on
    every rank."""
    from starneig_tpu_torch.parallel.dm_core import schur_dm

    mesh, spec = _mesh_spec(H, mesh, device)
    H_loc = _cols(H, mesh, stats)
    n = H_loc.shape[0]
    S, Qo, er, ei, info = schur_dm(H_loc, _cols(Q, mesh, stats), mesh=mesh,
                                   conf=conf, stats=stats)
    return (_from_cols(S, mesh, spec, (n, n), stats),
            _from_cols(Qo, mesh, spec, (n, n), stats), er, ei, info)


def reorder_schur(S, Q, select, mesh=None, conf=None, device=None,
                  stats: Optional[dict] = None):
    """Distributed eigenvalue reordering (sep_dm.h:198-230): the window
    grid on column shards
    (:func:`~starneig_tpu_torch.parallel.dm_core.reorder_dm`).

    Returns (S, Q, num_selected, info), S and Q under S's spec."""
    from starneig_tpu_torch.parallel.dm_core import reorder_dm

    mesh, spec = _mesh_spec(S, mesh, device)
    S_loc = _cols(S, mesh, stats)
    n = S_loc.shape[0]
    So, Qo, m, info = reorder_dm(S_loc, _cols(Q, mesh, stats), select,
                                 mesh=mesh, conf=conf, stats=stats)
    return (_from_cols(So, mesh, spec, (n, n), stats),
            _from_cols(Qo, mesh, spec, (n, n), stats), m, info)


def eigenvectors(S, Q, select, mesh=None, conf=None, device=None,
                 stats: Optional[dict] = None):
    """Distributed eigenvectors, unimplemented in the reference
    (sep_dm.h:232-238): the backsolve as a right-to-left pipeline over
    column shards (:func:`~starneig_tpu_torch.parallel.dm_eig.eigenvectors_sep_dm`:
    each rank runs E1 on its rows), X = Q Y summed in column blocks.  S and
    Q may be DistrMatrix under any spec or whole matrices; a row-sharded
    one is moved to column shards first.  ``conf`` is accepted for parity
    with the JAX package.

    Returns (X, info), X a DistrMatrix sharded by ``dm_eig.flex_spec``'s
    rule (columns, else rows, else replicated)."""
    from starneig_tpu_torch.parallel.dm_eig import eigenvectors_sep_dm

    mesh, _spec = _mesh_spec(S, mesh, device)
    X, spec, shape, info = eigenvectors_sep_dm(_cols(S, mesh, stats), _cols(Q, mesh, stats),
                                               select, mesh, stats)
    return DistrMatrix(X, mesh, spec, shape), info


def _diagonals(S, mesh, stats):
    """S's three diagonals on every rank, from its column shards."""
    from starneig_tpu_torch.parallel.dm_core import shard_diagonals
    return shard_diagonals((_cols(S, mesh, stats),), mesh, stats)[0]


def eigenvalues(S, mesh=None, device=None, stats: Optional[dict] = None):
    """(eig_real, eig_imag) of a distributed or whole real Schur form, on
    every rank: rank 0 computes them from the gathered diagonals."""
    from starneig_tpu_torch.ops.eigvals import eigenvalues_from_diagonals

    mesh, _spec = _mesh_spec(S, mesh, device)
    return owner_call(mesh, eigenvalues_from_diagonals,
                      *_diagonals(S, mesh, stats), stats=stats)


def select(S, predicate: Callable[[complex], bool], mesh=None, device=None,
           stats: Optional[dict] = None):
    """Distributed Select (sep_dm.h): the selection bitmap of a
    DistrMatrix or a whole matrix, on every rank: rank 0 walks the blocks
    of the gathered diagonals (``api.sep.select``'s rule)."""
    mesh, _spec = _mesh_spec(S, mesh, device)
    d = _diagonals(S, mesh, stats)
    return owner_call(
        mesh, lambda: _sep.select_from_diagonals(*d.cpu().numpy(), predicate),
        stats=stats)


def reduce(A, predicate: Optional[Callable[[complex], bool]] = None,
           mesh=None, hessenberg_conf=None, schur_conf=None,
           reorder_conf=None, device=None, stats: Optional[dict] = None):
    """Distributed full chain (reference: mpi/combined.c): Hessenberg,
    Schur and reordering on column shards.

    Returns (S, Q, eig_real, eig_imag, num_selected, info), S and Q under
    A's spec (column shards for a whole A)."""
    mesh, _spec = _mesh_spec(A, mesh, device)
    Hd, Qd = hessenberg(A, mesh=mesh, conf=hessenberg_conf, stats=stats)
    Sd, Qd, er, ei, info = schur(Hd, Qd, conf=schur_conf, stats=stats)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(Sd, predicate, stats=stats)
        Sd, Qd, nsel, info = reorder_schur(Sd, Qd, sel, conf=reorder_conf,
                                           stats=stats)
        er, ei = eigenvalues(Sd, stats=stats)
    return Sd, Qd, er, ei, nsel, info
