"""GEP distributed interface of the PyTorch port (reference:
starneig/gep_dm.h:100-514).

Counterpart of ``starneig_tpu/api/gep_dm.py``.  The JAX package places
the pencil with a NamedSharding and lets XLA's SPMD partitioner split the
single-process programs; eager PyTorch has no such partitioner, so the
stages here run the port's drivers on column shards
(``parallel/dm_gep.py``):

  * ``hessenberg_triangular`` (``parallel/dm_ht.py``): B's QR as a
    blocked Householder QR on the shards, then G1's blocked cascade with
    every rank launching it on its own columns, the right chain handed
    across each cut and the deferred products applied as column panels;
  * ``schur`` (QZ) and ``reorder_schur``: the window kernels (G1's window
    mode, G2-G6) launch on rank 0, every rank applies the window
    transforms to its own columns; ``select`` and the eigenvalues come
    from the gathered diagonals;
  * ``eigenvectors`` (``parallel/dm_eig.py``): the backsolve as a
    right-to-left pipeline over the shards, each rank launching E2 on the
    rows of its columns, X = Z Y summed in column blocks;
  * ``reduce`` chains HT, QZ, select and reordering, all on the shards.

Every entry point takes and gives column shards: a column-sharded input
stays as it is, a row-sharded, replicated or whole one is moved to column
shards first (``DistrMatrix.full`` for a row-sharded one) and the results
come back under the input's spec.

Every function is collective, and takes ``device=None`` and
``stats=None`` as ``api.sep_dm``'s do.  Includes distributed generalized
eigenvectors (declared but unimplemented in the reference, gep_dm.h).
"""

from __future__ import annotations

from typing import Optional

from starneig_tpu_torch.api.sep_dm import _cols, _from_cols, _mesh_spec
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.parallel import dm_gep
from starneig_tpu_torch.parallel.distr import DistrMatrix


def hessenberg_triangular(A, B, mesh=None, device=None,
                          stats: Optional[dict] = None):
    """Distributed HT reduction (gep_dm.h:100-160; the reference outsources
    this to the bundled ScaLAPACK pdgghrd) on column shards
    (:func:`~starneig_tpu_torch.parallel.dm_ht.hessenberg_triangular_dm`):
    (H, T, Q, Z), the matrices under A's spec."""
    from starneig_tpu_torch.parallel.dm_ht import hessenberg_triangular_dm

    m, spec = _mesh_spec(A, mesh, device)
    A_loc, B_loc = _cols(A, m, stats), _cols(B, m, stats)
    n = A_loc.shape[0]
    outs = hessenberg_triangular_dm(A_loc, B_loc, m, stats=stats)
    return tuple(_from_cols(M, m, spec, (n, n), stats) for M in outs)


def schur(H, T, Q=None, Z=None, mesh=None, conf=None, device=None,
          stats: Optional[dict] = None):
    """Distributed QZ (gep_dm.h:162-240) on column shards
    (:func:`~starneig_tpu_torch.parallel.dm_gep.qz_dm`): (S, T, Q, Z,
    alpha_r, alpha_i, beta, info), the matrices under H's spec."""
    m, spec = _mesh_spec(H, mesh, device)
    locs = [_cols(M, m, stats) for M in (H, T, Q, Z)]
    n = locs[0].shape[0]
    *mats, ar, ai, bt, info = dm_gep.qz_dm(*locs, mesh=m, conf=conf, stats=stats)
    return (*(_from_cols(M, m, spec, (n, n), stats) for M in mats), ar, ai, bt,
            info)


def reorder_schur(S, T, Q, Z, select, mesh=None, conf=None, device=None,
                  stats: Optional[dict] = None):
    """Distributed generalized reordering (gep_dm.h:242-330) on column
    shards (:func:`~starneig_tpu_torch.parallel.dm_gep.reorder_gep_dm`):
    (S, T, Q, Z, num_selected, info), the matrices under S's spec."""
    m, spec = _mesh_spec(S, mesh, device)
    locs = [_cols(M, m, stats) for M in (S, T, Q, Z)]
    n = locs[0].shape[0]
    *mats, nsel, info = dm_gep.reorder_gep_dm(*locs, select, mesh=m, conf=conf,
                                              stats=stats)
    return (*(_from_cols(M, m, spec, (n, n), stats) for M in mats), nsel, info)


def eigenvectors(S, T, Q, Z, select, mesh=None, conf=None, device=None,
                 stats: Optional[dict] = None):
    """Distributed generalized eigenvectors, unimplemented in the reference
    (gep_dm.h), on column shards
    (:func:`~starneig_tpu_torch.parallel.dm_eig.eigenvectors_gep_dm`: each
    rank runs E2 on its rows; Q is not used: X = Z Y); (X, info), X a
    DistrMatrix sharded by ``dm_eig.flex_spec``'s rule."""
    from starneig_tpu_torch.parallel.dm_eig import eigenvectors_gep_dm

    m, _spec = _mesh_spec(S, mesh, device)
    X, spec, shape, info = eigenvectors_gep_dm(
        _cols(S, m, stats), _cols(T, m, stats), _cols(Z, m, stats), select, m, stats)
    return DistrMatrix(X, m, spec, shape), info


def eigenvalues(S, T, mesh=None, device=None, stats: Optional[dict] = None):
    """(alpha_r, alpha_i, beta) of a distributed or whole generalized Schur
    form, on every rank, from the gathered diagonals."""
    m, _spec = _mesh_spec(S, mesh, device)
    return dm_gep.eigenvalues_gep_dm(_cols(S, m, stats), _cols(T, m, stats), m,
                                     stats)


def select(S, T, predicate, mesh=None, device=None,
           stats: Optional[dict] = None):
    """Distributed generalized Select: the selection bitmap of a
    distributed or whole Schur pair, on every rank, from the gathered
    diagonals (``api.gep.select``'s rule)."""
    m, _spec = _mesh_spec(S, mesh, device)
    return dm_gep.select_gep_dm(_cols(S, m, stats), _cols(T, m, stats),
                                predicate, m, stats)


def reduce(A, B, predicate=None, mesh=None, device=None,
           stats: Optional[dict] = None, schur_conf=None, reorder_conf=None):
    """Distributed full GEP chain (mpi/combined.c): HT, QZ, select and
    reordering, all on column shards.  Returns (S, T, Q, Z, alpha_r,
    alpha_i, beta, num_selected, info), the matrices under A's spec."""
    m, _spec = _mesh_spec(A, mesh, device)
    H, T, Q, Z = hessenberg_triangular(A, B, mesh=m, stats=stats)
    S, T, Q, Z, ar, ai, bt, info = schur(H, T, Q, Z, conf=schur_conf,
                                         stats=stats)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(S, T, predicate, stats=stats)
        S, T, Q, Z, nsel, info = reorder_schur(S, T, Q, Z, sel,
                                               conf=reorder_conf, stats=stats)
        ar, ai, bt = eigenvalues(S, T, stats=stats)
    return S, T, Q, Z, ar, ai, bt, nsel, info
