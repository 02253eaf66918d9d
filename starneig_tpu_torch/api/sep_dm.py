"""SEP distributed interface of the PyTorch port (reference:
starneig/sep_dm.h:86-427).

Counterpart of ``starneig_tpu/api/sep_dm.py``.  One process is one rank
(``node.node_init``); every function here is collective: each rank calls
it with its own shards (:class:`~starneig_tpu_torch.parallel.DistrMatrix`)
or with the same whole matrix, which each rank then shards by columns.

  * ``schur`` runs the Schur driver on column shards
    (:func:`starneig_tpu_torch.parallel.dm_core.schur_dm`) and
    ``reorder_schur`` the window grid on column shards
    (:func:`~starneig_tpu_torch.parallel.dm_core.reorder_dm`).
  * ``hessenberg`` and ``eigenvectors`` run on the shards in the JAX
    package only because XLA's SPMD partitioner splits the single-process
    program; eager PyTorch has no such partitioner.  Here the matrix is
    gathered, rank 0 runs ``api.sep.hessenberg`` or ``api.sep.eigenvectors``
    on its device (the kernels launch there), and every rank takes its
    shard of the outputs.
  * ``eigenvectors`` is declared but unimplemented in the reference
    (sep_dm.h:232-238); it is implemented here.

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


def _wrap_flex(out, mesh):
    """Wrap with the finest sharding the shape allows (cols, rows,
    replicated)."""
    if out.ndim == 2 and out.shape[1] % mesh.size == 0:
        spec = "cols"
    elif out.ndim == 2 and out.shape[0] % mesh.size == 0:
        spec = "rows"
    else:
        spec = "replicated"
    return _wrap(out, mesh, spec)


def hessenberg(A, Q=None, mesh=None, conf=None, device=None,
               stats: Optional[dict] = None):
    """Distributed Hessenberg reduction (sep_dm.h:86-130): (H, Q)."""
    mesh, spec = _mesh_spec(A, mesh, device)
    Af, Qf = _whole(A, mesh, stats), _whole(Q, mesh, stats)
    H, Qo = owner_call(
        mesh, lambda: _sep.hessenberg(Af, Q=Qf, conf=conf, device=mesh.device),
        stats=stats)
    return _wrap(H, mesh, spec), _wrap(Qo, mesh, spec)


def schur(H, Q=None, mesh=None, conf=None, device=None,
          stats: Optional[dict] = None):
    """Distributed Schur reduction (sep_dm.h:132-196): the port's driver
    on column shards (:func:`~starneig_tpu_torch.parallel.dm_core.schur_dm`).

    Returns (S, Q, eig_real, eig_imag, info); the eigenvalues are whole
    tensors on every rank."""
    from starneig_tpu_torch.parallel.dm_core import schur_dm

    mesh, spec = _mesh_spec(H, mesh, device)
    S, Qo, er, ei, info = schur_dm(_whole(H, mesh, stats), Q=_whole(Q, mesh, stats),
                                   mesh=mesh, conf=conf, stats=stats)
    return _wrap(S, mesh, spec), _wrap(Qo, mesh, spec), er, ei, info


def reorder_schur(S, Q, select, mesh=None, conf=None, device=None,
                  stats: Optional[dict] = None):
    """Distributed eigenvalue reordering (sep_dm.h:198-230): the window
    grid on column shards
    (:func:`~starneig_tpu_torch.parallel.dm_core.reorder_dm`).

    Returns (S, Q, num_selected, info)."""
    from starneig_tpu_torch.parallel.dm_core import reorder_dm

    mesh, spec = _mesh_spec(S, mesh, device)
    So, Qo, m, info = reorder_dm(_whole(S, mesh, stats), _whole(Q, mesh, stats),
                                 select, mesh=mesh, conf=conf, stats=stats)
    return _wrap(So, mesh, spec), _wrap(Qo, mesh, spec), m, info


def eigenvectors(S, Q, select, mesh=None, conf=None, device=None,
                 stats: Optional[dict] = None):
    """Distributed eigenvectors, unimplemented in the reference
    (sep_dm.h:232-238): rank 0 runs ``api.sep.eigenvectors``.

    Returns (X, info), X sharded by ``_wrap_flex``'s rule."""
    mesh, _spec = _mesh_spec(S, mesh, device)
    Sf, Qf = _whole(S, mesh, stats), _whole(Q, mesh, stats)
    X, info = owner_call(
        mesh, lambda: _sep.eigenvectors(Sf, Qf, select, conf=conf,
                                        device=mesh.device), stats=stats)
    return _wrap_flex(X, mesh), info


def select(S, predicate: Callable[[complex], bool],
           stats: Optional[dict] = None):
    """Distributed Select (sep_dm.h): the selection bitmap of a
    DistrMatrix (gathered: a collective) or a whole matrix."""
    if isinstance(S, DistrMatrix):
        S = S.full(stats)
    return _sep.select(torch.as_tensor(S, dtype=torch.float64), predicate)


def reduce(A, predicate: Optional[Callable[[complex], bool]] = None,
           mesh=None, hessenberg_conf=None, schur_conf=None,
           reorder_conf=None, device=None, stats: Optional[dict] = None):
    """Distributed full chain (reference: mpi/combined.c): Hessenberg on
    rank 0, Schur and reordering on column shards.

    Returns (S, Q, eig_real, eig_imag, num_selected, info)."""
    mesh, _spec = _mesh_spec(A, mesh, device)
    Hd, Qd = hessenberg(A, mesh=mesh, conf=hessenberg_conf, stats=stats)
    Sd, Qd, er, ei, info = schur(Hd, Qd, conf=schur_conf, stats=stats)
    nsel = 0
    if info == Error.SUCCESS and predicate is not None:
        sel = select(Sd, predicate, stats=stats)
        Sd, Qd, nsel, info = reorder_schur(Sd, Qd, sel, conf=reorder_conf,
                                           stats=stats)
        er, ei = _sep.eigenvalues(Sd.full(stats), device=mesh.device)
    return Sd, Qd, er, ei, nsel, info
