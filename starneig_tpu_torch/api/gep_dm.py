"""GEP distributed interface of the PyTorch port (reference:
starneig/gep_dm.h:100-514).

Counterpart of ``starneig_tpu/api/gep_dm.py``.  The JAX package places
the pencil with a NamedSharding and lets XLA's SPMD partitioner split the
single-process programs; eager PyTorch has no such partitioner, so each
entry point here gathers its matrices, rank 0 runs the ``api.gep`` entry
point on its device (kernels G1-G6 on the card), and every rank takes its
shard of the outputs.  Every function is collective, and takes
``device=None`` and ``stats=None`` as ``api.sep_dm``'s do.  Includes
distributed generalized eigenvectors (declared but unimplemented in the
reference, gep_dm.h).
"""

from __future__ import annotations

from typing import Optional

import torch

from starneig_tpu_torch.api import gep as _gep
from starneig_tpu_torch.api.sep_dm import _mesh_spec, _whole, _wrap, _wrap_flex
from starneig_tpu_torch.parallel.distr import DistrMatrix, owner_call


def hessenberg_triangular(A, B, mesh=None, device=None,
                          stats: Optional[dict] = None):
    """Distributed HT reduction (gep_dm.h:100-160; the reference outsources
    this to the bundled ScaLAPACK pdgghrd): (H, T, Q, Z)."""
    m, spec = _mesh_spec(A, mesh, device)
    Af, Bf = (_whole(M, m, stats) for M in (A, B))
    outs = owner_call(m, lambda: _gep.hessenberg_triangular(Af, Bf, device=m.device),
                      stats=stats)
    return tuple(_wrap(M, m, spec) for M in outs)


def schur(H, T, Q=None, Z=None, mesh=None, conf=None, device=None,
          stats: Optional[dict] = None):
    """Distributed QZ (gep_dm.h:162-240): (S, T, Q, Z, alpha_r, alpha_i,
    beta, info)."""
    m, spec = _mesh_spec(H, mesh, device)
    Hf, Tf, Qf, Zf = (_whole(M, m, stats) for M in (H, T, Q, Z))
    S, Tt, Qo, Zo, ar, ai, bt, info = owner_call(
        m, lambda: _gep.schur(Hf, Tf, Qf, Zf, conf=conf, device=m.device),
        stats=stats)
    return (*(_wrap(M, m, spec) for M in (S, Tt, Qo, Zo)), ar, ai, bt, info)


def reorder_schur(S, T, Q, Z, select, mesh=None, conf=None, device=None,
                  stats: Optional[dict] = None):
    """Distributed generalized reordering (gep_dm.h:242-330): (S, T, Q, Z,
    num_selected, info)."""
    m, spec = _mesh_spec(S, mesh, device)
    Sf, Tf, Qf, Zf = (_whole(M, m, stats) for M in (S, T, Q, Z))
    So, To, Qo, Zo, nsel, info = owner_call(
        m, lambda: _gep.reorder_schur(Sf, Tf, Qf, Zf, select, conf=conf,
                                      device=m.device), stats=stats)
    return (*(_wrap(M, m, spec) for M in (So, To, Qo, Zo)), nsel, info)


def eigenvectors(S, T, Q, Z, select, mesh=None, conf=None, device=None,
                 stats: Optional[dict] = None):
    """Distributed generalized eigenvectors, unimplemented in the reference
    (gep_dm.h): (X, info), X sharded by ``_wrap_flex``'s rule."""
    m, _spec = _mesh_spec(S, mesh, device)
    Sf, Tf, Qf, Zf = (_whole(M, m, stats) for M in (S, T, Q, Z))
    X, info = owner_call(
        m, lambda: _gep.eigenvectors(Sf, Tf, Qf, Zf, select, conf=conf,
                                     device=m.device), stats=stats)
    return _wrap_flex(X, m), info


def select(S, T, predicate, stats: Optional[dict] = None):
    """Distributed generalized Select: the selection bitmap of a
    distributed or whole Schur pair (gathered: a collective)."""
    S, T = (M.full(stats) if isinstance(M, DistrMatrix) else M for M in (S, T))
    return _gep.select(torch.as_tensor(S, dtype=torch.float64),
                       torch.as_tensor(T, dtype=torch.float64), predicate)


def reduce(A, B, predicate=None, mesh=None, device=None,
           stats: Optional[dict] = None, **confs):
    """Distributed full GEP chain (mpi/combined.c): rank 0 runs
    ``api.gep.reduce``.  Returns (S, T, Q, Z, alpha_r, alpha_i, beta,
    num_selected, info)."""
    m, spec = _mesh_spec(A, mesh, device)
    Af, Bf = (_whole(M, m, stats) for M in (A, B))
    S, T, Q, Z, ar, ai, bt, nsel, info = owner_call(
        m, lambda: _gep.reduce(Af, Bf, predicate=predicate, device=m.device,
                               **confs), stats=stats)
    return (*(_wrap(M, m, spec) for M in (S, T, Q, Z)), ar, ai, bt, nsel, info)
