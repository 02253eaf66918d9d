"""Distributed matrices over the ranks of a process group.

Counterpart of ``starneig_tpu/parallel/distr.py`` (reference
``starneig/distr_matrix.h:89-455``, ``src/mpi/distr_matrix.c``).  The JAX
package wraps a global array placed with a ``NamedSharding``; here one
process is one rank, and a :class:`DistrMatrix` holds **this rank's
shard**: a block of columns (``"cols"``, the default, as the JAX
package's ``P(None, 'd')``), a block of rows (``"rows"``) or the whole
matrix (``"replicated"``).  Shard d of an m-wide dimension is the d-th
range of ``numpy.array_split(range(m), world_size)``.

Every collective of the port goes through :func:`all_reduce` (a sum) and
:func:`broadcast`, which count their calls, bytes and seconds per rank
into a ``stats`` dict when given one.  Under gloo a CUDA tensor is staged
through the host by gloo itself; the data and every kernel stay on the
card.  :func:`owner_call` runs a function on rank 0 and hands its outputs
to the other ranks: the one place where work is owned rather than shared.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.node import get_node, node_initialized, rank_device

SPECS = ("cols", "rows", "replicated")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a DM call runs on: the process group (None: the default
    group), its size, this process's rank and device."""

    group: Optional[object]
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of every rank of the default process group (a world of one
    without a group).  ``n_devices``, if given, must be the world size.
    The device is ``device``, else the node's, else the card."""
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
    else:
        size, rank = 1, 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks asked for in a world "
                         f"of {size}: start that many processes")
    if device is None and node_initialized():
        dev = get_node().device
    else:
        dev = rank_device(device, rank)
    return Mesh(group=None, size=size, rank=rank, device=dev)


def shard_range(m: int, size: int, rank: int):
    """(lo, hi): the part of range(m) that rank holds (numpy.array_split)."""
    q, r = divmod(m, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (1 if rank < r else 0)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _collective(op, t, mesh: Mesh, stats: Optional[dict], **kw):
    # gloo copies a CUDA tensor to the host once the work queued before it
    # is done, so the synchronize before costs nothing more; the one after
    # ends the copy back, and the seconds counted are the collective's own
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    op(t, group=mesh.group, **kw)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    if stats is not None:
        name = op.__name__
        stats[name] = stats.get(name, 0) + 1
        stats["collective_bytes"] = stats.get("collective_bytes", 0) \
            + t.numel() * t.element_size()
        stats["collective_s"] = stats.get("collective_s", 0.0) \
            + time.perf_counter() - t0
    return t


def all_reduce(t, mesh: Mesh, stats: Optional[dict] = None):
    """Sum the contiguous tensor t over the mesh's ranks, in place."""
    if mesh.size == 1:
        return t
    return _collective(dist.all_reduce, t, mesh, stats)


def broadcast(t, mesh: Mesh, src: int = 0, stats: Optional[dict] = None):
    """Rank src's contiguous tensor t to every rank, in place."""
    if mesh.size == 1:
        return t
    return _collective(dist.broadcast, t, mesh, stats, src=src)


# -- owner computes, the others receive --------------------------------------
#
# The outputs travel as one int64 header (a kind, a dtype and a shape for
# each output) and one float64 buffer holding every tensor and array, each
# cast to float64 (exact for the bools, int32 and float64 values the
# callers return); both lie on the mesh's device, as NCCL needs.

_HEADER = 96                     # int64 slots; the last two: single, size
_DTYPES = (torch.float64, torch.float32, torch.int64, torch.int32, torch.bool)
_NP_DTYPES = (np.float64, np.float32, np.int64, np.int32, np.bool_)
_TENSOR, _NDARRAY, _INT, _FLOAT, _BOOL, _NONE, _ERROR = range(7)


def _encode(outs, device):
    """(header list, float64 buffer) of a tuple of outputs."""
    head, flat = [len(outs)], []
    for x in outs:
        if isinstance(x, torch.Tensor):
            kind, dt, shape = _TENSOR, _DTYPES.index(x.dtype), tuple(x.shape)
            flat.append(x.detach().reshape(-1).to(device, torch.float64))
        elif isinstance(x, np.ndarray):
            kind, dt, shape = _NDARRAY, _NP_DTYPES.index(x.dtype.type), x.shape
            flat.append(torch.from_numpy(
                np.ascontiguousarray(x, np.float64).reshape(-1)).to(device))
        elif x is None:
            kind, dt, shape = _NONE, 0, ()
        elif isinstance(x, (bool, np.bool_)):
            kind, dt, shape = _BOOL, 0, (int(x),)
        elif isinstance(x, Error):
            kind, dt, shape = _ERROR, 0, (int(x),)
        elif isinstance(x, (int, np.integer)):
            kind, dt, shape = _INT, 0, (int(x),)
        elif isinstance(x, (float, np.floating)):
            kind, dt, shape = _FLOAT, 0, ()
            flat.append(torch.tensor([float(x)], dtype=torch.float64,
                                     device=device))
        else:
            raise TypeError(f"owner_call: cannot send a {type(x).__name__}")
        head += [kind, dt, len(shape), *shape]
    if len(head) > _HEADER - 2:
        raise ValueError("owner_call: too many outputs for the header")
    body = torch.cat(flat) if flat else torch.zeros(0, dtype=torch.float64,
                                                    device=device)
    return head + [0] * (_HEADER - 2 - len(head)), body


def _decode(head, body):
    outs, i, off = [], 1, 0
    for _ in range(head[0]):
        kind, dt, nd = head[i:i + 3]
        shape = tuple(head[i + 3:i + 3 + nd])
        i += 3 + nd
        size = int(np.prod(shape)) if kind in (_TENSOR, _NDARRAY) \
            else int(kind == _FLOAT)
        part = body[off:off + size]
        off += size
        if kind == _TENSOR:
            outs.append(part.reshape(shape).to(_DTYPES[dt]))
        elif kind == _NDARRAY:
            outs.append(part.cpu().numpy().reshape(shape).astype(_NP_DTYPES[dt]))
        elif kind == _FLOAT:
            outs.append(float(part[0]))
        elif kind == _NONE:
            outs.append(None)
        else:
            outs.append({_INT: int, _BOOL: bool, _ERROR: Error}[kind](shape[0]))
    return tuple(outs)


def owner_call(mesh: Mesh, fn, *args, stats: Optional[dict] = None):
    """``fn(*args)`` run on rank 0 only; every rank returns its outputs.

    Rank 0 returns fn's own outputs; the others receive equal copies (two
    broadcasts: a header and one float64 buffer).  fn returns a tensor, a
    numpy array, an int, a float, a bool, an ``Error`` code, None, or a
    tuple of these; a tensor arrives on the mesh's device.  Every rank
    must call this at the same point: it is a collective.
    """
    if mesh.size == 1:
        return fn(*args)
    if mesh.rank == 0:
        outs = fn(*args)
        single = not isinstance(outs, tuple)
        head, body = _encode((outs,) if single else outs, mesh.device)
        broadcast(torch.tensor(head + [int(single), body.numel()],
                               device=mesh.device), mesh, stats=stats)
        broadcast(body, mesh, stats=stats)
        return outs
    meta = torch.zeros(_HEADER, dtype=torch.int64, device=mesh.device)
    broadcast(meta, mesh, stats=stats)
    meta = meta.tolist()
    body = torch.empty(meta[-1], dtype=torch.float64, device=mesh.device)
    broadcast(body, mesh, stats=stats)
    outs = _decode(meta, body)
    return outs[0] if meta[-2] else outs


# ---------------------------------------------------------------------------
# distributed matrices
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistrMatrix:
    """A matrix over a mesh (reference: starneig_distr_matrix_t).

    ``data`` is this rank's shard (a tensor on the mesh's device),
    ``spec`` one of ``"cols"``, ``"rows"``, ``"replicated"``, and
    ``shape`` the global shape.
    """

    data: torch.Tensor
    mesh: Mesh
    spec: str
    shape: tuple

    @property
    def dtype(self):
        return self.data.dtype

    def full(self, stats: Optional[dict] = None) -> torch.Tensor:
        """The whole matrix, as a tensor on every rank's device.  A
        collective (one all_reduce of the matrix): every rank calls it."""
        if self.spec == "replicated" or self.mesh.size == 1:
            return self.data
        out = self.data.new_zeros(self.shape)
        if self.spec == "cols":
            lo, hi = shard_range(self.shape[1], self.mesh.size, self.mesh.rank)
            out[:, lo:hi] = self.data
        else:
            lo, hi = shard_range(self.shape[0], self.mesh.size, self.mesh.rank)
            out[lo:hi] = self.data
        return all_reduce(out, self.mesh, stats)

    def to_array(self, stats: Optional[dict] = None) -> np.ndarray:
        """Gather to a host numpy array on every rank (reference:
        scatter/gather copy semantics, distr_matrix.h:248-305).  A
        collective: every rank calls it."""
        return self.full(stats).cpu().numpy()


def shard_of(M: torch.Tensor, mesh: Mesh, spec: str) -> torch.Tensor:
    """This rank's shard of the whole matrix M under spec (a copy)."""
    if spec not in SPECS:
        raise ValueError(f"spec {spec!r} is not one of {SPECS}")
    if spec == "cols":
        lo, hi = shard_range(M.shape[1], mesh.size, mesh.rank)
        return M[:, lo:hi].clone()
    if spec == "rows":
        lo, hi = shard_range(M.shape[0], mesh.size, mesh.rank)
        return M[lo:hi].clone()
    return M.clone()


def distr_matrix_create(m: int, n: int, mesh: Mesh, dtype=torch.float64,
                        spec: str = "cols") -> DistrMatrix:
    """A zero-initialized distributed matrix (distr_matrix.h:189)."""
    M = torch.zeros((m, n), dtype=dtype, device=mesh.device)
    return DistrMatrix(shard_of(M, mesh, spec), mesh, spec, (m, n))


def distr_matrix_from_array(A, mesh: Mesh, spec: str = "cols") -> DistrMatrix:
    """Every rank takes its shard of the whole matrix A (a tensor or an
    array-like, the same on every rank) (distr_matrix.h:248)."""
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A, dtype=np.float64))
    A = A.to(mesh.device, torch.float64)
    return DistrMatrix(shard_of(A, mesh, spec), mesh, spec, tuple(A.shape))
