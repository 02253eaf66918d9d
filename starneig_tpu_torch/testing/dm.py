"""Run the port's DM layer in several processes: the launcher that the
tests and ``chip_smoke.py`` share, and the jobs they run.

    result, counters = run_ranks("starneig_tpu_torch.testing.dm:sep_reduce",
                                 2, args=(A, "positive_real"), device="cpu")

:func:`run_ranks` starts ``world_size`` processes with the ``spawn`` start
method (a fork after CUDA is initialized breaks CUDA).  Each runs
``node_init`` over a ``FileStore`` in a temporary directory (gloo on the
CPU or on a shared card), calls the named function with the numpy
arguments, then ``node_finalize``.  A job returns ``(result, counters)``;
``run_ranks`` returns rank 0's result and every rank's counters, to which
it adds the rank's kernel launches (``kernels.LAUNCHES``, zeroed before
the job), its device and backend, and its seconds: ``startup_s`` from the
spawn to the group's rendezvous, ``wall_s`` in the job, ``teardown_s``
from the last result to every rank's exit.  A rank that fails, or a
group that outlives ``timeout_s``, makes ``run_ranks`` raise after it has
stopped every rank: nothing hangs.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np


def run_ranks(fn_name: str, world_size: int, args=(), device=None,
              timeout_s: float = 300.0):
    """Run ``fn_name`` ("module:function") on world_size ranks.

    ``device`` is every rank's device (None: ``cuda:{rank % count}``).
    On a card the kernel library is built here, once, before the ranks
    start.  Returns (rank 0's result, [counters of rank r for each r]).
    """
    import multiprocessing as mp

    if device is None or str(device).startswith("cuda"):
        from starneig_tpu_torch import kernels
        kernels.build()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="starneig_dm_")
    store = os.path.join(tmp, "store")
    results = ctx.Queue()
    t_spawn = time.time()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn_name, r, world_size, store, device, args,
                               timeout_s, t_spawn, results))
             for r in range(world_size)]
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"run_ranks({fn_name}): the group outlived {timeout_s} s; "
                    f"ranks {sorted(set(range(world_size)) - set(got))} "
                    "did not finish")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"run_ranks({fn_name}): rank {dead[0]} exited with "
                        f"code {procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks({fn_name}): rank {rank} "
                                   f"failed:\n{payload}")
            got[rank] = payload
        t_done = time.time()
        for p in procs:
            p.join(timeout=30)
        teardown_s = time.time() - t_done
        for _result, counters in got.values():
            counters["teardown_s"] = teardown_s
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return got[0][0], [got[r][1] for r in range(world_size)]


def _rank_main(fn_name, rank, world_size, store, device, args, timeout_s,
               t_spawn, results):
    try:
        import torch
        from starneig_tpu_torch import kernels, node
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        nd = node.node_init(init_method=f"file://{store}",
                            world_size=world_size, rank=rank, device=device,
                            timeout_s=timeout_s)
        module, name = fn_name.split(":")
        fn = getattr(importlib.import_module(module), name)
        kernels.reset_launches()
        startup_s = time.time() - t_spawn
        t0 = time.perf_counter()
        result, counters = fn(*args)
        counters = dict(counters, launches=dict(kernels.LAUNCHES), rank=rank,
                        startup_s=startup_s, wall_s=time.perf_counter() - t0,
                        device=str(nd.device), backend=nd.backend)
        results.put((rank, True, (result if rank == 0 else None, counters)))
        node.node_finalize()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


# ---------------------------------------------------------------------------
# predicates, by name (a spawned rank receives names, not functions)
# ---------------------------------------------------------------------------

def positive_real(lam):
    return lam.real > 0


def finite_right_half(alpha, beta):
    return beta != 0 and (alpha / beta).real > 0


PREDICATES = {"positive_real": positive_real,
              "finite_right_half": finite_right_half}


# ---------------------------------------------------------------------------
# jobs: each takes numpy arguments and returns (result, counters)
# ---------------------------------------------------------------------------

def _stage(mesh):
    """End a stage: the device's queue drained, then every rank met."""
    import torch
    import torch.distributed as dist
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if dist.is_initialized():
        dist.barrier()
    return time.perf_counter()


def sep_chain(A, predicate: str = "positive_real"):
    """api.sep_dm: hessenberg -> schur -> select -> reorder_schur ->
    eigenvectors of the leading selected block, each stage ended by a
    barrier and timed (``<stage>_ms``), each with its own collective
    counts (``stats``; on a card the Hessenberg stage's peak device
    memory beyond its input, ``peak_bytes``).  Result: H and Q after the
    reduction (``H``, ``QH``), S and Q after Schur and after reordering,
    X, the eigenvalues and the info codes."""
    import torch
    from starneig_tpu_torch.api import sep_dm
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr_matrix_from_array

    mesh = default_mesh()
    n = A.shape[0]
    stats = {k: {} for k in ("hessenberg", "schur", "select", "reorder",
                             "eigenvectors")}
    Ad = distr_matrix_from_array(A, mesh)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
    t0 = _stage(mesh)
    Hd, QHd = sep_dm.hessenberg(Ad, stats=stats["hessenberg"])
    t1 = _stage(mesh)
    if cuda:
        # device memory the stage held at its peak beyond its input shard
        stats["hessenberg"]["peak_bytes"] = \
            torch.cuda.max_memory_allocated(mesh.device) - base
    Sd, Qd, er, ei, info = sep_dm.schur(Hd, QHd, stats=stats["schur"])
    t2 = _stage(mesh)
    sel = sep_dm.select(Sd, PREDICATES[predicate], stats=stats["select"])
    t3 = _stage(mesh)
    S2d, Q2d, m, rinfo = sep_dm.reorder_schur(Sd, Qd, sel, stats=stats["reorder"])
    t4 = _stage(mesh)
    X, xinfo = sep_dm.eigenvectors(S2d, Q2d, np.arange(n) < m,
                                   stats=stats["eigenvectors"])
    t5 = _stage(mesh)
    ms = dict(hessenberg_ms=(t1 - t0) * 1e3, schur_ms=(t2 - t1) * 1e3,
              select_ms=(t3 - t2) * 1e3, reorder_ms=(t4 - t3) * 1e3,
              eigenvectors_ms=(t5 - t4) * 1e3)
    result = dict(H=Hd.to_array(), QH=QHd.to_array(), S=Sd.to_array(),
                  Q=Qd.to_array(), er=er.cpu().numpy(), ei=ei.cpu().numpy(),
                  info=int(info), selected=int(sel.sum()), S2=S2d.to_array(),
                  Q2=Q2d.to_array(), m=int(m), rinfo=int(rinfo),
                  X=X.to_array(), xinfo=int(xinfo))
    return result, dict(ms, stats=stats,
                        shards=dict(H=tuple(Hd.data.shape), S=tuple(Sd.data.shape),
                                    X=tuple(X.data.shape), X_spec=X.spec))


@contextlib.contextmanager
def staged(module, names, mesh, ms: dict):
    """Time the stages that ``module``'s functions ``names`` run inside a
    call of another of its functions (``api.sep_dm.reduce`` calls its
    ``hessenberg``, ``schur``, ... as module globals): each stage ends as
    :func:`_stage` ends one, and ``ms[name + "_ms"]`` is its time from
    the end of the stage before it (the first from entering the block)."""
    orig = {k: getattr(module, k) for k in names}
    last = [time.perf_counter()]

    def wrap(name, fn):
        def timed_stage(*a, **kw):
            out = fn(*a, **kw)
            t = _stage(mesh)
            ms[f"{name}_ms"] = (t - last[0]) * 1e3
            last[0] = t
            return out
        return timed_stage
    for k, fn in orig.items():
        setattr(module, k, wrap(k, fn))
    try:
        yield ms
    finally:
        for k, fn in orig.items():
            setattr(module, k, fn)


def sep_reduce(A, predicate: str = "positive_real"):
    """api.sep_dm.reduce of the whole matrix A, its stages' times in
    ``<stage>_ms`` (:func:`staged`)."""
    from starneig_tpu_torch.api import sep_dm
    from starneig_tpu_torch.node import default_mesh

    mesh = default_mesh()
    stats, ms = {}, {}
    with staged(sep_dm, ("hessenberg", "schur", "select", "reorder_schur"), mesh, ms):
        Sd, Qd, er, ei, nsel, info = sep_dm.reduce(A, PREDICATES[predicate],
                                                   mesh=mesh, stats=stats)
    result = dict(S=Sd.to_array(), Q=Qd.to_array(), er=er.cpu().numpy(),
                  ei=ei.cpu().numpy(), nsel=int(nsel), info=int(info))
    return result, dict(ms, stats=stats, shards=dict(S=tuple(Sd.data.shape)))


def gep_reduce(A, B, predicate: str = "finite_right_half"):
    """api.gep_dm.reduce of the whole pencil (A, B), then api.gep_dm.eigenvectors
    of the leading selected block."""
    from starneig_tpu_torch.api import gep_dm

    stats = {}
    *mats, ar, ai, bt, nsel, info = gep_dm.reduce(
        A, B, predicate=PREDICATES[predicate], stats=stats)
    X, xinfo = gep_dm.eigenvectors(*mats, np.arange(A.shape[0]) < int(nsel),
                                   stats=stats)
    result = dict(zip("STQZ", (M.to_array() for M in mats)),
                  ar=ar.cpu().numpy(), ai=ai.cpu().numpy(), bt=bt.cpu().numpy(),
                  nsel=int(nsel), info=int(info), X=X.to_array(), xinfo=int(xinfo))
    return result, dict(stats=stats, shards=dict(S=tuple(mats[0].data.shape)))


def sequence(steps):
    """Several jobs of this module in one group, one after another (one
    spawn's start-up for all): ``steps`` is a list of (job name, args).
    Returns ([each job's result], {"steps": [each job's counters, with its
    own launches and wall seconds]})."""
    from starneig_tpu_torch import kernels
    results, counters = [], []
    for name, args in steps:
        kernels.reset_launches()
        t0 = time.perf_counter()
        result, cnt = globals()[name](*args)
        results.append(result)
        counters.append(dict(cnt, launches=dict(kernels.LAUNCHES),
                             wall_s=time.perf_counter() - t0))
    return results, {"steps": counters}


def apply_extent_op(ext, S, Q, op: str, kw: dict):
    """Apply one extent op (``DenseExtent`` or a sharded extent) in place
    on the padded buffers S, Q (or their shards), with numpy arguments.
    ``op`` names the method; a ``_q`` suffix applies it to Q.  Returns the
    op's value (None for the in-place ops)."""
    import torch
    M = Q if op.endswith("_q") else S
    name = op.removesuffix("_q")
    kw = {k: torch.as_tensor(v, device=S.device) if isinstance(v, np.ndarray)
          and v.dtype == np.float64 else v for k, v in kw.items()}
    return getattr(ext, name)(M, **kw)


@contextlib.contextmanager
def counting_full():
    """Count the calls of ``DistrMatrix.full`` (a gather) in the block:
    yields a one-element list."""
    from starneig_tpu_torch.parallel.distr import DistrMatrix
    orig, box = DistrMatrix.full, [0]

    def full(self, *a, **kw):
        box[0] += 1
        return orig(self, *a, **kw)
    DistrMatrix.full = full
    try:
        yield box
    finally:
        DistrMatrix.full = orig


def suite(arrays: dict):
    """The CPU tests' job: one spawn serves them all.

    * ``distr``: DistrMatrix round trips of ``A`` under each spec, the
      shard shapes, and ``distr_matrix_create``;
    * ``extent``: each (op, kwargs) of ``ext_cases`` applied by the
      sharded extent to column shards of ``Spad``/``Qpad``, with the
      gathered buffers and the value after each;
    * ``window``: what ``ShardedExtent.window`` returns on each rank, and
      whether that rank ran the function;
    * ``node``: one all_reduce of (rank + 1) through the node's group;
    * ``hess``: sep_dm.hessenberg of ``HA`` with panel width ``hess_nb``,
      as a DistrMatrix with no Q (``eye``) and as whole matrices with Q =
      ``HQ0`` (``q0``), with the gathered H and Q, and each rank's stats,
      V/T hash and calls of ``DistrMatrix.full`` during the stage;
    * ``hess_spec``: sep_dm.hessenberg of ``HA`` as a DistrMatrix under
      each spec, with the gathered H and Q, their specs and shard shapes;
    * ``schur``, ``reorder``: sep_dm.schur of (H, Q) and
      sep_dm.reorder_schur of (S, Qs, sel);
    * ``reduce``: sep_dm.reduce of ``A96`` (Re > 0), then sep_dm.eigenvectors
      of the leading block; ``reduce_rows``: sep_dm.reduce of ``A96``
      sharded by rows, with the specs and shard shapes of S and Q;
    * ``gep``: gep_dm.reduce of (``GA``, ``GB``) (finite, Re > 0).
    """
    import torch
    from starneig_tpu_torch.api import gep_dm, sep_dm
    from starneig_tpu_torch.config import HessenbergConf
    from starneig_tpu_torch.errors import Error
    from starneig_tpu_torch.node import default_mesh, get_node
    from starneig_tpu_torch.parallel import distr
    from starneig_tpu_torch.parallel.dm_core import make_sharded_extent

    mesh = default_mesh()
    res, cnt = {}, {}

    A = arrays["A"]
    d = {}
    for spec in distr.SPECS:
        Ad = distr.distr_matrix_from_array(A, mesh, spec)
        d[spec] = (Ad.to_array(), tuple(Ad.data.shape), Ad.shape)
    Z = distr.distr_matrix_create(5, 7, mesh)
    d["create"] = (Z.to_array(), tuple(Z.data.shape), Z.shape)
    res["distr"] = d
    cnt["distr_shards"] = {k: v[1] for k, v in d.items()}

    stats = {}
    ext = make_sharded_extent(mesh, stats)
    Spad, Qpad = (torch.as_tensor(arrays[k]) for k in ("Spad", "Qpad"))
    out = []
    for op, kw in arrays["ext_cases"]:
        S = distr.shard_of(Spad, mesh, "cols")
        Q = distr.shard_of(Qpad, mesh, "cols")
        val = apply_extent_op(ext, S, Q, op, kw)
        full = [distr.DistrMatrix(M, mesh, "cols", tuple(F.shape)).to_array()
                for M, F in ((S, Spad), (Q, Qpad))]
        out.append((*full, None if val is None else val.numpy()))
    res["extent"] = out
    cnt["extent_stats"] = dict(stats)

    ran = []

    def owned(x):
        ran.append(True)
        return (x * 2, np.array([mesh.rank, 7], np.int32), mesh.rank + 3, 2.5,
                True, Error.PARTIAL_REORDERING, None, np.zeros(2, bool))
    win = ext.window(owned, torch.arange(6, dtype=torch.float64).reshape(2, 3))
    cnt["window"] = (win[0].numpy(), *win[1:], bool(ran))

    nd = get_node()
    t = torch.tensor([float(mesh.rank + 1)])
    distr.all_reduce(t, mesh)
    cnt["node"] = dict(rank=nd.rank, world_size=nd.world_size,
                       backend=nd.backend, sum=float(t[0]))

    res["hess"], cnt["hess"] = {}, {}
    hconf = HessenbergConf(panel_width=arrays["hess_nb"])
    for case, A_in, Q_in in (
            ("eye", distr.distr_matrix_from_array(arrays["HA"], mesh), None),
            ("q0", arrays["HA"], arrays["HQ0"])):
        st = {}
        with counting_full() as calls:
            Hd, QHd = sep_dm.hessenberg(A_in, Q_in, conf=hconf, stats=st)
        res["hess"][case] = dict(H=Hd.to_array(), Q=QHd.to_array())
        cnt["hess"][case] = dict(stats=st, full_calls=calls[0],
                                 shards=(tuple(Hd.data.shape), tuple(QHd.data.shape)))

    res["hess_spec"], cnt["hess_spec"] = {}, {}
    for spec in distr.SPECS:
        Hd, QHd = sep_dm.hessenberg(
            distr.distr_matrix_from_array(arrays["HA"], mesh, spec), conf=hconf)
        res["hess_spec"][spec] = dict(H=Hd.to_array(), Q=QHd.to_array(),
                                      specs=(Hd.spec, QHd.spec))
        cnt["hess_spec"][spec] = (tuple(Hd.data.shape), tuple(QHd.data.shape))

    st = {}
    Sd, Qd, er, ei, info = sep_dm.schur(arrays["H"], arrays["Q"], stats=st)
    res["schur"] = dict(S=Sd.to_array(), Q=Qd.to_array(), er=er.numpy(),
                        ei=ei.numpy(), info=int(info))
    cnt["schur_stats"] = {k: v for k, v in st.items() if k != "aed_log"}

    st = {}
    S2d, Q2d, m, rinfo = sep_dm.reorder_schur(arrays["S"], arrays["Qs"],
                                              arrays["sel"], stats=st)
    res["reorder"] = dict(S=S2d.to_array(), Q=Q2d.to_array(), m=int(m),
                          info=int(rinfo))
    cnt["reorder_stats"] = st

    Sd, Qd, er, ei, nsel, info = sep_dm.reduce(arrays["A96"], positive_real)
    X, xinfo = sep_dm.eigenvectors(Sd, Qd, np.arange(Sd.shape[0]) < nsel)
    res["reduce"] = dict(S=Sd.to_array(), Q=Qd.to_array(), er=er.numpy(),
                         ei=ei.numpy(), nsel=int(nsel), info=int(info),
                         X=X.to_array(), xinfo=int(xinfo))
    cnt["reduce_shards"] = dict(S=tuple(Sd.data.shape), X=tuple(X.data.shape),
                                X_spec=X.spec)

    Sd, Qd, er, ei, nsel, info = sep_dm.reduce(
        distr.distr_matrix_from_array(arrays["A96"], mesh, "rows"), positive_real)
    res["reduce_rows"] = dict(S=Sd.to_array(), Q=Qd.to_array(), er=er.numpy(),
                              ei=ei.numpy(), nsel=int(nsel), info=int(info),
                              specs=(Sd.spec, Qd.spec))
    cnt["reduce_rows_shards"] = (tuple(Sd.data.shape), tuple(Qd.data.shape))

    *mats, ar, ai, bt, nsel, info = gep_dm.reduce(
        arrays["GA"], arrays["GB"], predicate=finite_right_half)
    res["gep"] = dict(zip("STQZ", (M.to_array() for M in mats)), ar=ar.numpy(),
                      ai=ai.numpy(), bt=bt.numpy(), nsel=int(nsel),
                      info=int(info))
    return res, cnt
