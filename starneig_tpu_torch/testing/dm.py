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
from typing import Optional

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


def _out_bytes(outs):
    """Bytes of this rank's shards among a stage's outputs (DistrMatrix)."""
    from starneig_tpu_torch.parallel.distr import DistrMatrix
    return sum(8 * M.data.numel() for M in outs if isinstance(M, DistrMatrix))


def _warm(mesh):
    """One small product on the card first: cuBLAS takes its workspace
    (32 MiB on an H100) from the caching allocator on a process's first
    product, which would otherwise count in the peak memory of the first
    stage that multiplies (a rank that ran nothing before it)."""
    import torch
    if mesh.device.type == "cuda":
        x = torch.ones((8, 8), dtype=torch.float64, device=mesh.device)
        x @ x
        torch.cuda.synchronize(mesh.device)


def _run_stage(name, fn, mesh, rec: dict):
    """Run one stage ``fn(stats)`` with its own stats dict, ended as
    :func:`_stage` ends one; ``rec[name]``: its stats, its calls of
    ``DistrMatrix.full``, its this-rank shard bytes (the padded working
    shards and the output shards) and, on a card, its peak device memory
    beyond what was allocated when it began (``peak_bytes``).  Returns
    fn's outputs."""
    import torch
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
    st = {}
    with counting_full() as calls:
        out = fn(st)
    _stage(mesh)
    outs = out if isinstance(out, tuple) else (out,)
    rec[name] = dict(stats=st, full_calls=calls[0],
                     shard_bytes=st.get("work_bytes", 0) + _out_bytes(outs),
                     peak_bytes=(torch.cuda.max_memory_allocated(mesh.device)
                                 - base) if cuda else None)
    return out


def sep_chain(A, predicate: str = "positive_real"):
    """api.sep_dm: hessenberg -> schur -> select -> reorder_schur ->
    eigenvectors of the leading selected block, each stage ended by a
    barrier and timed (``<stage>_ms``), each with its own collective
    counts, calls of ``DistrMatrix.full``, shard bytes and (on a card)
    peak device memory (``stages``, :func:`_run_stage`).  Result: H and Q
    after the reduction (``H``, ``QH``), S and Q after Schur and after
    reordering, X, the eigenvalues and the info codes, gathered after the
    stages."""
    from starneig_tpu_torch.api import sep_dm
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr_matrix_from_array

    mesh = default_mesh()
    n = A.shape[0]
    rec = {}
    _warm(mesh)
    Ad = distr_matrix_from_array(A, mesh)
    t0 = _stage(mesh)
    Hd, QHd = _run_stage("hessenberg", lambda st: sep_dm.hessenberg(Ad, stats=st),
                         mesh, rec)
    t1 = time.perf_counter()
    Sd, Qd, er, ei, info = _run_stage(
        "schur", lambda st: sep_dm.schur(Hd, QHd, stats=st), mesh, rec)
    t2 = time.perf_counter()
    sel = _run_stage("select", lambda st: sep_dm.select(
        Sd, PREDICATES[predicate], stats=st), mesh, rec)
    t3 = time.perf_counter()
    S2d, Q2d, m, rinfo = _run_stage(
        "reorder", lambda st: sep_dm.reorder_schur(Sd, Qd, sel, stats=st), mesh, rec)
    t4 = time.perf_counter()
    X, xinfo = _run_stage("eigenvectors", lambda st: sep_dm.eigenvectors(
        S2d, Q2d, np.arange(n) < m, stats=st), mesh, rec)
    t5 = time.perf_counter()
    ms = dict(hessenberg_ms=(t1 - t0) * 1e3, schur_ms=(t2 - t1) * 1e3,
              select_ms=(t3 - t2) * 1e3, reorder_ms=(t4 - t3) * 1e3,
              eigenvectors_ms=(t5 - t4) * 1e3)
    result = dict(H=Hd.to_array(), QH=QHd.to_array(), S=Sd.to_array(),
                  Q=Qd.to_array(), er=er.cpu().numpy(), ei=ei.cpu().numpy(),
                  info=int(info), selected=int(sel.sum()), S2=S2d.to_array(),
                  Q2=Q2d.to_array(), m=int(m), rinfo=int(rinfo),
                  X=X.to_array(), xinfo=int(xinfo))
    return result, dict(ms, stats={k: v["stats"] for k, v in rec.items()},
                        stages=rec,
                        shards=dict(H=tuple(Hd.data.shape), S=tuple(Sd.data.shape),
                                    S2=tuple(S2d.data.shape),
                                    X=tuple(X.data.shape), X_spec=X.spec))


def gep_chain(A, B, predicate: str = "finite_right_half"):
    """api.gep_dm: hessenberg_triangular -> schur -> select ->
    reorder_schur -> eigenvectors of the leading selected block, each
    stage ended by a barrier, timed (``<stage>_ms``) and recorded as in
    :func:`sep_chain` (``stages``).  Result: the pencil after each of HT,
    Schur and reordering (gathered after the stages), the eigenvalues,
    the leading block, X and the info codes, and the Schur stage's
    rounds."""
    from starneig_tpu_torch.api import gep_dm
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr_matrix_from_array

    mesh = default_mesh()
    n = A.shape[0]
    _warm(mesh)
    rec, ts = {}, [_stage(mesh)]
    Ad, Bd = (distr_matrix_from_array(M, mesh) for M in (A, B))
    ht = _run_stage("hessenberg_triangular",
                    lambda st: gep_dm.hessenberg_triangular(Ad, Bd, stats=st),
                    mesh, rec)
    ts.append(time.perf_counter())
    *sch, ar, ai, bt, info = _run_stage(
        "schur", lambda st: gep_dm.schur(*ht, stats=st), mesh, rec)
    ts.append(time.perf_counter())
    sel = _run_stage("select", lambda st: gep_dm.select(
        *sch[:2], PREDICATES[predicate], stats=st), mesh, rec)
    ts.append(time.perf_counter())
    *reo, m, rinfo = _run_stage(
        "reorder", lambda st: gep_dm.reorder_schur(*sch, sel, stats=st), mesh, rec)
    ts.append(time.perf_counter())
    X, xinfo = _run_stage("eigenvectors", lambda st: gep_dm.eigenvectors(
        *reo, np.arange(n) < m, stats=st), mesh, rec)
    ts.append(time.perf_counter())
    names = ("hessenberg_triangular", "schur", "select", "reorder", "eigenvectors")
    ms = {f"{k}_ms": (b - a) * 1e3 for k, a, b in zip(names, ts, ts[1:])}
    gather = lambda ms_: {k: M.to_array() for k, M in zip("STQZ", ms_)}  # noqa: E731
    result = dict(ht=gather(ht), schur=gather(sch), reorder=gather(reo),
                  ar=ar.cpu().numpy(), ai=ai.cpu().numpy(), bt=bt.cpu().numpy(),
                  info=int(info), selected=int(sel.sum()), m=int(m),
                  rinfo=int(rinfo), X=X.to_array(), xinfo=int(xinfo),
                  rounds=rec["schur"]["stats"].get("rounds"))
    return result, dict(ms, stats={k: v["stats"] for k, v in rec.items()},
                        stages=rec,
                        shards={k: tuple(v[0].data.shape) for k, v in
                                (("ht", ht), ("schur", sch), ("reorder", reo))})


def ht_stage(A, B):
    """api.gep_dm.hessenberg_triangular of the column-sharded pencil (A,
    B), recorded as :func:`gep_chain` records a stage (``stages``); the
    result: H, T, Q, Z gathered after the stage."""
    from starneig_tpu_torch.api import gep_dm
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr_matrix_from_array

    mesh = default_mesh()
    _warm(mesh)
    rec = {}
    Ad, Bd = (distr_matrix_from_array(M, mesh) for M in (A, B))
    t0 = _stage(mesh)
    out = _run_stage("hessenberg_triangular",
                     lambda st: gep_dm.hessenberg_triangular(Ad, Bd, stats=st), mesh, rec)
    ms = (time.perf_counter() - t0) * 1e3
    return (dict(zip("HTQZ", (M.to_array() for M in out))),
            dict(hessenberg_triangular_ms=ms, stats={k: v["stats"] for k, v in rec.items()},
                 stages=rec))


@contextlib.contextmanager
def staged(module, names, mesh, ms: dict, rec: Optional[dict] = None):
    """Time the stages that ``module``'s functions ``names`` run inside a
    call of another of its functions (``api.sep_dm.reduce`` calls its
    ``hessenberg``, ``schur``, ... as module globals): each stage ends as
    :func:`_stage` ends one, and ``ms[name + "_ms"]`` is its time from
    the end of the stage before it (the first from entering the block).
    With ``rec`` a dict, each stage is recorded as :func:`_run_stage`
    records one (with its own stats dict in place of the caller's), its
    outputs in ``rec[name]["out"]``."""
    orig = {k: getattr(module, k) for k in names}
    last = [time.perf_counter()]

    def wrap(name, fn):
        def timed_stage(*a, **kw):
            if rec is None:
                out = fn(*a, **kw)
            else:
                out = _run_stage(name, lambda st: fn(*a, **dict(kw, stats=st)),
                                 mesh, rec)
                rec[name]["out"] = out
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
      sep_dm.reorder_schur of (S, Qs, sel), each with its stats and its
      calls of ``DistrMatrix.full``;
    * ``reduce``: sep_dm.reduce of ``A96`` (Re > 0), with its stats and
      calls of ``DistrMatrix.full``, then sep_dm.eigenvectors of the
      leading block, with its own; ``reduce_rows``: sep_dm.reduce of ``A96``
      sharded by rows, with the specs and shard shapes of S and Q;
    * ``gep``: gep_dm.reduce of (``GA``, ``GB``) (finite, Re > 0).
    """
    import torch
    from starneig_tpu_torch.api import gep_dm, sep_dm
    from starneig_tpu_torch.config import HessenbergConf
    from starneig_tpu_torch.errors import Error
    from starneig_tpu_torch.node import default_mesh, get_node
    from starneig_tpu_torch.parallel import distr
    from starneig_tpu_torch.parallel.dm_core import ShardedExtent, split_cuts

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
    Spad, Qpad = (torch.as_tensor(arrays[k]) for k in ("Spad", "Qpad"))
    ext = ShardedExtent(mesh, stats, split_cuts(Spad.shape[1], mesh.size))
    out = []
    for op, kw in arrays["ext_cases"]:
        S = distr.shard_of(Spad, mesh, "cols")
        Q = distr.shard_of(Qpad, mesh, "cols")
        val = apply_extent_op(ext, dict(S=S, Q=Q), op, kw)
        full = [distr.DistrMatrix(M, mesh, "cols", tuple(F.shape)).to_array()
                for M, F in ((S, Spad), (Q, Qpad))]
        out.append((*full, val))
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
    with counting_full() as calls:
        Sd, Qd, er, ei, info = sep_dm.schur(arrays["H"], arrays["Q"], stats=st)
    res["schur"] = dict(S=Sd.to_array(), Q=Qd.to_array(), er=er.numpy(),
                        ei=ei.numpy(), info=int(info))
    cnt["schur_stats"] = {k: v for k, v in st.items() if k != "aed_log"}
    cnt["schur_full_calls"] = calls[0]

    st = {}
    with counting_full() as calls:
        S2d, Q2d, m, rinfo = sep_dm.reorder_schur(arrays["S"], arrays["Qs"],
                                                  arrays["sel"], stats=st)
    res["reorder"] = dict(S=S2d.to_array(), Q=Q2d.to_array(), m=int(m),
                          info=int(rinfo))
    cnt["reorder_stats"] = st
    cnt["reorder_full_calls"] = calls[0]

    st = {}
    with counting_full() as calls:
        Sd, Qd, er, ei, nsel, info = sep_dm.reduce(arrays["A96"], positive_real,
                                                   stats=st)
    cnt["reduce_stats"] = {k: v for k, v in st.items() if k != "aed_log"}
    cnt["reduce_full_calls"] = calls[0]
    st = {}
    with counting_full() as calls:
        X, xinfo = sep_dm.eigenvectors(Sd, Qd, np.arange(Sd.shape[0]) < nsel, stats=st)
    cnt["eigenvectors_stats"] = st
    cnt["eigenvectors_full_calls"] = calls[0]
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


def _resolve(bufs: dict, x, device):
    """A pencil op's argument: a buffer name -> the buffer, a sequence of
    names -> the buffers, an (name, c, s) item list -> the items, float64
    arrays -> tensors, int arrays -> index tensors."""
    import torch
    if isinstance(x, str) and x in bufs:
        return bufs[x]
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if isinstance(x, (list, tuple)) and x and all(isinstance(v, str) for v in x):
        return [bufs[v] for v in x]
    if isinstance(x, list) and x and isinstance(x[0], tuple):
        return [(bufs[M], *(torch.as_tensor(v, device=device) for v in cs))
                for M, *cs in x]
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], np.ndarray):
        return [torch.as_tensor(v, device=device) for v in x]
    return x


def apply_extent_op(ext, bufs: dict, op: str, kw: dict):
    """Apply one extent op (``DenseExtent`` or a sharded extent) in place
    on the named buffers ``bufs`` (their shards for a sharded extent);
    ``kw`` names buffers by their keys.  Returns the op's value as numpy
    (a list of arrays for a list), None for the in-place ops."""
    dev = next(iter(bufs.values())).device
    val = getattr(ext, op)(**{k: _resolve(bufs, v, dev) for k, v in kw.items()})
    if val is None:
        return None
    if isinstance(val, list):
        return [v.cpu().numpy() for v in val]
    return val.cpu().numpy()


def gep_suite(arrays: dict):
    """The CPU job of ``tests/test_torch_dm_gep.py``: one spawn serves it.

    * ``extent``: each (op, kwargs) of ``ext_cases`` applied by the sharded
      extent (cuts ``dm_core.pad_cuts(N_inner, P)``, ``wmax``) to column shards of the
      padded buffers ``bufs``, with the gathered buffers and the value after
      each;
    * ``gep``: gep_dm.reduce of (``GA``, ``GB``) (finite, Re > 0), each
      stage recorded (:func:`staged`: stats, ``DistrMatrix.full`` calls)
      with its outputs gathered after it: the HT form, the Schur
      form with its eigenvalues, info and rounds, the selection, the
      reordered form with its leading block and info, and reduce's own
      eigenvalues; then gep_dm.schur of the given HT form ``HT``
      (``schur_same``: the pencil gathered, eigenvalues, info, rounds, each
      train's (l, ihi, S[ihi, ihi-1]), ``hooks.train_bottoms``, and qz_log) and
      (rank 0) the single-process ``gep.schur`` of the chain's own HT form
      (``sm_own``: eigenvalues, info, rounds).
    """
    import torch
    from starneig_tpu_torch.api import gep_dm
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr
    from starneig_tpu_torch.parallel.dm_core import ShardedExtent, pad_cuts
    from starneig_tpu_torch.testing.hooks import train_bottoms

    mesh = default_mesh()
    res, cnt = {}, {}
    cuts = pad_cuts(arrays["n_inner"], arrays["P"], mesh.size)
    a, b = cuts[mesh.rank], cuts[mesh.rank + 1]
    stats = {}
    ext = ShardedExtent(mesh, stats, cuts, wmax=arrays["wmax"])
    out = []
    for op, kw in arrays["ext_cases"]:
        bufs = {k: torch.as_tensor(v)[:, a:b].clone() for k, v in arrays["bufs"].items()}
        val = apply_extent_op(ext, bufs, op, kw)
        full = {}
        for k, M in bufs.items():
            F = M.new_zeros(arrays["bufs"][k].shape)
            F[:, a:b] = M
            full[k] = distr.all_reduce(F, mesh).numpy()
        out.append((full, val))
    res["extent"] = out
    cnt["extent_stats"] = dict(stats)
    cnt["cuts"] = cuts

    rec = {}
    with staged(gep_dm, ("hessenberg_triangular", "schur", "select", "reorder_schur",
                         "eigenvalues"), mesh, {}, rec), counting_full() as calls:
        *mats, ar, ai, bt, nsel, info = gep_dm.reduce(
            arrays["GA"], arrays["GB"], predicate=finite_right_half)
    gather = lambda ms: {k: M.to_array() for k, M in zip("STQZ", ms)}  # noqa: E731
    sch = rec["schur"]["out"]
    reo = rec["reorder_schur"]["out"]
    res["gep"] = dict(
        ht=gather(rec["hessenberg_triangular"]["out"]),
        schur=dict(gather(sch[:4]), ar=sch[4].numpy(), ai=sch[5].numpy(),
                   bt=sch[6].numpy(), info=int(sch[7]),
                   rounds=rec["schur"]["stats"].get("rounds")),
        sel=rec["select"]["out"],
        reorder=dict(gather(reo[:4]), m=int(reo[4]), info=int(reo[5])),
        final=dict(gather(mats), ar=ar.numpy(), ai=ai.numpy(), bt=bt.numpy(),
                   nsel=int(nsel), info=int(info)))
    st = {}
    with train_bottoms() as bottoms:
        same = gep_dm.schur(*(arrays["HT"][k] for k in "STQZ"), stats=st)
    res["gep"]["schur_same"] = dict(gather(same[:4]), ar=same[4].numpy(), ai=same[5].numpy(),
                                    bt=same[6].numpy(), info=int(same[7]),
                                    rounds=st.get("rounds"), bottoms=bottoms,
                                    qz_log=st.get("qz_log"))
    if mesh.rank == 0:
        # the single-process QZ of the chain's own HT form, the reference of
        # its QZ on shards (the HT on shards agrees with the single-process
        # one to rounding, and a pencil's spectrum may be ill-conditioned)
        from starneig_tpu_torch.api import gep as _gep
        st = {}
        out = _gep.schur(*(torch.as_tensor(M) for M in res["gep"]["ht"].values()),
                         stats=st, device=mesh.device)
        res["gep"]["sm_own"] = dict(ar=out[4].cpu().numpy(), ai=out[5].cpu().numpy(),
                                    bt=out[6].cpu().numpy(), info=int(out[7]),
                                    rounds=st["rounds"])
    cnt["gep_stages"] = {
        k: dict(full_calls=v["full_calls"],
                stats={s_: x for s_, x in v["stats"].items() if s_ != "qz_log"},
                shards=[tuple(M.data.shape) for M in v["out"]
                        if isinstance(M, distr.DistrMatrix)]
                if isinstance(v["out"], tuple) else [])
        for k, v in rec.items()}
    cnt["gep_full_calls"] = calls[0]
    return res, cnt



def shard_suite(arrays: dict):
    """The CPU job of the DM tests of the stages that PR 20 left gathered:
    one spawn serves them.

    * ``ht``: the cascade on column shards (``dm_ht.ht_cascade_dm``) of the
      triangularized pencil ``tri`` (A1, R, Q1, Z1), gathered after it,
      with its rotation log (the blocks' gathered logs); then ``gep_dm.hessenberg_triangular`` of the
      pencil (``HA``, ``HB``) as column-sharded DistrMatrix, gathered,
      with its stats, its calls of ``DistrMatrix.full`` and its shard
      shapes;
    * ``eig``: for each case of ``eig_cases`` ((name, S, T or None, Q, Z,
      selection)), ``sep_dm.eigenvectors`` (T None) or
      ``gep_dm.eigenvectors`` of the column-sharded Schur form, X
      gathered, with its info, spec, stats and calls of
      ``DistrMatrix.full``.
    """
    import torch
    from starneig_tpu_torch.api import gep_dm, sep_dm
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr, dm_ht
    from starneig_tpu_torch.parallel.dm_core import gathered

    mesh = default_mesh()
    res, cnt = {}, {}
    tri = [distr.shard_of(torch.as_tensor(M), mesh, "cols") for M in arrays["tri"]]
    n = tri[0].shape[0]
    st = {}
    log = []
    with counting_full() as calls:
        outs = dm_ht.ht_cascade_dm(*tri, mesh, st, log=log)
    res["cascade"] = dict(zip("ATQZ", (gathered(M, n, mesh).numpy() for M in outs)),
                          rot=torch.cat(log).numpy())
    cnt["cascade"] = dict(stats=st, full_calls=calls[0])
    Ad, Bd = (distr.distr_matrix_from_array(arrays[k], mesh) for k in ("HA", "HB"))
    st = {}
    with counting_full() as calls:
        ht = gep_dm.hessenberg_triangular(Ad, Bd, stats=st)
    res["ht"] = {k: M.to_array() for k, M in zip("HTQZ", ht)}
    cnt["ht"] = dict(stats=st, full_calls=calls[0],
                     shards=[tuple(M.data.shape) for M in ht], specs=[M.spec for M in ht])
    res["eig"], cnt["eig"] = {}, {}
    for name, S, T, Q, Z, sel in arrays["eig_cases"]:
        mats = [distr.distr_matrix_from_array(M, mesh) if M is not None else None
                for M in (S, T, Q, Z)]
        st = {}
        with counting_full() as calls:
            if T is None:
                X, info = sep_dm.eigenvectors(mats[0], mats[2], sel, stats=st)
            else:
                X, info = gep_dm.eigenvectors(*mats, sel, stats=st)
        res["eig"][name] = dict(X=X.to_array(), info=int(info), spec=X.spec)
        cnt["eig"][name] = dict(stats=st, full_calls=calls[0], shard=tuple(X.data.shape))
    return res, cnt
