"""The port's DM layer (``node``, ``parallel/``, ``api.sep_dm``,
``api.gep_dm``) against the JAX package's, on the CPU.

The port runs in gloo ranks spawned by ``starneig_tpu_torch.testing.dm``:
one spawn for each world size (2 and 4, at the same time) runs every
case (module-scoped fixture), under a timeout.  The JAX DM functions run here, on the
8-device virtual CPU mesh, as ``tests/test_dm.py`` runs them.  Inputs are
numpy arrays made from seeds.  Tolerances:
  * extent ops: get/set ops and ``zero_negligible`` exact, the products
    within 1e-14 max|S|;
  * Schur forms: residual and orthogonality < 500 u, ``schur_form_error``
    exactly 0, sorted eigenvalues within 1e-10 of JAX's and of the port's
    single-process ``schur``;
  * reordering: the same leading block and info as JAX, the selected
    eigenvalues leading, the spectrum kept within 1e-8 max|lambda|;
  * eigenvectors: residual ||A x - lambda x|| / (||A||_F ||x||) < 1e-10;
  * pencils: both residuals and orthogonalities < 500 u, exact structure,
    the spectrum within 1e-10 max|lambda| of JAX's.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from starneig_tpu.api import gep_dm as jgep_dm
from starneig_tpu.api import sep as jsep
from starneig_tpu.api import sep_dm as jsep_dm
from starneig_tpu.parallel import block_cyclic as jbc
from starneig_tpu.parallel import make_mesh as jmake_mesh
from starneig_tpu.parallel.dm_core import reorder_dm as jreorder_dm
from starneig_tpu.parallel.dm_core import schur_dm as jschur_dm
from starneig_tpu.testing import random_dense

from starneig_tpu_torch import node
from starneig_tpu_torch.api import gep_dm, sep, sep_dm
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops.schur import (DenseExtent, _resolve_threshold,
                                          _schur_iter, aed_geometry,
                                          standardize_blocks)
from starneig_tpu_torch.config import SchurConf
from starneig_tpu_torch.parallel import block_cyclic
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.dm import (apply_extent_op, finite_right_half,
                                           positive_real, run_ranks)

torch.set_num_threads(1)

U = np.finfo(np.float64).eps
GATE = 500.0
N = 96                                   # > small_limit 64: the AED path
SPAWN_TIMEOUT_S = 300.0
# the extent-op buffers: NP = 48 columns (shards of 24 or 12), a w = 8
# window inside one shard, straddling two, and at the first and last
# columns; zero_negligible's inner block at P = 6, n = 36
NP, P_EXT, N_EXT, W_EXT = 48, 6, 36, 8
J0S = (0, 2, 8, 20, NP - W_EXT)
DIAG_WS = (0, 8, 20, NP - W_EXT)


def _orth(rng, w):
    return np.linalg.qr(rng.standard_normal((w, w)))[0]


def _extent_inputs():
    rng = np.random.default_rng(11)
    Spad = rng.standard_normal((NP, NP))
    Qpad = rng.standard_normal((N_EXT, NP))
    # negligible subdiagonals of the inner block (S[P+k+1, P+k]): inside a
    # shard, on a shard edge at 4 ranks (k=5, column 11), at 2 ranks (k=17,
    # column 23), and one at k=30, past ihi
    for k in (3, 5, 17, 30):
        Spad[P_EXT + k + 1, P_EXT + k] = 1e-19
    cases = []
    for j0 in J0S:
        cases += [("get_block", dict(i0=3, j0=j0, h=5, w=W_EXT)),
                  ("set_block", dict(M=rng.standard_normal((5, W_EXT)), i0=3, j0=j0)),
                  ("mul_rows", dict(i0=j0, h=W_EXT, Qw=_orth(rng, W_EXT))),
                  ("mul_cols", dict(j0=j0, w=W_EXT, Qw=_orth(rng, W_EXT))),
                  ("mul_cols_q", dict(j0=j0, w=W_EXT, Qw=_orth(rng, W_EXT)))]
    G = len(DIAG_WS)
    Qws = np.stack([_orth(rng, W_EXT) for _ in range(G)])
    cases += [("get_diag_blocks", dict(ws=list(DIAG_WS), w=W_EXT)),
              ("set_diag_blocks", dict(Ms=rng.standard_normal((G, W_EXT, W_EXT)),
                                       ws=list(DIAG_WS))),
              ("mul_rows_batch", dict(ws=list(DIAG_WS), w=W_EXT, Qws=Qws)),
              ("mul_cols_batch", dict(ws=list(DIAG_WS), w=W_EXT, Qws=Qws)),
              ("mul_cols_batch_q", dict(ws=list(DIAG_WS), w=W_EXT, Qws=Qws)),
              ("zero_negligible", dict(P=P_EXT, n=N_EXT, ihi=30, thresh=1e-15))]
    return Spad, Qpad, cases


@pytest.fixture(scope="module")
def ref():
    """Inputs, the JAX DM results on the 8-device mesh and the port's
    single-process Schur form, with the port's suite job running on 2 and
    4 gloo ranks at the same time (``ref["ranks"][world size]`` = (rank
    0's result, every rank's counters))."""
    mesh8 = jmake_mesh(8)
    A = random_dense(N, seed=7)
    H, Q = (np.asarray(M) for M in jsep.hessenberg(A))
    Sj, Qj, erj, eij, infoj = jschur_dm(H, Q, mesh=mesh8)
    Sj, Qj, erj, eij = (np.asarray(M) for M in (Sj, Qj, erj, eij))
    sel = erj > 0
    GA = random_dense(32, seed=3)
    GB = random_dense(32, seed=4) + 3 * np.eye(32)
    Spad, Qpad, cases = _extent_inputs()
    arrays = dict(A=random_dense(64, seed=1), Spad=Spad, Qpad=Qpad,
                  ext_cases=cases, H=H, Q=Q, S=Sj, Qs=Qj, sel=sel, A96=A,
                  GA=GA, GB=GB)
    with ThreadPoolExecutor(2) as pool:
        spawns = {nd: pool.submit(run_ranks, "starneig_tpu_torch.testing.dm:suite",
                                  nd, (arrays,), "cpu", SPAWN_TIMEOUT_S)
                  for nd in (2, 4)}
        S2j, Q2j, mj, rinfoj = jreorder_dm(Sj, Qj, sel, mesh=mesh8)
        red = jsep_dm.reduce(A, predicate=positive_real, mesh=mesh8)
        gred = jgep_dm.reduce(GA, GB, predicate=finite_right_half,
                              mesh=jmake_mesh(4))
        St, Qt, ert, eit, infot = sep.schur(H, Q, device="cpu")
        ranks = {nd: f.result() for nd, f in spawns.items()}
    return dict(
        A=A, H=H, Q=Q, sel=sel, GA=GA, GB=GB, Spad=Spad, Qpad=Qpad, cases=cases,
        ranks=ranks,
        schur=dict(S=Sj, Q=Qj, er=erj, ei=eij, info=int(infoj)),
        schur_sm=dict(S=St.numpy(), Q=Qt.numpy(), er=ert.numpy(), ei=eit.numpy(),
                      info=int(infot)),
        reorder=dict(S=np.asarray(S2j), Q=np.asarray(Q2j), m=int(mj), info=int(rinfoj)),
        reduce=dict(S=red[0].to_array(), Q=red[1].to_array(), er=np.asarray(red[2]),
                    ei=np.asarray(red[3]), nsel=int(red[4]), info=int(red[5])),
        gep=dict(S=gred[0].to_array(), T=gred[1].to_array(), ar=np.asarray(gred[4]),
                 ai=np.asarray(gred[5]), bt=np.asarray(gred[6]), nsel=int(gred[7]),
                 info=int(gred[8])))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, ref):
    """The port's suite job on 2 or 4 gloo ranks: (world size, rank 0's
    result, every rank's counters)."""
    return (request.param, *ref["ranks"][request.param])


def _sorted(er, ei):
    return np.sort_complex(np.asarray(er) + 1j * np.asarray(ei))


def test_distr_matrix(ranks):
    nd, res, cnt = ranks
    A = random_dense(64, seed=1)
    for spec in ("cols", "rows", "replicated"):
        full, _shard, shape = res["distr"][spec]
        np.testing.assert_array_equal(full, A)
        assert shape == (64, 64)
    zeros, _shard, shape = res["distr"]["create"]
    assert shape == (5, 7) and not zeros.any()
    for c in cnt:
        sh = c["distr_shards"]
        assert sh["cols"] == (64, 64 // nd) and sh["rows"] == (64 // nd, 64)
        assert sh["replicated"] == (64, 64)
        assert sh["create"] == (5, len(np.array_split(np.arange(7), nd)[c["rank"]]))


def test_extent_ops(ranks, ref):
    """Each ShardedExtent op equals DenseExtent's on the whole buffers."""
    nd, res, cnt = ranks
    assert len(res["extent"]) == len(ref["cases"])
    for (op, kw), (S, Q, val) in zip(ref["cases"], res["extent"]):
        Sd, Qd = torch.tensor(ref["Spad"]), torch.tensor(ref["Qpad"])
        dval = apply_extent_op(DenseExtent, Sd, Qd, op, kw)
        tol = 0.0 if op.startswith(("get_", "set_", "zero_")) \
            else 1e-14 * np.abs(ref["Spad"]).max()
        for got, want, what in ((S, Sd.numpy(), "S"), (Q, Qd.numpy(), "Q")):
            err = np.abs(got - want).max()
            assert err <= tol, (op, kw.get("j0"), what, err)
        if dval is not None:
            err = np.abs(val - dval.numpy()).max()
            assert err <= tol, (op, kw.get("j0"), err)
    assert all(c["extent_stats"]["all_reduce"] > 0 for c in cnt)


def test_window_owner_computes(ranks):
    """ShardedExtent.window runs the function on rank 0 only; every rank
    returns rank 0's outputs, of the same types."""
    nd, _res, cnt = ranks
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    for c in cnt:
        out, ids, k, f, b, err, none, flags, ran = c["window"]
        np.testing.assert_array_equal(out, 2 * x)
        assert ids.dtype == np.int32 and ids.tolist() == [0, 7]
        assert (k, f, b, err, none) == (3, 2.5, True, Error.PARTIAL_REORDERING, None)
        assert isinstance(err, Error) and flags.dtype == bool and not flags.any()
        assert ran == (c["rank"] == 0)


def test_node_all_reduce(ranks):
    """node_init over a FileStore, one all_reduce, node_finalize (the
    counterpart of tests/test_multiprocess.py)."""
    nd, _res, cnt = ranks
    for r, c in enumerate(cnt):
        assert c["node"] == dict(rank=r, world_size=nd, backend="gloo",
                                 sum=nd * (nd + 1) / 2)
        assert c["backend"] == "gloo" and c["device"] == "cpu"


def test_schur_dm(ranks, ref):
    """sep_dm.schur at n=96 (seed 7) against JAX schur_dm and the port's
    single-process schur."""
    nd, res, cnt = ranks
    r = res["schur"]
    assert r["info"] == ref["schur"]["info"] == ref["schur_sm"]["info"] == 0
    ev = _sorted(r["er"], r["ei"])
    for other in (ref["schur"], ref["schur_sm"]):
        assert np.abs(ev - _sorted(other["er"], other["ei"])).max() <= 1e-10
    assert hooks.residual_sep(ref["A"], r["S"], r["Q"]) < GATE
    assert hooks.orthogonality(r["Q"]) < GATE
    assert hooks.schur_form_error(torch.as_tensor(r["S"])) == 0.0
    for c in cnt:
        st = c["schur_stats"]
        assert st["path"] == "aed" and st["all_reduce"] > 0 and st["broadcast"] > 0
        assert st["shard_shape"] == (st["NP"], st["NP"] // nd)


def test_reorder_dm(ranks, ref):
    """sep_dm.reorder_schur of JAX's Schur form against JAX reorder_dm."""
    nd, res, cnt = ranks
    r, j = res["reorder"], ref["reorder"]
    assert (r["m"], r["info"]) == (j["m"], j["info"]) == (int(ref["sel"].sum()), 0)
    er, ei = sep.eigenvalues(r["S"], device="cpu")
    after = er.numpy() + 1j * ei.numpy()
    before = ref["schur"]["er"] + 1j * ref["schur"]["ei"]
    assert (after[:r["m"]].real > 0).all() and (after[r["m"]:].real <= 0).all()
    assert hooks.eigenvalue_error(after, before) * U < 1e-8
    assert hooks.residual_sep(ref["A"], r["S"], r["Q"]) < GATE
    assert hooks.schur_form_error(torch.as_tensor(r["S"])) == 0.0
    for c in cnt:
        assert c["reorder_stats"]["windows"] > 0 and c["reorder_stats"]["all_reduce"] > 0


def _eigvec_residual(A, S, X, m):
    """Worst ||A x - lambda x|| / (||A||_F ||x||) over the eigenvectors X of
    the leading m x m block of S (a real column per real eigenvalue, a
    (Re, Im) column pair per complex pair)."""
    er, ei = (t.numpy() for t in sep.eigenvalues(S[:m, :m], device="cpu"))
    worst, j = 0.0, 0
    while j < m:
        if ei[j] != 0:
            x = X[:, j] + 1j * X[:, j + 1]
            lam = er[j] + 1j * abs(ei[j])
            step = 2
        else:
            x, lam, step = X[:, j], er[j], 1
        r = np.linalg.norm(A @ x - lam * x) / (np.linalg.norm(A) * np.linalg.norm(x))
        worst, j = max(worst, r), j + step
    return worst


def test_sep_dm_reduce(ranks, ref):
    """sep_dm.reduce at n=96 against JAX sep_dm.reduce (test_dm.py:158-172)."""
    nd, res, cnt = ranks
    r, j = res["reduce"], ref["reduce"]
    A = ref["A"]
    assert r["info"] == j["info"] == 0
    assert r["nsel"] == j["nsel"] == int((np.linalg.eigvals(A).real > 0).sum())
    assert (r["er"][:r["nsel"]] > 0).all()
    assert np.abs(_sorted(r["er"], r["ei"]) - _sorted(j["er"], j["ei"])).max() <= 1e-10
    assert hooks.residual_sep(A, r["S"], r["Q"]) < GATE
    assert hooks.orthogonality(r["Q"]) < GATE
    assert hooks.schur_form_error(torch.as_tensor(r["S"])) == 0.0
    for c in cnt:
        assert c["reduce_shards"]["S"] == (N, N // nd)


def test_sep_dm_eigenvectors(ranks, ref):
    nd, res, cnt = ranks
    r = res["reduce"]
    m = r["nsel"]
    assert r["xinfo"] == 0 and r["X"].shape == (N, m)
    assert _eigvec_residual(ref["A"], r["S"], r["X"], m) < 1e-10
    spec = "cols" if m % nd == 0 else "rows"
    for c in cnt:
        assert c["reduce_shards"]["X_spec"] == spec


def test_gep_dm_reduce(ranks, ref):
    """gep_dm.reduce at n=32 against JAX gep_dm.reduce (test_dm.py:49-58),
    with the finite right-half-plane eigenvalues reordered to the top."""
    nd, res, cnt = ranks
    r, j = res["gep"], ref["gep"]
    assert r["info"] == j["info"] == 0 and r["nsel"] == j["nsel"]
    ra, rb = hooks.residual_gep(ref["GA"], ref["GB"], r["S"], r["T"], r["Q"], r["Z"])
    assert ra < GATE and rb < GATE
    assert hooks.orthogonality(r["Q"]) < GATE and hooks.orthogonality(r["Z"]) < GATE
    assert hooks.schur_structure_error(r["S"]) == 0.0
    assert hooks.triangular_structure_error(r["T"]) == 0.0
    lam = (r["ar"] + 1j * r["ai"]) / r["bt"]
    lamj = (j["ar"] + 1j * j["ai"]) / j["bt"]
    assert (lam[:r["nsel"]].real > 0).all()
    assert hooks.eigenvalue_error(lam, lamj) * U < 1e-10


@pytest.mark.parametrize("m,n,mb,nb,prows,pcols", [
    (37, 29, 8, 8, 2, 3), (64, 64, 16, 8, 2, 2), (10, 23, 3, 5, 3, 1)])
def test_block_cyclic(m, n, mb, nb, prows, pcols):
    """The port's block_cyclic copy against the JAX package's (as
    test_dm.py:116-122), exactly."""
    A = random_dense(max(m, n), seed=9)[:m, :n]
    mine = block_cyclic.scatter(A, block_cyclic.BlockCyclicDescr(m, n, mb, nb, prows, pcols))
    theirs = jbc.scatter(A, jbc.BlockCyclicDescr(m, n, mb, nb, prows, pcols))
    assert mine.keys() == theirs.keys() and len(mine) == prows * pcols
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    d = block_cyclic.BlockCyclicDescr(m, n, mb, nb, prows, pcols)
    np.testing.assert_array_equal(block_cyclic.gather(mine, d), A)


DM_ENTRY_POINTS = ["node_init", "sep_dm.hessenberg", "sep_dm.schur",
                   "sep_dm.reorder_schur", "sep_dm.eigenvectors", "sep_dm.reduce",
                   "gep_dm.hessenberg_triangular", "gep_dm.schur",
                   "gep_dm.reorder_schur", "gep_dm.eigenvectors", "gep_dm.reduce"]


def _dm_call(name, **kw):
    """Entry point ``name`` on a small problem, in this process (a world of
    one)."""
    rng = np.random.default_rng(5)
    n = 8
    A, B = rng.standard_normal((n, n)), rng.standard_normal((n, n)) + 3 * np.eye(n)
    T, I = np.triu(B), np.eye(n)
    S = np.triu(A)
    sel = np.arange(n) < 2
    if name == "node_init":
        try:
            return node.node_init(**kw)
        finally:
            node.node_finalize()
    mod, fn = name.split(".")
    args = {"hessenberg": (A,), "schur": (np.triu(A, -1), I),
            "reorder_schur": (S, I, sel), "eigenvectors": (S, I, sel),
            "reduce": (A, positive_real),
            "hessenberg_triangular": (A, B), "gep_schur": (np.triu(A, -1), T, I, I),
            "gep_reorder_schur": (S, T, I, I, sel),
            "gep_eigenvectors": (S, T, I, I, sel),
            "gep_reduce": (A, B, finite_right_half)}
    key = fn if mod == "sep_dm" or fn == "hessenberg_triangular" else f"gep_{fn}"
    return getattr({"sep_dm": sep_dm, "gep_dm": gep_dm}[mod], fn)(*args[key], **kw)


@pytest.mark.parametrize("name", DM_ENTRY_POINTS)
def test_dm_needs_the_card_unless_asked(name):
    """Without a card, a DM entry point (and node_init) that leaves the
    device to its default raises; with device="cpu" it runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _dm_call(name)
    assert not node.node_initialized()
    out = _dm_call(name, device="cpu")
    assert out is not None
    assert not node.node_initialized()


class _CountingExtent(DenseExtent):
    """DenseExtent that counts the uses of each of its methods."""

    def __init__(self):
        self.calls = {}

    def __getattribute__(self, name):
        attr = object.__getattribute__(self, name)
        if callable(attr) and not name.startswith("__"):
            calls = object.__getattribute__(self, "calls")
            calls[name] = calls.get(name, 0) + 1
        return attr


def test_schur_iter_routes_through_ext(ref):
    """_schur_iter with an explicit ext: a counting DenseExtent sees every
    full-extent access of the rounds (each op at least once), and the
    result equals the default call's (``schur`` at n=96, which runs
    ``_schur_iter`` with ``ext=DenseExtent``) bit for bit."""
    H, Q = torch.tensor(ref["H"]), torch.tensor(ref["Q"])
    conf = SchurConf().resolve(N)
    WA, NS, B, _WC, TMAX, P = aed_geometry(N, conf)
    Spad = H.new_zeros((N + 2 * P, N + 2 * P))
    Spad[P:P + N, P:P + N] = H
    Qpad = H.new_zeros((N, N + 2 * P))
    Qpad[:, P:P + N] = Q
    counting = _CountingExtent()
    ihi, fail, rounds = _schur_iter(
        Spad, Qpad, _resolve_threshold(H, conf), torch.eye(WA, dtype=H.dtype),
        P=P, WA=WA, NS=NS, B=B, TMAX=TMAX, nibble=conf.aed_nibble,
        itmax=conf.iteration_limit, n=N, ext=counting)
    assert (ihi, fail) == (0, 0) and rounds > 1
    S, Qf = standardize_blocks(Spad[P:P + N, P:P + N], Qpad[:, P:P + N])
    assert torch.equal(S, torch.tensor(ref["schur_sm"]["S"]))
    assert torch.equal(Qf, torch.tensor(ref["schur_sm"]["Q"]))
    calls = counting.calls
    for op in ("zero_negligible", "get_block", "set_block", "mul_rows", "mul_cols",
               "window", "get_diag_blocks", "set_diag_blocks", "mul_rows_batch",
               "mul_cols_batch"):
        assert calls.get(op, 0) > 0, (op, calls)
