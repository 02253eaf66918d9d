"""The port's GEP DM stages on column shards (``api.gep_dm``,
``parallel/dm_gep.py``, ``parallel/dm_ht.py``, ``parallel/dm_eig.py``) and
the extent operations they use, against the JAX package's ``gep_dm`` and
the port's single-process ``api.gep``, on the CPU.

The port runs in gloo ranks spawned by ``starneig_tpu_torch.testing.dm``
(one ``gep_suite`` spawn for each world size, 2 and 4, at the same time as
the JAX references run here on a 4-device virtual CPU mesh).  The pencil
is ``known_spectrum_pencil(96, 0.3, 0.1, seed=0)`` (n=96 > the small
limit 64: AED rounds, B-bulge sweeps and the windowed infinite push), its
HT form made here by the port's single-process
``gep.hessenberg_triangular`` and by the DM run's owner.  Tolerances:
  * extent ops on shards that follow ``dm_core.pad_cuts`` (uneven at 4
    ranks: the widths 16, 9, 9, 15; a batch of windows packed two to a
    message): reads, writes, diagonals and rotation
    pairs bit-equal to ``DenseExtent`` on the whole buffers, the products
    within 1e-14 max|S| (the sharded products multiply a gathered copy of
    the panel, as ``tests/test_torch_dm.py::test_extent_ops`` allows);
  * the QZ iteration and the reordering through an extent: bit-equal to
    the default calls;
  * QZ: info equal to JAX's and the single-process run's on the same HT
    form (the single-process one; and the DM chain's own against the
    single-process run on it: the HT on shards agrees with the
    single-process one to rounding only, and this pencil's spectrum moves
    by 1e-4 chordal under rounding); the spectrum within 1e-10 chordal of
    the single-process run's after matching, and within 1e-9 of JAX's
    (the port's single-process QZ itself lies 3.9e-10 from JAX's on this
    pencil, whose eigenvalues are ill-conditioned: 8e-5 chordal from the
    planted ones); the same count of |beta| <= 1e-12 max|beta|; residuals
    and orthogonalities < 500 u; exact structure; rounds within 2 of the
    single-process run; the HT form itself under the same gates;
  * reordering: leading block and info equal to JAX's, the selected
    eigenvalues leading, the spectrum moved < 1e-10 chordal;
  * no stage calls ``DistrMatrix.full``, and no message of one is larger
    than one panel of each of the pencil's four matrices: 4 x NP x max(WA,
    WC) float64 for QZ, 4 x n x W for the reordering (its owner's hand-out
    adds O(n) vectors: the window's selection and subdiagonal), 4 x n x
    (L + nb) for HT (a sliver window's panels).

The stages that PR 20 left gathered (HT and both eigenvector stages) run
in one more job, ``shard_suite``, on 2 and 3 gloo ranks:
  * the HT cascade on column shards, from the single-process
    triangularized input of a regular pencil (n=96; B random + 3 I: the
    cascade of a singular B is unstable under one ulp,
    ``tests/test_torch_gep_ht.py::test_ht_one_ulp``): the rotation log
    within 1e-13 of ``ht_blocked``'s with the plain twins, H, T, Q, Z within
    1e-12 ||.||_F of it;
  * the whole HT stage against JAX's ``gep.hessenberg_triangular`` (CPU,
    x64): exact structure, residuals and orthogonalities < 500 u, the
    generalized eigenvalues within 1e-10 chordal of JAX's;
  * the eigenvectors on shards (SEP and GEP) against the single-process
    ``eigenvectors``: the info code and every close flag equal, X within
    1e-12 (both normalized), residuals < 1e-10; the cases a selection
    whose vectors cross every cut, 2x2 blocks across the cuts of 2 and of
    3 ranks, a growth case (fac < 1, scalings on every rank a vector
    crosses), a close case, and for GEP an infinite eigenvalue (beta = 0);
  * no ``DistrMatrix.full`` call in any of them, and no message above one
    panel: 4 x n x (L + nb) for HT, n x EIG_PANEL (+ O(n)) for the
    eigenvectors.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from starneig_tpu.api import gep as jgep
from starneig_tpu.api import gep_dm as jgep_dm
from starneig_tpu.parallel import make_mesh as jmake_mesh

from starneig_tpu_torch.api import gep, sep
from starneig_tpu_torch.config import SchurConf
from starneig_tpu_torch.ops import eigenvectors as ev
from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import hess_triangular as tht
from starneig_tpu_torch.ops import qz_driver
from starneig_tpu_torch.parallel.dm_eig import EIG_PANEL
from starneig_tpu_torch.ops.reorder import reorder_gep_
from starneig_tpu_torch.ops.schur import DenseExtent
from starneig_tpu_torch.testing import generators, hooks
from starneig_tpu_torch.testing.dm import (apply_extent_op, finite_right_half,
                                           run_ranks)
from starneig_tpu_torch.testing.generators import known_spectrum_pencil

torch.set_num_threads(1)

U = np.finfo(np.float64).eps
GATE = 500.0
N = 96
SPAWN_TIMEOUT_S = 300.0
# the extent-op buffers: the inner n = 37 at P = 6 (NP = 49), cut as
# dm_core.pad_cuts cuts it: [0, 25, 49] on 2 ranks, [0, 16, 25, 34, 49] on
# 4; windows inside a shard, across one cut and (w = 12) across two
P_EXT, N_EXT = 6, 37
NP_EXT = N_EXT + 2 * P_EXT
WINDOWS = ((0, 8), (P_EXT, 8), (14, 8), (20, 12), (NP_EXT - 12, 12))
# disjoint column/row pairs: across every cut of 2 and 4 ranks, and inside
PAIRS = (6, 10, 15, 20, 24, 33, 40)
# a batch of disjoint w = 8 windows, two to a message (wmax = 16)
BATCH_WS, WMAX_EXT = [0, 8, 20, 33, 41], 16
# the QZ iteration through a recording extent: a smaller pencil
N_REC = 48
# HT's widest message: a sliver window (L + nb columns) of each matrix
HT_PANEL = tht.sliver_len(tht.NB) + tht.NB
# the stages PR 20 left gathered: HT at N, the eigenvectors at N_EIG, whose
# 2x2 blocks at rows (c-1, c) straddle the cuts of 2 ranks (32) and of 3
# (22, 43); 2 and 3 ranks
N_EIG = 64
STRADDLE = (22, 32, 43)
SHARD_RANKS = (2, 3)


def _orth(rng, w):
    return np.linalg.qr(rng.standard_normal((w, w)))[0]


def _extent_inputs():
    rng = np.random.default_rng(21)
    bufs = dict(S=rng.standard_normal((NP_EXT, NP_EXT)),
                T=rng.standard_normal((NP_EXT, NP_EXT)),
                Q=rng.standard_normal((N_EXT, NP_EXT)),
                Z=rng.standard_normal((N_EXT, NP_EXT)))
    # negligible subdiagonals of the inner block (S[P+k+1, P+k]): at the
    # columns before the cuts 16, 25 and 34, and one past ihi
    for k in (9, 18, 27, 32):
        bufs["S"][P_EXT + k + 1, P_EXT + k] = 1e-19
    cases = []
    for j0, w in WINDOWS:
        Zw, Qw = _orth(rng, w), _orth(rng, w)
        cases += [
            ("get_block", dict(S="T", i0=3, j0=j0, h=5, w=w)),
            ("get_blocks", dict(Ms=("S", "T"), i0=j0, j0=j0, h=w, w=w)),
            ("mul_rows", dict(S="S", i0=j0, h=w, Qw=Qw, j0=j0 + w)),
            ("mul_rows", dict(S="T", i0=j0, h=w, Qw=Qw)),
            ("mul_cols_pencil", dict(Ms=("S", "T", "Q", "Z"), j0=j0, w=w,
                                     Xs=[Zw, Zw, Qw, Zw], i1s=(j0, j0, None, None))),
            ("mul_cols_pencil", dict(Ms=("T", "Z"), j0=j0, w=w, Xs=[Zw, Qw])),
            ("set_block", dict(S="S", M=rng.standard_normal((w, 1)), i0=j0, j0=j0 - 1
                               if j0 else 0))]
    pairs = np.array(PAIRS)
    c = np.cos(rng.uniform(0, 6, (4, len(PAIRS))))
    s = np.sqrt(1 - c * c)
    Qws = np.stack([_orth(rng, 8) for _ in BATCH_WS])
    cases += [
        ("mul_rows_batch", dict(S="S", ws=BATCH_WS, w=8, Qws=Qws)),
        ("mul_cols_batch", dict(Ms=("S", "Q"), ws=BATCH_WS, w=8, Qws=Qws)),
        ("diagonals", dict(Ms=("S", "T"), p=P_EXT, n=N_EXT)),
        ("zero_negligible", dict(Spad="S", P=P_EXT, n=N_EXT, ihi=32, thresh=1e-15)),
        ("rot_row_pairs", dict(items=[("S", c[0], s[0]), ("T", c[1], s[1])], rows=pairs)),
        ("rot_col_pairs", dict(items=[("S", c[0], s[0]), ("T", c[1], s[1]),
                                      ("Q", c[2], s[2]), ("Z", c[3], s[3])], cols=pairs)),
        ("rot_col_pairs", dict(items=[("Z", c[3][2:3], s[3][2:3])], cols=pairs[2:3])),
        ("set_entries", dict(S="S", rows=pairs, cols=pairs + 1, vals=c[0])),
        ("set_entries", dict(S="T", rows=pairs + 1, cols=pairs, vals=0.0))]
    return bufs, cases


@pytest.fixture(scope="module")
def ref():
    """Inputs, the references and the port's ``gep_suite`` job on 2 and 4
    gloo ranks (``ref["ranks"][world size]`` = (rank 0's result, every
    rank's counters)), the spawns running while the references do."""
    A, B, alpha, beta = known_spectrum_pencil(N, complex_ratio=0.3, inf_ratio=0.1,
                                              seed=0)
    bufs, cases = _extent_inputs()
    H, T, Q, Z = (M.numpy() for M in gep.hessenberg_triangular(A, B, device="cpu"))
    arrays = dict(bufs=bufs, ext_cases=cases, n_inner=N_EXT, P=P_EXT, wmax=WMAX_EXT,
                  GA=A, GB=B, HT=dict(S=H, T=T, Q=Q, Z=Z))
    with ThreadPoolExecutor(2) as pool:
        spawns = {nd: pool.submit(run_ranks, "starneig_tpu_torch.testing.dm:gep_suite",
                                  nd, (arrays,), "cpu", SPAWN_TIMEOUT_S)
                  for nd in (2, 4)}
        mesh4 = jmake_mesh(4)
        js = jgep_dm.schur(H, T, Q, Z, mesh=mesh4)
        jS, jT, jQ, jZ = (M.to_array() for M in js[:4])
        jsel = jgep.select(jS, jT, finite_right_half)
        jr = jgep_dm.reorder_schur(jS, jT, jQ, jZ, jsel, mesh=mesh4)
        st = {}
        with hooks.train_bottoms() as bottoms:
            sm = gep.schur(H, T, Q, Z, stats=st, device="cpu")
        ranks = {nd: f.result() for nd, f in spawns.items()}
    return dict(
        A=A, B=B, bufs=bufs, cases=cases, ht=dict(S=H, T=T, Q=Q, Z=Z), ranks=ranks,
        jax=dict(ar=np.asarray(js[4]), ai=np.asarray(js[5]), bt=np.asarray(js[6]),
                 info=int(js[7]), m=int(jr[4]), rinfo=int(jr[5])),
        sm=dict(ar=sm[4].numpy(), ai=sm[5].numpy(), bt=sm[6].numpy(), info=int(sm[7]),
                rounds=st["rounds"], stats=st, bottoms=bottoms))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, ref):
    """The port's gep_suite job on 2 or 4 gloo ranks: (world size, rank 0's
    result, every rank's counters)."""
    return (request.param, *ref["ranks"][request.param])


def _chordal(a, b):
    """Chordal distance (absolute) between two computed spectra."""
    return hooks.chordal_eigenvalue_error(a["ar"], a["ai"], a["bt"],
                                          b["ar"] + 1j * b["ai"], b["bt"]) * U


def _zero_betas(bt):
    bt = np.abs(np.asarray(bt))
    return int((bt <= 1e-12 * bt.max()).sum())


def _gates(A, B, r):
    ra, rb = hooks.residual_gep(A, B, r["S"], r["T"], r["Q"], r["Z"])
    assert ra < GATE and rb < GATE, (ra, rb)
    assert hooks.orthogonality(r["Q"]) < GATE and hooks.orthogonality(r["Z"]) < GATE
    assert hooks.schur_structure_error(r["S"]) == 0.0
    assert hooks.triangular_structure_error(r["T"]) == 0.0


def _ht_gates(A, B, r):
    """The HT gates: residuals and orthogonalities < 500 u, S exactly upper
    Hessenberg and T exactly upper triangular."""
    ra, rb = hooks.residual_gep(A, B, r["S"], r["T"], r["Q"], r["Z"])
    assert ra < GATE and rb < GATE, (ra, rb)
    assert hooks.orthogonality(r["Q"]) < GATE and hooks.orthogonality(r["Z"]) < GATE
    assert np.abs(np.tril(r["S"], -2)).max() == 0.0
    assert np.abs(np.tril(r["T"], -1)).max() == 0.0


def test_extent_pencil_ops(ranks, ref):
    """Each ShardedExtent op on shards cut as pad_cuts cuts them equals
    DenseExtent's on the whole buffers: bit for bit, the products within
    1e-14 max|S|."""
    nd, res, cnt = ranks
    assert len(res["extent"]) == len(ref["cases"])
    assert cnt[0]["cuts"] == ([0, 25, 49] if nd == 2 else [0, 16, 25, 34, 49])
    for (op, kw), (got, val) in zip(ref["cases"], res["extent"]):
        bufs = {k: torch.tensor(v) for k, v in ref["bufs"].items()}
        want = apply_extent_op(DenseExtent, bufs, op, kw)
        tol = 1e-14 * np.abs(ref["bufs"]["S"]).max() if op.startswith("mul_") else 0.0
        for k, M in bufs.items():
            err = np.abs(got[k] - M.numpy()).max()
            assert err <= tol, (op, kw.get("j0"), k, err)
        if want is not None:
            for g, w in zip(val if isinstance(val, list) else [val],
                            want if isinstance(want, list) else [want]):
                assert np.array_equal(g, w), (op, kw.get("j0"))
    assert all(c["extent_stats"]["all_reduce"] > 0 for c in cnt)


class _Opaque:
    """A padded buffer that only an extent may index: its shape, device,
    dtype and new_zeros, and no item access."""

    def __init__(self, t):
        self.t, self.shape, self.device, self.dtype = t, t.shape, t.device, t.dtype

    def new_zeros(self, *a, **kw):
        return self.t.new_zeros(*a, **kw)


def _unwrap(x):
    if isinstance(x, _Opaque):
        return x.t
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


class _RecordingExtent:
    """DenseExtent on the tensors inside _Opaque buffers, counting each of
    its operations."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        fn = getattr(DenseExtent, name)

        def op(*args, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*_unwrap(args), **{k: _unwrap(v) for k, v in kw.items()})
        return op


@pytest.fixture(scope="module")
def rec_pencil():
    """The HT form of known_spectrum_pencil(N_REC, 0.3, 0.1, seed 0) and
    its padded buffers for ``_qz_iter``, with the geometry."""
    A, B, _a, _b = known_spectrum_pencil(N_REC, complex_ratio=0.3, inf_ratio=0.1,
                                         seed=0)
    H, T, Q, Z = gep.hessenberg_triangular(A, B, device="cpu")
    g = qz_driver._Geometry(N_REC, SchurConf().resolve(N_REC))
    u = qz_driver.ULP / 2
    th = (u * float(torch.linalg.norm(H)), u * float(torch.linalg.norm(T)))
    return (H, T, Q, Z), g, th


def _padded(mats, g):
    P, NP, n = g.P, g.NP, N_REC
    out = []
    for k, M in enumerate(mats):
        buf = M.new_zeros((NP, NP) if k < 2 else (n, NP))
        buf[P if k < 2 else 0:(P if k < 2 else 0) + n, P:P + n] = M
        out.append(buf)
    return out


def test_qz_iter_routes_through_ext(rec_pencil):
    """_qz_iter touches the padded pencil only through ext: with opaque
    buffers (no item access) and a recording extent it runs the rounds
    (AED, sweeps, the infinite push) and ends bit-equal to the default
    call, every pencil operation used."""
    mats, g, (th, tt) = rec_pencil
    bufs = _padded(mats, g)
    st = dict(qz_log=[], recondense_calls=0, inf_chase_calls=0)
    ihi, fail = qz_driver._qz_iter(*bufs, N_REC, th, tt, g, st)
    rbufs = _padded(mats, g)
    rst = dict(qz_log=[], recondense_calls=0, inf_chase_calls=0)
    recording = _RecordingExtent()
    rihi, rfail = qz_driver._qz_iter(*(_Opaque(b) for b in rbufs), N_REC, th, tt, g,
                                     rst, ext=recording)
    assert (ihi, fail) == (rihi, rfail) == (0, 0)
    assert st["qz_log"] == rst["qz_log"]
    assert any(r[3] for r in st["qz_log"]) and any(r[2] for r in st["qz_log"])
    for a, b in zip(bufs, rbufs):
        assert torch.equal(a, b)
    for op in ("zero_negligible", "diagonals", "get_blocks", "mul_rows",
               "mul_cols_pencil", "set_block", "set_entries", "rot_col_pairs",
               "window"):
        assert recording.calls.get(op, 0) > 0, (op, recording.calls)


def test_reorder_gep_routes_through_ext(rec_pencil):
    """reorder_gep_ touches the pencil only through ext: bit-equal to
    reorder_schur_gep, every window through the recording extent."""
    mats, _g, _th = rec_pencil
    S, T, Q, Z, *_rest = qz_driver.qz_schur(*mats)
    sel = gep.select(S, T, finite_right_half)
    want = gep.reorder_schur(S, T, Q, Z, sel, device="cpu")
    got = [M.clone() for M in (S, T, Q, Z)]
    recording = _RecordingExtent()
    m, info = reorder_gep_(*(_Opaque(M) for M in got), sel, ext=recording)
    assert (m, info) == tuple(want[4:]) and m == int(sel.sum())
    for a, b in zip(got, want[:4]):
        assert torch.equal(a, b)
    for op in ("diagonals", "get_blocks", "window", "mul_rows", "mul_cols_pencil",
               "set_block"):
        assert recording.calls.get(op, 0) > 0, (op, recording.calls)


def test_gep_dm_schur(ranks, ref):
    """gep_dm.schur on shards against JAX's gep_dm.schur (4-device mesh)
    and the port's single-process gep.schur on the same HT form (the
    single-process one); and the DM chain's QZ against the single-process
    gep.schur of the chain's own HT form.  That form comes from the HT on
    shards, which agrees with the single-process one to rounding only;
    this pencil's B is singular, where the cascade is ill-conditioned
    elementwise (tests/test_torch_gep_ht.py::test_ht_one_ulp) and the
    spectrum moves by 1e-4 chordal under rounding, so the form is held to
    the HT gates (residuals and orthogonalities < 500 u, exact structure)
    and the sharded HT's elementwise tests take a regular pencil
    (test_ht_cascade_dm_matches_twins)."""
    nd, res, cnt = ranks
    r = res["gep"]["schur_same"]
    assert r["info"] == ref["jax"]["info"] == ref["sm"]["info"] == 0
    for other, tol in ((ref["sm"], 1e-10), (ref["jax"], 1e-9)):
        assert _chordal(r, other) < tol
        assert _zero_betas(r["bt"]) == _zero_betas(other["bt"])
    _gates(ref["A"], ref["B"], r)
    assert abs(r["rounds"] - ref["sm"]["rounds"]) <= 2, (r["rounds"], ref["sm"]["rounds"])
    _ht_gates(ref["A"], ref["B"], res["gep"]["ht"])
    c, sm = res["gep"]["schur"], res["gep"]["sm_own"]
    assert c["info"] == sm["info"] == 0
    assert _chordal(c, sm) < 1e-10 and _zero_betas(c["bt"]) == _zero_betas(sm["bt"])
    _gates(ref["A"], ref["B"], c)
    assert abs(c["rounds"] - sm["rounds"]) <= 2, (c["rounds"], sm["rounds"])
    st = cnt[0]["gep_stages"]["schur"]["stats"]
    assert st["path"] == "aed" and st["broadcast"] > 0 and st["all_reduce"] > 0


def _round_log_hops(st):
    """The hops of the trains in st's round_log: ceil(steps / 3B) a train
    (``gpu_gep.sweep_hops``)."""
    return sum(ntr * gpu_gep.sweep_hops(l, ihi, st["B"]) for l, ihi, ntr, _s in st["round_log"])


@pytest.mark.parametrize("path", ["cpu", "dm2", "dm4"])
def test_qz_hop_counters(ref, path):
    """The QZ driver's hop counters off the card: ``sweep_hops`` is the sum
    over round_log's trains of their hops and ``train_hops`` is 0, both on
    the CPU (gep.schur at N) and on the DM path (the chain's QZ stage on 2
    and 4 gloo ranks, through the sharded extent): both run the hop loop,
    whose iterations ``sweep_hops`` counts."""
    st = (ref["sm"]["stats"] if path == "cpu"
          else ref["ranks"][int(path[2:])][1][0]["gep_stages"]["schur"]["stats"])
    assert st["path"] == "aed"
    assert st["sweep_hops"] == _round_log_hops(st) > 0
    assert st["train_hops"] == 0


@pytest.mark.parametrize("path", ["cpu", "dm2", "dm4"])
def test_trains_decoupled_at_bottom(ref, path):
    """Every train the QZ driver starts finds its segment decoupled at its
    bottom, S[ihi, ihi-1] == 0 exactly (``hooks.train_bottoms``): kernel
    G3's row ranges, in its hop and train modes, stop at ihi, where the
    plain twin's do not.  On the CPU (gep.schur at N) and on the DM path
    (gep_dm.schur of the same HT form on 2 and 4 gloo ranks, the entry read
    through the sharded extent); among the trains, those of rounds whose AED
    deflated (nd > 0: the bottom moved up inside the round) and inner
    segments (ihi below the pencil's last row)."""
    if path == "cpu":
        rec, log = ref["sm"]["bottoms"], ref["sm"]["stats"]["qz_log"]
    else:
        same = ref["ranks"][int(path[2:])][0]["gep"]["schur_same"]
        rec, log = same["bottoms"], same["qz_log"]
    assert len(rec) == sum(ntr for _w, _kbot, ntr, _inf in log) > 0
    assert [v for _l, _ihi, v in rec] == [0.0] * len(rec)
    assert sum(ntr for w, kbot, ntr, _inf in log if kbot < w) > 0
    assert min(ihi for _l, ihi, _v in rec) < max(ihi for _l, ihi, _v in rec)


def test_gep_dm_reorder_schur(ranks, ref):
    """gep_dm.reorder_schur on shards: leading block and info as JAX's
    gep_dm.reorder_schur, the selected eigenvalues leading, the spectrum
    kept."""
    nd, res, cnt = ranks
    r, s = res["gep"]["reorder"], res["gep"]["schur"]
    assert (r["m"], r["info"]) == (ref["jax"]["m"], ref["jax"]["rinfo"])
    assert r["m"] == int(res["gep"]["sel"].sum())
    lead_ok, rest = hooks.selected_leading(r["S"], r["m"], finite_right_half, T=r["T"])
    assert lead_ok and rest == 0
    ar, ai, bt = (x.numpy() for x in gep.eigenvalues(r["S"], r["T"], device="cpu"))
    assert _chordal(dict(ar=ar, ai=ai, bt=bt), s) < 1e-10
    _gates(ref["A"], ref["B"], r)
    assert cnt[0]["gep_stages"]["reorder_schur"]["stats"]["windows"] > 0


def test_gep_dm_reduce(ranks, ref):
    """gep_dm.reduce at n=96: HT, QZ, select and reordering on shards; the
    result passes the gates, its eigenvalues are those of its own Schur
    form and match the single-process spectrum of its HT form (see
    test_gep_dm_schur; JAX's QZ of that form lies 1.4e-7 chordal from the
    port's single-process one, so the JAX spectrum is held to the DM QZ on
    the single-process HT form there), its leading block is JAX's, and it
    is the selection."""
    nd, res, cnt = ranks
    f = res["gep"]["final"]
    assert f["info"] == 0 and f["nsel"] == res["gep"]["reorder"]["m"] == ref["jax"]["m"]
    _gates(ref["A"], ref["B"], f)
    ar, ai, bt = (x.numpy() for x in gep.eigenvalues(f["S"], f["T"], device="cpu"))
    for a, b in ((f["ar"], ar), (f["ai"], ai), (f["bt"], bt)):
        assert np.array_equal(a, b)
    assert _chordal(f, res["gep"]["sm_own"]) < 1e-10
    lead_ok, rest = hooks.selected_leading(f["S"], f["nsel"], finite_right_half, T=f["T"])
    assert lead_ok and rest == 0


def test_gep_dm_stages_gather_nothing(ranks, ref):
    """No stage of gep_dm.reduce calls DistrMatrix.full; each rank's shards
    are its array_split columns (the padded QZ shard its pad_cuts
    columns), and no message exceeds one panel of each of the pencil's four
    matrices."""
    nd, res, cnt = ranks
    for r, c in enumerate(cnt):
        assert c["gep_full_calls"] == 0
        stages = c["gep_stages"]
        cols = len(np.array_split(np.arange(N), nd)[r])
        for name in ("hessenberg_triangular", "schur", "select", "reorder_schur",
                     "eigenvalues"):
            assert stages[name]["full_calls"] == 0, name
        for name in ("hessenberg_triangular", "schur", "reorder_schur"):
            assert stages[name]["shards"] == [(N, cols)] * 4, (name, stages[name])
        ht = stages["hessenberg_triangular"]["stats"]
        assert ht["collective_max_bytes"] <= 8 * 4 * N * HT_PANEL, ht
        qz = stages["schur"]["stats"]
        NP = qz["NP"]
        assert qz["shard_shape"] == (NP, qz["cuts"][r + 1] - qz["cuts"][r])
        assert qz["collective_max_bytes"] <= 4 * NP * max(qz["WA"], qz["WC"]) * 8, qz
        ro = stages["reorder_schur"]["stats"]
        assert ro["collective_max_bytes"] <= 8 * (4 * N * ro["W"] + 8 * N), ro
        for name in ("select", "eigenvalues"):
            assert stages[name]["stats"]["collective_max_bytes"] <= 8 * 6 * N, name


# ---------------------------------------------------------------------------
# HT and the eigenvectors on column shards (shard_suite, 2 and 3 ranks)
# ---------------------------------------------------------------------------

def _quasi(rng, n, blocks):
    """A standardized real Schur form of order n with 2x2 blocks at the
    rows (c-1, c) of each c of blocks."""
    S = np.triu(rng.standard_normal((n, n)))
    for c in blocks:
        S[c - 1, c - 1] = S[c, c] = rng.standard_normal()
        S[c - 1, c], S[c, c - 1] = 0.5 + rng.random(), -(0.5 + rng.random())
    return S


def _eig_cases():
    """(name, S, T or None, Q, Z, selection): SEP cases (T None), then GEP."""
    rng = np.random.default_rng(64)
    n = N_EIG
    blocks = STRADDLE + (5, n - 2)
    S = _quasi(rng, n, blocks)
    T = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    for c in blocks:
        T[c, c - 1] = T[c - 1, c] = 0.0
    Q, Z = (np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(2))
    Tinf = T.copy()
    Tinf[40, 40] = Tinf[12, 12] = 0.0                # beta = 0 at rows 12, 40
    right = np.arange(n) >= n // 4                   # vectors across every cut
    straddle = np.zeros(n, bool)
    straddle[[c - 1 for c in STRADDLE]] = True       # the blocks across the cuts
    straddle[n - 1] = True
    gS, gsel = generators.growth_schur()
    cS, csel = generators.close_schur(False)
    pS, pT, psel = generators.growth_pencil()
    qS, qT, qsel = generators.close_pencil()

    def orth(k, seed):
        return np.linalg.qr(np.random.default_rng(seed).standard_normal((k, k)))[0]
    return [("sep_cross", S, None, Q, None, right),
            ("sep_straddle", S, None, Q, None, straddle),
            ("sep_growth", gS, None, orth(24, 1), None, gsel),
            ("sep_close", cS, None, orth(12, 2), None, csel),
            ("gep_cross", S, T, Q, Z, right),
            ("gep_straddle", S, T, Q, Z, straddle),
            ("gep_infinite", S, Tinf, Q, Z, right),
            ("gep_growth", pS, pT, orth(24, 3), orth(24, 4), psel),
            ("gep_close", qS, qT, orth(12, 5), orth(12, 6), qsel)]


EIG_CASES = [c[0] for c in _eig_cases()]


@pytest.fixture(scope="module")
def shard_ref():
    """The regular pencil, its single-process triangularized form and the
    twins' cascade of it (with the log), JAX's HT, the eigenvector cases
    with their single-process results, and the shard_suite job on 2 and 3
    gloo ranks (``["ranks"][world size]``), spawned while the references
    run."""
    rng = np.random.default_rng(96)
    A = rng.standard_normal((N, N))
    B = rng.standard_normal((N, N)) + 3 * np.eye(N)
    tri = [M.numpy() for M in tht.triangularize_b(torch.tensor(A), torch.tensor(B))]
    cases = _eig_cases()
    arrays = dict(tri=tri, HA=A, HB=B, eig_cases=cases)
    with ThreadPoolExecutor(2) as pool:
        spawns = {nd: pool.submit(run_ranks, "starneig_tpu_torch.testing.dm:shard_suite",
                                  nd, (arrays,), "cpu", SPAWN_TIMEOUT_S)
                  for nd in SHARD_RANKS}
        log = []
        casc = [M.numpy() for M in tht.ht_blocked(*(torch.tensor(M) for M in tri),
                                                   tht._ht_generate, tht._ht_slivers,
                                                   log=log)]
        jht = [np.asarray(M) for M in jgep.hessenberg_triangular(A, B)]
        eig = {}
        for name, S, T, Q, Z, sel in cases:
            St = torch.tensor(S)
            if T is None:
                X, info = sep.eigenvectors(St, torch.tensor(Q), sel, device="cpu")
                pos, pair, lr, li = (list(x) for x in zip(*ev._selected_blocks(St, sel)))
                close = ev._backsolve_all(St, torch.tensor(lr), torch.tensor(li), pos,
                                          pair)[2]
            else:
                Tt = torch.tensor(T)
                X, info = gep.eigenvectors(St, Tt, torch.tensor(Q), torch.tensor(Z), sel,
                                           device="cpu")
                pos, pair, ar, ai, bt = (list(x) for x in
                                         zip(*ev._selected_blocks_gep(St, Tt, sel)))
                close = ev._backsolve_all_gep(St, Tt, *(torch.tensor(v) for v in
                                                        (ar, ai, bt)), pos, pair)[2]
            eig[name] = dict(X=X.numpy(), info=int(info), close=close.numpy().tolist())
        ranks = {nd: f.result() for nd, f in spawns.items()}
    return dict(A=A, B=B, casc=casc, rot=log[0].numpy(), jht=jht,
                cases={c[0]: c for c in cases}, eig=eig, ranks=ranks)


@pytest.fixture(scope="module", params=SHARD_RANKS, ids=["2ranks", "3ranks"])
def shard_ranks(request, shard_ref):
    return (request.param, *shard_ref["ranks"][request.param])


def test_ht_cascade_dm_matches_twins(shard_ranks, shard_ref):
    """The cascade on column shards (each rank its columns, the right chain
    handed across the cuts) from the single-process triangularized pencil:
    the rotation log within 1e-13 of ht_blocked's with the plain twins, the
    pencil and Q, Z within 1e-12 ||.||_F of it."""
    nd, res, cnt = shard_ranks
    c = res["cascade"]
    dlog = float(np.abs(c["rot"] - shard_ref["rot"]).max())
    assert dlog <= 1e-13, f"largest log difference {dlog}"
    for k, want in zip("ATQZ", shard_ref["casc"]):
        d = float(np.abs(c[k] - want).max()) / np.linalg.norm(want)
        assert d <= 1e-12, f"{k}: largest difference {d} ||.||_F"
    for r, cc in enumerate(cnt):
        st = cc["cascade"]["stats"]
        assert cc["cascade"]["full_calls"] == 0 and st["ht_messages"] > 0
        assert st["collective_max_bytes"] <= 8 * 4 * N * HT_PANEL, st


def test_ht_dm_vs_jax(shard_ranks, shard_ref):
    """gep_dm.hessenberg_triangular on column shards against JAX's
    gep.hessenberg_triangular: exact structure, residuals and
    orthogonalities < 500 u, the generalized eigenvalues within 1e-10
    chordal of JAX's."""
    import scipy.linalg
    nd, res, cnt = shard_ranks
    h = res["ht"]
    A, B = shard_ref["A"], shard_ref["B"]
    assert np.abs(np.tril(h["H"], -2)).max() == 0.0
    assert np.abs(np.tril(h["T"], -1)).max() == 0.0
    ra, rb = hooks.residual_gep(A, B, h["H"], h["T"], h["Q"], h["Z"])
    assert ra < GATE and rb < GATE, (ra, rb)
    assert hooks.orthogonality(h["Q"]) < GATE and hooks.orthogonality(h["Z"]) < GATE
    got = scipy.linalg.eigvals(h["H"], h["T"], homogeneous_eigvals=True)
    want = scipy.linalg.eigvals(*shard_ref["jht"][:2], homogeneous_eigvals=True)
    d = hooks.chordal_eigenvalue_error(got[0].real, got[0].imag, got[1].real,
                                       want[0], want[1].real) * U
    assert d < 1e-10, d
    for r, c in enumerate(cnt):
        cols = len(np.array_split(np.arange(N), nd)[r])
        assert c["ht"]["shards"] == [(N, cols)] * 4 and c["ht"]["specs"] == ["cols"] * 4


def test_ht_dm_gathers_nothing(shard_ranks):
    """The HT stage calls no DistrMatrix.full, broadcasts each cascade's
    rotations and carried columns, and sends no message above one sliver
    panel of each of the four matrices."""
    nd, _res, cnt = shard_ranks
    for c in cnt:
        st = c["ht"]["stats"]
        assert c["ht"]["full_calls"] == 0
        assert st["broadcast"] > 0 and st["all_reduce"] > 0
        assert st["collective_max_bytes"] <= 8 * 4 * N * HT_PANEL, st


@pytest.mark.parametrize("case", EIG_CASES)
def test_eigenvectors_dm(shard_ranks, shard_ref, case):
    """sep_dm.eigenvectors / gep_dm.eigenvectors on column shards against
    the single-process run: the info code and the close flags equal, X
    within 1e-12, the residuals < 1e-10; no DistrMatrix.full call, no
    message above n x EIG_PANEL float64 (plus O(n))."""
    nd, res, cnt = shard_ranks
    name, S, T, Q, Z, sel = shard_ref["cases"][case]
    got, want = res["eig"][case], shard_ref["eig"][case]
    n = S.shape[0]
    assert got["info"] == want["info"]
    assert cnt[0]["eig"][case]["stats"]["close"] == want["close"]
    assert got["X"].shape == want["X"].shape
    d = float(np.abs(got["X"] - want["X"]).max())
    assert d <= 1e-12, d
    if T is None:
        A, I = Q @ S @ Q.T, np.eye(n)
        resid = hooks.eigenvector_residual_gep(A, I, S, I, got["X"], sel)
    else:
        resid = hooks.eigenvector_residual_gep(Q @ S @ Z.T, Q @ T @ Z.T, S, T, got["X"], sel)
    assert resid < 1e-10, resid
    if case.endswith("growth"):
        # scaled on every rank the last vector crosses, by fac < 1e-50
        assert sum(c["eig"][case]["stats"]["scale_min"] < 1e-50 for c in cnt) >= 2
    if case.endswith("straddle"):
        cuts = cnt[0]["eig"][case]["stats"]["eig_cuts"]
        assert any(c in STRADDLE and c + 1 in cuts for c in
                   np.cumsum([len(x) for x in np.array_split(np.arange(n), nd)])[:-1])
    for c in cnt:
        rec = c["eig"][case]
        assert rec["full_calls"] == 0
        assert rec["stats"]["collective_max_bytes"] <= 8 * (n * EIG_PANEL + 8 * n), rec
