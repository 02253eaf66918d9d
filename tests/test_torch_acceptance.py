"""The port's acceptance tier: ``tests/test_acceptance.py``'s sizes, seeds
and gates (the reference CI solves n=5000 per component,
test/CMakeLists.txt:302-358; its warn gate is 500 u,
docs/_7_test_driver.md:129).

On the CPU (Tier-1), ``test_sep_chain_n1000_vs_jax`` runs the port's
``sep.hessenberg`` and ``sep.schur`` with ``device="cpu"`` (the kernels'
plain versions) on ``random_dense(1000, seed=0)`` under JAX's gates (info
0, residual and orthogonality < 500 u, exact quasi-triangular structure)
and holds its spectrum to the JAX package's ``sep.schur`` on the same
matrix: equal as multisets within 1e-10 ||A||_F.  The helpers of
``testing.hooks`` that the card tests use are held there to the numpy
forms of their checks.

On the card, behind ``STARNEIG_ACCEPTANCE=1`` as in JAX, every test
imports no JAX, so the file runs where only PyTorch is installed:

    STARNEIG_ACCEPTANCE=1 python -m pytest --noconftest -s tests/test_torch_acceptance.py

* ``test_sep_chain[1000|2000|5000]``: ``random_dense(n, seed=0)`` through
  ``sep.hessenberg`` and ``sep.schur``; at n=5000 also ``sep.select`` of
  Re(lambda) > 0, ``sep.reorder_schur`` and ``sep.eigenvectors`` of the
  leading block (the smoke's phase-5 gates: standardized S before and
  after, the leading block exactly the selected values, the spectrum
  moved < 1e-8 max|lambda|, eigenvector residuals < 1e-10);
* ``test_reorder_n2000``: ``random_dense(2000, seed=3)``, Re(lambda) < 0
  to the top, info SUCCESS or PARTIAL_REORDERING, residual < 500 u, m > 0;
* ``test_gep_chain_n2000``: ``gep.reduce`` on ``known_spectrum_pencil(2000,
  seed=1, inf_ratio=0.1)``: info 0, both residuals, both orthogonalities
  < 500 u, exact structure of S and T;
* ``test_gep_chain_n5000``: ``known_spectrum_pencil(5000, complex_ratio=0.3,
  inf_ratio=0.1, seed=0)`` through HT, QZ, the selection of finite values
  with Re > 0, the reordering and the eigenvectors, under the smoke's
  phase-6 gates (the spectrum moved < 1e-10 chordal, eigenvector
  residuals < 1e-10);
* ``test_sep_dm_reduce_n5000_4ranks``: ``sep_dm.reduce`` of
  ``random_dense(5000, seed=0)`` on 4 gloo ranks sharing the card: info 0,
  residual and orthogonality < 500 u, the spectrum within 1e-10
  max|lambda| of the single-process ``sep.schur`` on the card.

Each card test prints one line, ``ACCEPTANCE {json}``: its phase wall
times (``hooks.timed``: the card's queue drained at both ends) and its
gate values.
"""

import json
import os

import numpy as np
import pytest
import torch

from starneig_tpu_torch.api import gep, sep
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import known_spectrum_pencil, random_dense

U = np.finfo(np.float64).eps
GATE = 500.0            # the reference's warn gate, in units of u
EIG_MOVE = 1e-8         # the SEP reordering's spectrum, relative to max|lambda|
EIG_MOVE_GEP = 1e-10    # the GEP reordering's spectrum, chordal
EVEC = 1e-10            # eigenvector residuals
SPECTRUM = 1e-10        # two solves' spectra, relative to ||A||_F or max|lambda|


def _positive_real(lam):
    return lam.real > 0


def _finite_right_half(alpha, beta):
    return beta != 0 and (alpha / beta).real > 0


def _report(name, **values):
    print(f"ACCEPTANCE {json.dumps(dict(test=name, **values), default=float)}",
          flush=True)


def _scalars(d):
    """The entries of a stats dict that are numbers (the counts)."""
    return {k: v for k, v in d.items() if isinstance(v, (int, float))}


def _moved(S, er, ei):
    """The SEP reordering's spectrum against the one before, in units of
    max|lambda| (``hooks.eigenvalue_error`` scaled back from u)."""
    er2, ei2 = extract_eigenvalues(S)
    after = to_numpy(er2) + 1j * to_numpy(ei2)
    return hooks.eigenvalue_error(after, to_numpy(er) + 1j * to_numpy(ei)) * U


# ---------------------------------------------------------------------------
# Tier-1, on the CPU, held to the JAX package
# ---------------------------------------------------------------------------

def test_sep_chain_n1000_vs_jax():
    if torch.cuda.is_available():
        # JAX would take the card (and most of its memory); on a card the
        # n=1000 chain runs in test_sep_chain[1000]
        pytest.skip("the JAX reference runs on a machine without a CUDA card")
    jax = pytest.importorskip("jax")
    from starneig_tpu.api import sep as jsep

    n = 1000
    A = random_dense(n, seed=0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        H, Q = sep.hessenberg(from_numpy(A), device="cpu")
        S, Q, er, ei, info = sep.schur(H, Q, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert int(info) == Error.SUCCESS
    S, Q = to_numpy(S), to_numpy(Q)
    res, orth = hooks.residual_sep(A, S, Q), hooks.orthogonality(Q)
    assert res < GATE and orth < GATE, (res, orth)
    assert hooks.schur_structure_error(S) == 0.0
    assert hooks.schur_form_error(from_numpy(S)) == 0.0

    Hj, Qj = jsep.hessenberg(jax.numpy.asarray(A))
    _Sj, _Qj, erj, eij, infoj = jsep.schur(Hj, Qj)
    assert int(infoj) == Error.SUCCESS
    ours = to_numpy(er) + 1j * to_numpy(ei)
    theirs = np.asarray(erj) + 1j * np.asarray(eij)
    d = hooks.eigenvalue_error(ours, theirs, scale=np.linalg.norm(A)) * U
    assert d <= SPECTRUM, d


def test_hooks_eigenvector_residual_sep():
    """hooks.eigenvector_residual_sep against the numpy column loop of
    tests/test_torch_full_chain.py, and hooks.selected_leading on S before
    and after the reordering (n=60, CPU)."""
    n = 60
    A = random_dense(n, seed=60)
    S, Q, er, ei, m, info = sep.reduce(from_numpy(A), _positive_real, device="cpu")
    assert int(info) == Error.SUCCESS and m > 0
    X, _xinfo = sep.eigenvectors(S, Q, np.arange(n) < m, device="cpu")
    S, X = to_numpy(S), to_numpy(X)
    er, ei = (to_numpy(v) for v in extract_eigenvalues(from_numpy(S[:m, :m])))

    def loop(X):
        worst, c = 0.0, 0
        while c < m:
            if ei[c] != 0:
                lam, x = er[c] + 1j * abs(ei[c]), X[:, c] + 1j * X[:, c + 1]
                c += 2
            else:
                lam, x = er[c], X[:, c].astype(complex)
                c += 1
            worst = max(worst, np.linalg.norm(A @ x - lam * x) /
                        (np.linalg.norm(A) * np.linalg.norm(x)))
        return worst
    # at the rounding level the two agree in size; off it, to rounding
    got, want = hooks.eigenvector_residual_sep(A, S, X, m), loop(X)
    assert got < EVEC and np.isclose(got, want, rtol=0.1), (got, want)
    Xp = X + 1e-6 * np.random.default_rng(0).standard_normal(X.shape)
    got, want = hooks.eigenvector_residual_sep(A, S, Xp, m), loop(Xp)
    assert got > 1e-8 and np.isclose(got, want, rtol=1e-9), (got, want)
    assert hooks.selected_leading(S, m, _positive_real) == (True, 0)
    # X's columns as eigenvectors of the wrong block fail the check
    assert hooks.eigenvector_residual_sep(A, S[::-1, ::-1].copy(), X, m) > 1e-3
    H, Qh = sep.hessenberg(from_numpy(A), device="cpu")
    S0, _Q0, er0, _ei0, _info = sep.schur(H, Qh, device="cpu")
    want = int((to_numpy(er0) > 0).sum())
    lead, rest = hooks.selected_leading(S0, want, _positive_real)
    assert want == m and (not lead) and rest > 0


def test_hooks_gates_match_numpy():
    """hooks.sep_gates and hooks.gep_gates (torch) against the numpy hooks
    on an n=48 chain and pencil (CPU)."""
    n = 48
    A = random_dense(n, seed=48)
    S, Q, _er, _ei, _m, info = sep.reduce(from_numpy(A), device="cpu")
    res, orth, form = hooks.sep_gates(A, S, Q)
    assert np.isclose(res, hooks.residual_sep(A, S, Q), rtol=1e-6)
    assert np.isclose(orth, hooks.orthogonality(Q), rtol=1e-6)
    assert form == hooks.schur_form_error(S) == 0.0
    Ag, Bg, _al, _be = known_spectrum_pencil(n, complex_ratio=0.3, inf_ratio=0.1, seed=48)
    S, T, Q, Z, *_rest, ginfo = gep.reduce(from_numpy(Ag), from_numpy(Bg), device="cpu")
    assert int(ginfo) == Error.SUCCESS
    ra, rb, oq, oz, fs, ft = hooks.gep_gates(Ag, Bg, S, T, Q, Z)
    assert np.allclose((ra, rb), hooks.residual_gep(Ag, Bg, S, T, Q, Z), rtol=1e-6)
    assert np.allclose((oq, oz), (hooks.orthogonality(Q), hooks.orthogonality(Z)),
                       rtol=1e-6)
    assert fs == hooks.schur_structure_error(S) == 0.0
    assert ft == hooks.triangular_structure_error(T) == 0.0
    assert max(ra, rb, oq, oz) < GATE


# ---------------------------------------------------------------------------
# the acceptance tier on the card (STARNEIG_ACCEPTANCE=1)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if os.environ.get("STARNEIG_ACCEPTANCE") != "1":
        pytest.skip("CI-scale run; set STARNEIG_ACCEPTANCE=1")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from starneig_tpu_torch import kernels
    kernels.lib()           # nvcc on first use: outside the phases' times
    return torch.device("cuda:0")


def _sep_chain(A, dev):
    """sep.hessenberg -> sep.schur on the card: (S, Q, er, ei, info,
    {phase: ms}, schur stats), each phase timed by hooks.timed."""
    Ad = from_numpy(A, dev)
    (H, Q), hess_ms = hooks.timed(lambda: sep.hessenberg(Ad, device=dev))
    stats = {}
    (S, Q, er, ei, info), schur_ms = hooks.timed(
        lambda: sep.schur(H, Q, stats=stats, device=dev))
    return S, Q, er, ei, int(info), dict(hessenberg_ms=hess_ms, schur_ms=schur_ms), stats


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 2000, 5000])
def test_sep_chain(card, n):
    A = random_dense(n, seed=0)
    S, Q, er, ei, info, ms, stats = _sep_chain(A, card)
    res, orth, form = hooks.sep_gates(A, S, Q)
    structure = hooks.schur_structure_error(S)
    geometry = {k: stats.get(k) for k in ("WA", "NS", "B", "WC", "TMAX", "rounds")}
    _report(f"sep_chain[{n}]", n=n, info=info, **ms, residual_u=res,
            orthogonality_u=orth, schur_form_error=form, structure_error=structure,
            geometry=geometry)
    assert info == Error.SUCCESS
    assert res < GATE and orth < GATE, (res, orth)
    assert structure == 0.0 and form == 0.0
    if n < 5000:
        return
    # the rest of the CI's components on the same S
    sel, select_ms = hooks.timed(lambda: sep.select(S, _positive_real))
    rstats = {}
    (S2, Q2, m, rinfo), reorder_ms = hooks.timed(
        lambda: sep.reorder_schur(S, Q, sel, stats=rstats, device=card))
    lead = np.arange(n) < m
    (X, xinfo), eigenvectors_ms = hooks.timed(
        lambda: sep.eigenvectors(S2, Q2, lead, device=card))
    res2, orth2, form2 = hooks.sep_gates(A, S2, Q2)
    moved = _moved(S2, er, ei)
    lead_ok, rest = hooks.selected_leading(S2, m, _positive_real)
    evec = hooks.eigenvector_residual_sep(A, S2, X, m)
    _report(f"sep_chain[{n}] past Schur", n=n, select_ms=select_ms, reorder_ms=reorder_ms,
            eigenvectors_ms=eigenvectors_ms, reorder_info=int(rinfo),
            selected=int(sel.sum()), lead=int(m), rest=rest,
            reorder_stats=_scalars(rstats), residual2_u=res2, orthogonality2_u=orth2,
            schur_form_error2=form2,
            eig_moved=moved, eigenvectors_info=int(xinfo), eigenvector_residual=evec)
    assert rinfo in (Error.SUCCESS, Error.PARTIAL_REORDERING)
    if rinfo == Error.SUCCESS:
        assert m == int(sel.sum())
    assert lead_ok and (rest == 0 or rinfo == Error.PARTIAL_REORDERING), (lead_ok, rest)
    assert res2 < GATE and orth2 < GATE, (res2, orth2)
    assert form2 == 0.0
    assert moved < EIG_MOVE, moved
    assert xinfo in (Error.SUCCESS, Error.CLOSE_EIGENVALUES)
    assert tuple(X.shape) == (n, m) and bool(torch.isfinite(X).all())
    assert evec < EVEC, evec


@pytest.mark.cuda
def test_reorder_n2000(card):
    n = 2000
    A = random_dense(n, seed=3)
    S, Q, er, ei, info, ms, _stats = _sep_chain(A, card)
    assert info == Error.SUCCESS
    sel = to_numpy(er) < 0
    rstats = {}
    (S2, Q2, m, rinfo), reorder_ms = hooks.timed(
        lambda: sep.reorder_schur(S, Q, sel, stats=rstats, device=card))
    res, orth, form = hooks.sep_gates(A, S2, Q2)
    _report("reorder_n2000", n=n, **ms, reorder_ms=reorder_ms, reorder_info=int(rinfo),
            selected=int(sel.sum()), lead=int(m), residual_u=res, orthogonality_u=orth,
            schur_form_error=form, reorder_stats=_scalars(rstats))
    assert rinfo in (Error.SUCCESS, Error.PARTIAL_REORDERING)
    assert res < GATE and m > 0, (res, m)


@pytest.mark.cuda
def test_gep_chain_n2000(card):
    n = 2000
    A, B, _alpha, _beta = known_spectrum_pencil(n, seed=1, inf_ratio=0.1)
    Ad, Bd = from_numpy(A, card), from_numpy(B, card)
    (S, T, Q, Z, _ar, _ai, _bt, _nsel, info), reduce_ms = hooks.timed(
        lambda: gep.reduce(Ad, Bd, device=card))
    ra, rb, oq, oz, fs, ft = hooks.gep_gates(A, B, S, T, Q, Z)
    _report("gep_chain_n2000", n=n, info=int(info), reduce_ms=reduce_ms,
            residual_a_u=ra, residual_b_u=rb, orth_q_u=oq, orth_z_u=oz,
            structure_s=fs, structure_t=ft)
    assert int(info) == Error.SUCCESS
    assert max(ra, rb, oq, oz) < GATE, (ra, rb, oq, oz)
    assert fs == 0.0 and ft == 0.0


@pytest.mark.cuda
def test_gep_chain_n5000(card):
    n = 5000
    A, B, _alpha, _beta = known_spectrum_pencil(n, complex_ratio=0.3, inf_ratio=0.1,
                                                seed=0)
    Ad, Bd = from_numpy(A, card), from_numpy(B, card)
    (H, T, Q, Z), ht_ms = hooks.timed(lambda: gep.hessenberg_triangular(Ad, Bd,
                                                                      device=card))
    stats = {}
    (S, T, Q, Z, ar, ai, bt, info), qz_ms = hooks.timed(
        lambda: gep.schur(H, T, Q, Z, stats=stats, device=card))
    del H
    gates = hooks.gep_gates(A, B, S, T, Q, Z)
    geometry = {k: stats.get(k) for k in ("WA", "NS", "B", "WC", "TMAX", "rounds",
                                          "inf_rounds", "recondense_calls")}
    sel, select_ms = hooks.timed(lambda: gep.select(S, T, _finite_right_half))
    rstats = {}
    (S2, T2, Q2, Z2, m, rinfo), reorder_ms = hooks.timed(
        lambda: gep.reorder_schur(S, T, Q, Z, sel, stats=rstats, device=card))
    lead = np.arange(n) < m
    (X, xinfo), eigenvectors_ms = hooks.timed(
        lambda: gep.eigenvectors(S2, T2, Q2, Z2, lead, device=card))
    gates2 = hooks.gep_gates(A, B, S2, T2, Q2, Z2)
    ar2, ai2, bt2 = (to_numpy(v) for v in gep.eigenvalues(S2, T2, device=card))
    kept = hooks.chordal_eigenvalue_error(ar2, ai2, bt2, to_numpy(ar) + 1j * to_numpy(ai),
                                          to_numpy(bt)) * U
    lead_ok, rest = hooks.selected_leading(S2, m, _finite_right_half, T=T2)
    evec = hooks.eigenvector_residual_gep(A, B, S2, T2, X, lead)
    names = ("residual_a_u", "residual_b_u", "orth_q_u", "orth_z_u", "structure_s",
             "structure_t")
    _report("gep_chain_n5000", n=n, info=int(info), ht_ms=ht_ms, qz_ms=qz_ms,
            select_ms=select_ms, reorder_ms=reorder_ms, eigenvectors_ms=eigenvectors_ms,
            **dict(zip(names, gates)), geometry=geometry, reorder_info=int(rinfo),
            selected=int(sel.sum()), lead=int(m), rest=rest,
            reorder_stats=_scalars(rstats),
            after_reorder=dict(zip(names, gates2)), spectrum_moved_chordal=kept,
            eigenvectors_info=int(xinfo), eigenvector_residual=evec)
    for g in (gates, gates2):
        assert max(g[:4]) < GATE, g
        assert g[4] == 0.0 and g[5] == 0.0, g
    assert int(info) == Error.SUCCESS
    assert rinfo in (Error.SUCCESS, Error.PARTIAL_REORDERING)
    if rinfo == Error.SUCCESS:
        assert m == int(sel.sum())
    assert lead_ok and (rest == 0 or rinfo == Error.PARTIAL_REORDERING), (lead_ok, rest)
    assert kept < EIG_MOVE_GEP, kept
    assert xinfo in (Error.SUCCESS, Error.CLOSE_EIGENVALUES)
    assert tuple(X.shape) == (n, m) and bool(torch.isfinite(X).all())
    assert evec < EVEC, evec


@pytest.mark.cuda
def test_sep_dm_reduce_n5000_4ranks(card):
    from starneig_tpu_torch.testing.dm import run_ranks

    n = 5000
    A = random_dense(n, seed=0)
    torch.cuda.empty_cache()    # the earlier tests' cached blocks: the ranks share the card
    (r, cnt), wall_ms = hooks.timed(lambda: run_ranks(
        "starneig_tpu_torch.testing.dm:sep_reduce", 4, (A, "positive_real"),
        device=str(card), timeout_s=1800))
    res, orth, form = hooks.sep_gates(A, from_numpy(r["S"], card), from_numpy(r["Q"], card))
    # the single-process solve on the card, recomputed here
    _S, _Q, er, ei, info1, ms1, _stats = _sep_chain(A, card)
    single = to_numpy(er) + 1j * to_numpy(ei)
    spectrum = hooks.eigenvalue_error(r["er"] + 1j * r["ei"], single) * U
    stage = {k: cnt[0][k] for k in ("hessenberg_ms", "schur_ms", "select_ms",
                                    "reorder_schur_ms")}
    comm = {c["rank"]: _scalars(c["stats"]) for c in cnt}
    _report("sep_dm_reduce_n5000_4ranks", n=n, ranks=len(cnt), info=r["info"],
            nsel=r["nsel"], wall_ms=wall_ms, stage_ms=stage,
            startup_s=[c["startup_s"] for c in cnt], backend=cnt[0]["backend"],
            residual_u=res, orthogonality_u=orth, schur_form_error=form,
            spectrum_vs_single=spectrum, single_process_ms=ms1, collectives=comm,
            launches_rank0=cnt[0]["launches"])
    assert info1 == Error.SUCCESS
    assert r["info"] == Error.SUCCESS
    assert res < GATE and orth < GATE, (res, orth)
    assert spectrum < SPECTRUM, spectrum
