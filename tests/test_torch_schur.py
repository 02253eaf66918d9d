"""The port's Schur building blocks and the Hessenberg -> Schur slice
against the JAX package's XLA path, on the same seeded inputs (CPU).

Single steps (a hop of bulge trains, the AED spike deflation, the
recondense, the block standardization, the shift packing) agree
elementwise to 1e-12: the same operations in another summation order.
Whole iterations (the Francis window solve, the full solve) are held to
what the iteration guarantees: the same info, a standardized real Schur
form on both sides, the eigenvalues read off its diagonal blocks within
1e-10 ||A||, and residual and orthogonality below the reference's 500 u
gate on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.api import sep as jsep
from starneig_tpu.config import SchurConf as JSchurConf
from starneig_tpu.ops import schur as jschur
from starneig_tpu.ops.eigvals import extract_eigenvalues as jextract
from starneig_tpu.ops.small_schur import small_schur as jsmall
from starneig_tpu_torch.api import sep as tsep
from starneig_tpu_torch.convert import conf_from_jax, from_numpy, to_numpy
from starneig_tpu_torch.ops import schur as tschur
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
from starneig_tpu_torch.ops.small_schur import small_schur as tsmall
from starneig_tpu_torch.testing.hooks import schur_form_error

torch.set_num_threads(1)

U = np.finfo(np.float64).eps
GATE = 500.0


def _res_orth(A, S, Q):
    n = A.shape[0]
    res = np.linalg.norm(Q @ S @ Q.T - A) / np.linalg.norm(A) / U
    orth = np.linalg.norm(Q @ Q.T - np.eye(n)) / np.sqrt(n) / U
    return res, orth


def _sorted_eigs(er, ei):
    return np.sort_complex(np.asarray(er) + 1j * np.asarray(ei))


# (l_rel, ihi_rel, s0) for B = 3 (WC = 22, HOP = 9): a train entering its
# range, a parked train, a train one hop later, and one leaving its range
HOP_CASES = {"intro": (7, 62, 0), "parked": (1, 0, 0), "second": (-2, 62, 9),
             "exit": (-2, 11, 9)}
# the same for B = 65 (WC = 394, HOP = 195), n=10,000's geometry: a train
# entering its range and one a hop later
HOP_CASES_65 = {"intro": (193, 434, 0), "second": (-2, 434, 195)}


# B = 3 keeps its four cases under their own ids; B = 65 adds two.  The
# tolerance: the same operations in another summation order and with other
# FMA contractions, 1e-12 |W| over B = 3's 9 steps; over B = 65's 195 steps
# the two differ by 1.07e-12 |W| on W and 5.5e-13 on Qw, so 1e-11 there.
@pytest.mark.parametrize("B,case", [pytest.param(3, c, id=c) for c in sorted(HOP_CASES)]
                         + [pytest.param(65, c, id=f"B65-{c}") for c in sorted(HOP_CASES_65)])
def test_train_hop(B, case):
    WC, HOP = 6 * B + 4, 3 * B
    l_rel, ihi_rel, s0 = (HOP_CASES if B == 3 else HOP_CASES_65)[case]
    tol = 1e-12 if B == 3 else 1e-11
    rng = np.random.default_rng(7)
    W = np.triu(rng.standard_normal((WC, WC)), -1)
    sh = rng.standard_normal((B, 4))
    sh[:, 3] = -sh[:, 1]
    Wj, Qj = jschur._train_hop(
        jnp.asarray(W), jnp.eye(WC), *(jnp.asarray(sh[:, i]) for i in range(4)),
        jnp.int32(l_rel), jnp.int32(ihi_rel), jnp.int32(s0), B=B, WC=WC, HOP=HOP)
    Wt, Qt = tschur._train_hop(from_numpy(W)[None], from_numpy(sh)[None],
                               [l_rel], [ihi_rel], [s0], B=B, HOP=HOP)
    np.testing.assert_allclose(to_numpy(Wt[0]), np.asarray(Wj), rtol=0,
                               atol=tol * np.abs(W).max())
    np.testing.assert_allclose(to_numpy(Qt[0]), np.asarray(Qj), rtol=0, atol=tol)
    if case == "parked":
        np.testing.assert_array_equal(to_numpy(Wt[0]), W)


def test_aed_deflate():
    # the input of tests/test_pallas_kernels.py:107-115 (planted 2x2 blocks)
    w = 40
    rng = np.random.default_rng(5)
    T = np.triu(rng.standard_normal((w, w)))
    for p in (6, 14, 30):
        T[p + 1, p] = -abs(rng.standard_normal())
        T[p, p + 1] = abs(rng.standard_normal())
    V, _ = np.linalg.qr(np.eye(w) + 0.05 * rng.standard_normal((w, w)))
    s, th = 0.8, 1e-13
    Tj, Vj, kj, fj = jschur._aed_deflate(jnp.asarray(T), jnp.asarray(V), s, w, th)
    Tt, Vt, kt, ft = tschur._aed_deflate(from_numpy(T), from_numpy(V), s, w, th)
    assert (int(kt), int(ft)) == (int(kj), int(fj))
    np.testing.assert_allclose(to_numpy(Tt), np.asarray(Tj), rtol=0,
                               atol=1e-12 * np.abs(T).max())
    np.testing.assert_allclose(to_numpy(Vt), np.asarray(Vj), rtol=0, atol=1e-12)


def _recondense_input():
    # the input of tests/test_pallas_kernels.py:74
    WA = 40
    rng = np.random.default_rng(3)
    T = np.triu(rng.standard_normal((WA, WA)))
    Q, _ = np.linalg.qr(rng.standard_normal((WA, WA)))
    return T, Q, 0.37


def _recondense_both(kbot):
    T, Q, s = _recondense_input()
    Tj, Vj, bj = jschur._aed_recondense(jnp.asarray(T), jnp.asarray(Q),
                                        jnp.float64(s), jnp.int32(kbot))
    Tt, Vt, bt = tschur._aed_recondense(from_numpy(T), from_numpy(Q), s, kbot)
    return (T, Q, s), (np.asarray(Tj), np.asarray(Vj), float(bj)), \
        (to_numpy(Tt), to_numpy(Vt), float(bt))


@pytest.mark.parametrize("kbot", [10, 1, 0])
def test_aed_recondense(kbot):
    (T, _Q, _s), (Tj, Vj, bj), (Tt, Vt, bt) = _recondense_both(kbot)
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-12 * np.abs(T).max())
    np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-12)
    assert abs(bt - bj) <= 1e-12
    assert np.abs(np.tril(Tt[:kbot, :kbot], -2)).max(initial=0) == 0


def test_aed_recondense_near_breakdown():
    """kbot=25 on this input reduces to a Hessenberg block whose subdiagonal
    falls to 3.8e-10 at row 23 (a nearly invariant Krylov subspace), so the
    last reflectors are determined only to ~1e-7 relative and elementwise
    agreement is not defined there.  Both sides are held to the contract
    instead: a similarity with an orthogonal transform, the exact
    Hessenberg structure, the spike condensed into beta e1 and the same
    beta."""
    kbot = 25
    (T, Q, s), (Tj, Vj, bj), (Tt, Vt, bt) = _recondense_both(kbot)
    assert abs(bt - bj) <= 1e-12
    nt = np.linalg.norm(T)
    for To, Vo, b in ((Tj, Vj, bj), (Tt, Vt, bt)):
        Us = Q.T @ Vo
        assert np.linalg.norm(Us.T @ T @ Us - To) / nt < 1e-14
        assert np.linalg.norm(Us.T @ Us - np.eye(len(T))) < 1e-13
        assert np.abs(np.tril(To[:kbot, :kbot], -2)).max() == 0.0
        spike = Us.T @ np.where(np.arange(len(T)) < kbot, s * Q[0], 0.0)
        assert abs(spike[0] - b) < 1e-13 and np.abs(spike[1:kbot]).max() < 1e-13


def test_aed_recondense_against_pallas_kernel():
    """The port's recondense against the JAX package's Pallas kernel B5 in
    interpret mode, on the input of tests/test_pallas_kernels.py:74, held
    to that test's CPU tolerance 2e-6 (its df32 arithmetic floors near
    1e-9 in interpret mode): a similarity with an orthogonal transform, the
    spike condensed into beta e1, the same beta, exact Hessenberg
    structure of the reduced block on both sides."""
    from starneig_tpu.ops.pallas_schur import aed_recondense_pallas
    tol, kbot = 2e-6, 25
    T, Q, s = _recondense_input()
    Tp, Vp, bp = aed_recondense_pallas(jnp.asarray(T), jnp.asarray(Q),
                                       jnp.float64(s), jnp.int32(kbot),
                                       interpret=True)
    Tt, Vt, bt = tschur._aed_recondense(from_numpy(T), from_numpy(Q), s, kbot)
    assert abs(float(bt) - float(bp)) < 10 * tol
    spm = np.where(np.arange(len(T)) < kbot, s * Q[0], 0.0)
    for To, Vo, b in ((np.asarray(Tp), np.asarray(Vp), float(bp)),
                      (to_numpy(Tt), to_numpy(Vt), float(bt))):
        Us = Q.T @ Vo
        assert np.linalg.norm(Us.T @ T @ Us - To) / np.linalg.norm(T) < tol
        assert np.linalg.norm(Us.T @ Us - np.eye(len(T))) < 10 * tol
        out = Us.T @ spm
        assert abs(out[0] - b) < 10 * tol and np.abs(out[1:kbot]).max() < 10 * tol
        assert np.abs(np.tril(To[:kbot, :kbot], -2)).max() == 0.0


@pytest.mark.parametrize("kbot", [25, 10, 1, 0])
def test_aed_recondense_dispatch_cpu(kbot):
    """On a CPU tensor the dispatcher is the plain recondense, bit for bit."""
    T, Q, s = _recondense_input()
    got = tschur.aed_recondense(from_numpy(T), from_numpy(Q), s, kbot)
    want = tschur._aed_recondense(from_numpy(T), from_numpy(Q), s, kbot)
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))


def test_standardize_blocks():
    n = 12
    rng = np.random.default_rng(31)
    S = np.triu(rng.standard_normal((n, n)))
    S[3, 2], S[7, 6], S[10, 9] = 0.5, -0.3, 2.0
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Sj, Qj = jschur.standardize_blocks(jnp.asarray(S), jnp.asarray(Q))
    St, Qt = tschur.standardize_blocks(from_numpy(S), from_numpy(Q))
    np.testing.assert_allclose(to_numpy(St), np.asarray(Sj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_numpy(Qt), np.asarray(Qj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kbot", [40, 37, 12, 3, 0])
def test_pack_shifts(kbot):
    WA, NS, B, TMAX = 40, 26, 9, 2
    rng = np.random.default_rng(kbot)
    T = np.triu(rng.standard_normal((WA, WA)))
    for p in range(1, WA - 1, 3):                 # many 2x2 blocks
        T[p + 1, p] = -np.sign(T[p, p + 1]) * abs(rng.standard_normal())
    er, ei = extract_eigenvalues(from_numpy(T))
    shj, npj = jschur._pack_shifts(jnp.asarray(to_numpy(er)),
                                   jnp.asarray(to_numpy(ei)), jnp.asarray(T),
                                   jnp.int32(kbot), NS, B, TMAX)
    sht, npt = tschur._pack_shifts(to_numpy(er), to_numpy(ei), np.diagonal(T, -1),
                                   kbot, NS, B, TMAX)
    assert npt == int(npj)
    np.testing.assert_array_equal(sht, np.asarray(shj))


@pytest.mark.parametrize("w", [16, 40])
def test_small_schur(w):
    H = np.triu(np.random.default_rng(w).standard_normal((w, w)), -1)
    th = U / 2 * np.linalg.norm(H)
    Sj, Zj, ij = map(np.asarray, jsmall(jnp.asarray(H), jnp.eye(w), w, th))
    St, Zt, it = tsmall(from_numpy(H), torch.eye(w, dtype=torch.float64), w, th)
    assert int(it) == int(ij) == 0
    assert schur_form_error(St) == 0.0 and schur_form_error(from_numpy(np.array(Sj))) == 0.0
    # the eigenvalues read off the diagonal blocks of each Schur form
    ej = _sorted_eigs(*jextract(jnp.asarray(Sj)))
    et = _sorted_eigs(*map(to_numpy, extract_eigenvalues(St)))
    assert np.abs(et - ej).max() <= 1e-10 * np.linalg.norm(H)
    for S, Z in ((Sj, Zj), (to_numpy(St), to_numpy(Zt))):
        res, orth = _res_orth(H, S, Z)
        assert res < GATE and orth < GATE, (res, orth)


@pytest.mark.parametrize("n,conf", [(96, JSchurConf(small_limit=128)),
                                    (200, None)])
def test_hessenberg_schur_slice(n, conf):
    """n=96 takes the small path; n=200 the AED path with WA=40, B=9,
    TMAX=2 (both packages resolve the same geometry)."""
    A = np.random.default_rng(n).standard_normal((n, n))
    Hj, Qj = jsep.hessenberg(jnp.asarray(A))
    Sj, Qj2, erj, eij, infoj = jsep.schur(Hj, Qj, conf=conf)
    Ht, Qt = tsep.hessenberg(from_numpy(A), device="cpu")
    stats = {}
    St, Qt2, ert, eit, infot = tsep.schur(Ht, Qt, conf=conf_from_jax(conf),
                                          stats=stats, device="cpu")
    assert int(infot) == int(infoj) == 0
    assert stats["path"] == ("small" if n == 96 else "aed")
    if n == 200:
        assert (stats["WA"], stats["B"], stats["TMAX"]) == (40, 9, 2)
    na = np.linalg.norm(A)
    ej, et = _sorted_eigs(erj, eij), _sorted_eigs(to_numpy(ert), to_numpy(eit))
    assert np.abs(et - ej).max() <= 1e-10 * na
    for S, Q in ((np.asarray(Sj), np.asarray(Qj2)), (to_numpy(St), to_numpy(Qt2))):
        res, orth = _res_orth(A, S, Q)
        assert res < GATE and orth < GATE, (res, orth)
        assert schur_form_error(from_numpy(np.array(S))) == 0.0


def _schur_form_cases():
    S = np.triu(np.random.default_rng(41).standard_normal((8, 8)))
    S[2, 2] = S[3, 3]
    S[3, 2], S[2, 3] = 0.5, -abs(S[2, 3]) - 0.1     # a standard complex block
    real_pair, unequal, overlap, below = (S.copy() for _ in range(4))
    real_pair[2, 3] = abs(real_pair[2, 3])
    unequal[3, 3] += 1e-9
    overlap[4, 4], overlap[4, 3], overlap[3, 4] = S[3, 3], 0.25, -1.0   # standard too
    below[6, 1] = 1e-3
    return {"valid": (S, 0.0), "real_pair": (real_pair, np.inf),
            "unequal_diagonal": (unequal, 1e-9), "overlapping_blocks": (overlap, 0.25),
            "below_subdiagonal": (below, 1e-3)}


@pytest.mark.parametrize("case", sorted(_schur_form_cases()))
def test_schur_form_error(case):
    S, want = _schur_form_cases()[case]
    got = schur_form_error(from_numpy(S))
    assert got == want if want in (0.0, np.inf) else abs(got - want) <= 1e-15 + 1e-6 * want
