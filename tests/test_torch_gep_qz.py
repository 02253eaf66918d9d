"""The port's window QZ, 2x2 pencil standardization and generalized swaps
against the JAX package's XLA path, on the same seeded inputs (CPU).

Single transforms (a swap, a standardization) agree elementwise to 1e-13:
the same operations in another summation order.  The window QZ solve is
held to what it guarantees, as the Francis solve is in
``test_torch_schur.py``: the same info, a generalized Schur form on both
sides (exact structure), residuals and orthogonality below 500 u on both,
and the spectrum: within 1e-10 of JAX's (chordal) on a random window, and
with a chordal error against the planted spectrum within 10x of JAX's on a
known-spectrum window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops import hess_triangular as jht
from starneig_tpu.ops import qz as jqz
from starneig_tpu.ops import swaps_gep as jsw
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.ops import qz as tqz
from starneig_tpu_torch.ops import swaps_gep as tsw
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues_gen
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import known_spectrum_pencil

torch.set_num_threads(1)

U = np.finfo(np.float64).eps
GATE = 500.0


def _ht(A, B):
    return [np.asarray(x) for x in jht.hessenberg_triangular(jnp.asarray(A), jnp.asarray(B))]


def _both_qz(H, T, Q, Z):
    n = H.shape[0]
    th = U / 2 * np.linalg.norm(H)
    tt = U / 2 * np.linalg.norm(T)
    j = [np.asarray(x) for x in jqz.small_qz(*(jnp.asarray(x) for x in (H, T, Q, Z)),
                                             n, th, tt)]
    t = [to_numpy(x) for x in tqz.small_qz(*(from_numpy(x) for x in (H, T, Q, Z)),
                                           n, th, tt)]
    return j, t


def _gates(A, B, S, Tt, Q, Z):
    ra, rb = hooks.residual_gep(A, B, S, Tt, Q, Z)
    assert max(ra, rb, hooks.orthogonality(Q), hooks.orthogonality(Z)) < GATE
    assert hooks.schur_structure_error(S) == 0.0
    assert hooks.triangular_structure_error(Tt) == 0.0


def _eigs(S, Tt):
    return [to_numpy(x) for x in extract_eigenvalues_gen(from_numpy(S), from_numpy(Tt))]


@pytest.mark.parametrize("w", [8, 24, 48])
def test_small_qz(w):
    rng = np.random.default_rng(w)
    A = rng.standard_normal((w, w))
    B = rng.standard_normal((w, w)) + 3 * np.eye(w)
    j, t = _both_qz(*_ht(A, B))
    assert int(j[4]) == int(t[4]) == 0
    for S, Tt, Q, Z, _i in (j, t):
        _gates(A, B, S, Tt, Q, Z)
    ar, ai, bt = _eigs(j[0], j[1])
    assert hooks.chordal_eigenvalue_error(*_eigs(t[0], t[1]), ar + 1j * ai, bt) * U < 1e-10


def test_small_qz_known_spectrum():
    """A window with 30% complex pairs and 20% infinite eigenvalues: the
    chordal error against the planted spectrum within 10x of JAX's (both are
    large: scrambling smears B's exact singularity, as with LAPACK)."""
    A, B, alpha, beta = known_spectrum_pencil(40, complex_ratio=0.3, inf_ratio=0.2, seed=3)
    j, t = _both_qz(*_ht(A, B))
    assert int(j[4]) == int(t[4]) == 0
    errs = []
    for S, Tt, Q, Z, _i in (j, t):
        _gates(A, B, S, Tt, Q, Z)
        errs.append(hooks.chordal_eigenvalue_error(*_eigs(S, Tt), alpha, beta))
    assert errs[1] <= 10 * errs[0]


def test_small_qz_active_block():
    """An active m < w block with an AED window's dead diagonal (T = 1
    outside), as the driver passes it."""
    w, m = 20, 14
    rng = np.random.default_rng(9)
    H = np.zeros((w, w))
    T = np.eye(w)
    H[:m, :m] = np.triu(rng.standard_normal((m, m)), -1)
    T[:m, :m] = np.triu(rng.standard_normal((m, m))) + 3 * np.eye(m)
    eye = np.eye(w)
    th, tt = U / 2 * np.linalg.norm(H), U / 2 * np.linalg.norm(T)
    j = [np.asarray(x) for x in jqz.small_qz(*(jnp.asarray(x) for x in (H, T, eye, eye)),
                                             m, th, tt)]
    t = [to_numpy(x) for x in tqz.small_qz(*(from_numpy(x) for x in (H, T, eye, eye)),
                                           m, th, tt)]
    assert int(j[4]) == int(t[4]) == 0
    S, Tt, Q, Z, _ = t
    np.testing.assert_array_equal(Q[m:], eye[m:])
    np.testing.assert_array_equal(Z[:, m:], eye[:, m:])
    _gates(H[:m, :m], T[:m, :m], S[:m, :m], Tt[:m, :m], Q[:m, :m], Z[:m, :m])


def _swap_case(p, q, seed):
    rng = np.random.default_rng(seed)
    A = np.triu(rng.standard_normal((4, 4)))
    B = np.triu(rng.standard_normal((4, 4))) + 2 * np.eye(4)
    for off, sz in ((0, p), (p, q)):
        if sz == 2:
            A[off + 1, off] = -abs(rng.standard_normal()) - 0.1
            A[off, off + 1] = abs(A[off, off + 1]) + 0.1
            B[off, off + 1] = 0.0
    return A, B


@pytest.mark.parametrize("p,q", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_swap_adjacent_gep(p, q):
    A, B = _swap_case(p, q, 10 * p + q)
    want = jsw.swap_adjacent_gep(jnp.asarray(A), jnp.asarray(B), p, q)
    got = tsw.swap_adjacent_gep(from_numpy(A), from_numpy(B), p, q)
    assert bool(want[4]) and got[4]
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0, atol=1e-13)


@pytest.mark.parametrize("p", [1, 2])
def test_swap_adjacent_gep_equal_blocks(p):
    """Equal adjacent blocks (a singular Sylvester system): both packages
    take the same decision, and an accepted swap is an exact equivalence
    (Qs^T A Zs = Ah, Qs^T B Zs = Bh to rounding) with (2,1) blocks zero."""
    if p == 1:
        A = np.triu(np.arange(1.0, 17.0).reshape(4, 4))
        A[1, 1] = A[0, 0]
    else:
        A = np.array([[1.0, 2, 3, -1], [-0.5, 1, 2, 5], [0, 0, 1, 2], [0, 0, -0.5, 1]])
    B = np.eye(4)
    want = jsw.swap_adjacent_gep(jnp.asarray(A), jnp.asarray(B), p, p)
    got = [to_numpy(x) if torch.is_tensor(x) else x for x in
           tsw.swap_adjacent_gep(from_numpy(A), from_numpy(B), p, p)]
    assert bool(want[4]) == got[4]
    Qs, Zs, Ah, Bh, accept = got
    if accept:
        np.testing.assert_allclose(Qs.T @ A @ Zs, Ah, rtol=0, atol=1e-12 * np.abs(A).max())
        np.testing.assert_allclose(Qs.T @ B @ Zs, Bh, rtol=0, atol=1e-12)
        assert np.abs(Ah[p:2 * p, :p]).max() == 0.0 and np.abs(Bh[p:2 * p, :p]).max() == 0.0
    else:
        np.testing.assert_array_equal(Ah, A)
        np.testing.assert_array_equal(Qs, np.eye(4))


@pytest.mark.parametrize("case", ["complex", "real", "singular_b"])
def test_standardize_gep_2x2(case):
    rng = np.random.default_rng(len(case))
    A2 = rng.standard_normal((2, 2))
    B2 = np.triu(rng.standard_normal((2, 2))) + np.eye(2)
    if case == "complex":
        A2 = np.array([[0.3, 2.0], [-1.5, 0.1]])
        B2 = np.array([[1.2, 0.0], [0.0, 0.9]])
    elif case == "real":
        A2[1, 0] = abs(A2[1, 0]) + 1.0
        A2[0, 1] = abs(A2[0, 1]) + 1.0
    else:
        B2[0, 0] = 0.0
    want = jqz.standardize_gep_2x2(jnp.asarray(A2), jnp.asarray(B2))
    got = tqz.standardize_gep_2x2(from_numpy(A2), from_numpy(B2))
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# kernel G2's sweep schedule, modelled in plain torch
# ---------------------------------------------------------------------------
# qz_window.cu runs a sweep in blocks of steps: a chase warp runs the steps
# of a block on the near-diagonal windows of H and T (rows k0..k1+3,
# columns k0-1..k1+2), applying the left reflector to the windows' columns,
# and the right reflector and the rotation to rows k+1..k+3 (H) and
# k+1..k+2 (T) only; everything else is deferred: the far columns' left
# updates (the chase warp slides the first of them itself before the next
# block), the right updates and rotations of rows 0..k (from step
# max(r, k0) on), Q's and Z's updates.  The update warps may apply block
# b's deferred work as late as after block b+1's steps, so the model below
# does exactly that: if any step read an entry whose update was deferred,
# its sweep would part from ops/qz.py:_sweep.


def _g2_schedule_sweep(kb):
    """A drop-in for ops/qz.py:_sweep running kernel G2's schedule with
    blocks of kb steps (the kernel's kBlockSteps and kNear are 32)."""
    from starneig_tpu_torch.ops import primitives as prim
    from starneig_tpu_torch.ops.hess_triangular import rot_cols

    def left(rows, v, tau):
        rows -= tau * torch.outer(v, v @ rows)

    def right(cols, vr, tau_r):
        cols -= tau_r * torch.outer(cols @ vr, vr)

    def sweep(Hp, Tp, Qp, Zp, w, l, i, its):
        sr1, si1, sr2, si2 = tqz._shifts_qz(Hp[:w, :w], Tp[:w, :w], i, its)
        WP = Hp.shape[0]
        m3 = torch.ones(3, dtype=torch.bool)
        m2 = m3.clone()
        m2[2] = False
        blocks = [(k0, min(k0 + kb - 1, i - 1)) for k0 in range(l, i, kb)]
        logs = []

        def chase(b):
            k0, k1 = blocks[b]
            c_hi, R0, C0 = k1 + 3, k0, max(k0 - 1, 0)
            Hw = Hp[R0:k1 + 4, C0:c_hi].clone()
            Tw = Tp[R0:k1 + 4, C0:c_hi].clone()
            log = []
            for k in range(k0, k1 + 1):
                use3 = k <= i - 2
                r, c = k - R0, k - C0
                if k == l:
                    x = tqz._first_col_qz(Hw[r:, c:], Tw[r:, c:], 0, sr1, si1, sr2, si2)
                else:
                    x = Hw[r:r + 3, c - 1].clone()
                v, tau, beta = prim.householder(x, m3 if use3 else m2)
                left(Hw[r:r + 3, max(k - 1, C0) - C0:], v, tau)
                left(Tw[r:r + 3, c:], v, tau)
                if k > l:
                    Hw[r, c - 1] = beta
                    Hw[r + 1, c - 1] = 0.0
                    if use3:
                        Hw[r + 2, c - 1] = 0.0
                vr = tau_r = None
                if use3:
                    vr, tau_r, _ = prim.householder(Tw[r + 2, c:c + 3].flip(0), m3)
                    vr = vr.flip(0)
                    right(Hw[r + 1:r + 4, c:c + 3], vr, tau_r)
                    right(Tw[r + 1:r + 3, c:c + 3], vr, tau_r)
                    Tw[r + 2, c] = 0.0
                    Tw[r + 2, c + 1] = 0.0
                c2, s2, _ = prim.givens(Tw[r + 1, c + 1], Tw[r + 1, c])
                rot_cols(Hw[r + 1:r + 4], c + 1, c2, -s2)
                rot_cols(Tw[r + 1:r + 2], c + 1, c2, -s2)
                Tw[r + 1, c] = 0.0
                log.append((k, v, tau, vr, tau_r, c2, s2))
            Hp[R0:k1 + 4, C0:c_hi] = Hw
            Tp[R0:k1 + 4, C0:c_hi] = Tw
            logs.append(log)

        def far(b, c_from, c_to):
            for k, v, tau, *_ in logs[b]:
                for M in (Hp, Tp):
                    left(M[k:k + 3, c_from:c_to], v, tau)

        def far_start(b):
            return blocks[b][1] + 3 + (kb if b + 1 < len(blocks) else 0)

        def rest(b):
            k1 = blocks[b][1]
            far(b, far_start(b) + kb, WP)
            for k, v, tau, vr, tau_r, c2, s2 in logs[b]:
                qc = Qp[:, k:k + 3]
                qc -= tau * torch.outer(qc @ v, v)
                for M, hi in ((Hp, min(k1, k) + 1), (Tp, min(k1, k) + 1), (Zp, w)):
                    if vr is not None:
                        right(M[:hi, k:k + 3], vr, tau_r)
                    rot_cols(M[:hi], k + 1, c2, -s2)

        for b in range(len(blocks)):
            chase(b)
            if b >= 1:
                far(b - 1, far_start(b - 1), far_start(b - 1) + kb)
            if b + 1 < len(blocks):
                c_hi = blocks[b][1] + 3
                far(b, c_hi, c_hi + kb)
            if b >= 1:
                rest(b - 1)
        last = len(blocks) - 1
        far(last, far_start(last), far_start(last) + kb)
        rest(last)

    return sweep


def _qz_decisions(monkeypatch, sweep, H, T, w):
    """_small_qz_plain on the window with ops/qz.py:_sweep replaced by
    sweep; returns its output and every iteration's (l, i, jinf)."""
    seen = []
    find_inf = tqz._find_inf

    def find_logged(Hp, Tp, w_, l, i, thresh_h, thresh_t):
        j = find_inf(Hp, Tp, w_, l, i, thresh_h, thresh_t)
        seen.append((l, i, j))
        return j
    with monkeypatch.context() as mp:
        mp.setattr(tqz, "_find_inf", find_logged)
        mp.setattr(tqz, "_sweep", sweep)
        eye = torch.eye(w, dtype=torch.float64)
        out = tqz._small_qz_plain(torch.as_tensor(H), torch.as_tensor(T), eye, eye, w,
                                  U / 2 * np.linalg.norm(H), U / 2 * np.linalg.norm(T))
    return out, seen


@pytest.mark.parametrize("w,kb", [(24, 8), (24, 32), (84, 8), (84, 32)])
def test_g2_schedule(monkeypatch, w, kb):
    """Kernel G2's blocked sweep schedule (_g2_schedule_sweep: the near
    windows first, the deferred far columns, rows above, Q and Z as late as
    the kernel's update warps may apply them) against ops/qz.py:_sweep over
    a whole window solve: the same deflation decisions (l, i and the
    infinite-eigenvalue test of every iteration) and the outputs within
    1e-13 max|M| (the same operations on each entry, in the same order,
    on other slices)."""
    rng = np.random.default_rng(w)
    H = np.triu(rng.standard_normal((w, w)), -1)
    T = np.triu(rng.standard_normal((w, w))) + 3 * np.eye(w)
    want, want_seen = _qz_decisions(monkeypatch, tqz._sweep, H, T, w)
    got, got_seen = _qz_decisions(monkeypatch, _g2_schedule_sweep(kb), H, T, w)
    assert got_seen == want_seen
    assert sum(i - l >= 2 and j < 0 for l, i, j in want_seen) > 3 * w // 8  # sweeps
    assert int(got[4]) == int(want[4]) == 0
    for g, x in zip(got[:4], want[:4]):
        assert float((g - x).abs().max()) <= 1e-13 * float(x.abs().max())
