"""The port's multishift QZ driver and its building blocks against the JAX
package's XLA path, on the same seeded inputs (CPU).

Single steps (the GEP spike deflation, a QZ train, the final block
standardization) agree elementwise to 1e-12: the same operations in
another summation order; the port's train runs in (6B+4)-row windows with
GEMM strip updates, the JAX one at full width.  The whole driver is held to
what it guarantees (the gates of tests/test_qz_driver.py): info, exact
generalized Schur structure, residuals and orthogonality below 5000 u.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops import hess_triangular as jht
from starneig_tpu.ops import qz_driver as jqd
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import qz_driver as tqd
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import (planted_schur_pair, qz_train_hops,
                                                   qz_train_pencil)

torch.set_num_threads(1)

U = np.finfo(np.float64).eps


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-300)


@pytest.mark.parametrize("s", [1e-13, 1e-10])
def test_aed_deflate_gep(s):
    """kbot and fail equal, the matrices within 1e-12 (spike 1e-13: some
    bottom blocks deflate, the others move up; 1e-10: none deflates and
    every block moves)."""
    WA = 40
    S, T, Q, Z = planted_schur_pair(WA, WA - 2, 7)
    thresh = U / 2 * np.linalg.norm(S)
    want = jqd._aed_deflate_gep(*(jnp.asarray(x) for x in (S, T, Q, Z)), s, WA - 2, thresh)
    got = tqd._aed_deflate_gep(*(from_numpy(x) for x in (S, T, Q, Z)), s, WA - 2, thresh)
    assert (int(got[4]), int(got[5])) == (int(want[4]), bool(want[5]))
    for w, g in zip(want[:4], got[:4]):
        assert _rel(w, to_numpy(g)) <= 1e-12


def _padded_pencil(n, P, l, seed):
    NP = n + 2 * P
    rng = np.random.default_rng(seed)
    S = np.zeros((NP, NP))
    T = np.zeros((NP, NP))
    S[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n)), -1)
    S[P + l, P + l - 1] = 0.0
    T[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    Q = np.zeros((n, NP))
    Q[:, P:P + n] = np.eye(n)
    return S, T, Q, Q.copy()


@pytest.mark.parametrize("B,n,l,ihi", [(3, 60, 5, 50), (12, 100, 4, 100)])
def test_qz_sweep(B, n, l, ihi):
    """One B-bulge train across [l, ihi): the port's windowed hops against
    the JAX full-width _qz_sweep_batch, 1e-12 relative."""
    P = 6 * B + 6
    S, T, Q, Z = _padded_pencil(n, P, l, 3 + B)
    sh = np.random.default_rng(B).standard_normal((B, 4))
    sh[:, 3] = -sh[:, 1]
    want = jqd._qz_sweep_batch(*(jnp.asarray(x) for x in (S, T, Q, Z)), P + l, P + ihi,
                               *(jnp.asarray(sh[:, i]) for i in range(4)), B=B)
    got = [from_numpy(x) for x in (S, T, Q, Z)]
    tqd._qz_sweep(*got, P + l, P + ihi, from_numpy(sh), B)
    for w, g in zip(want, got):
        assert _rel(w, to_numpy(g)) <= 1e-12


def _g3_full(S, l_rel, s0, B, HOP):
    """Kernel G3's switch to the full ranges: the hop introduces a bulge
    (bulge b enters at step s = 3b) at l_rel where S[l_rel, l_rel - 1] is
    not zero, the one input whose first reflector fills the columns left
    of the bulge."""
    intro = any(s0 <= 3 * b < s0 + HOP for b in range(B))
    return intro and 1 <= l_rel < S.shape[0] and float(S[l_rel, l_rel - 1]) != 0.0


def _g3_cut_hop(Sw, Tw, sh, l_rel, ihi_rel, s0, B, HOP, force_cut=False):
    """tqd._qz_train_hop with every update cut to the entries kernel G3
    touches: the left reflector on S's columns from k-1 and T's from k, the
    right reflector and the rotation on S's rows up to k+3 and T's up to
    k+2, and Qw's and Zw's updates on the rows [min k, max k + 2] of the
    steps so far (the rows that can differ from the identity's); the full
    ranges where _g3_full holds (unless force_cut)."""
    from starneig_tpu_torch.ops import primitives as prim
    from starneig_tpu_torch.ops.hess_triangular import rot_cols
    S, T = Sw.clone(), Tw.clone()
    WC = S.shape[0]
    Qw = torch.eye(WC, dtype=S.dtype)
    Zw = torch.eye(WC, dtype=S.dtype)
    full = _g3_full(S, l_rel, s0, B, HOP) and not force_cut
    m3 = torch.ones(3, dtype=torch.bool)
    qlo, qhi = (0, WC) if full else (WC, 0)
    for t in range(HOP):
        s = s0 + t
        act = [b for b in range(B) if l_rel <= l_rel + s - 3 * b <= ihi_rel - 2]
        if not act:
            continue
        ks = [l_rel + s - 3 * b for b in act]
        if not full:
            qlo, qhi = min(qlo, min(ks)), max(qhi, max(ks) + 3)
        use3 = torch.tensor([k <= ihi_rel - 3 for k in ks])
        intro = [k == l_rel for k in ks]
        x = torch.stack([S[k:k + 3, k - 1] if not it else S.new_zeros(3)
                         for k, it in zip(ks, intro)])
        if any(intro):
            sa = sh[act]
            ic = tqd._first_col_qz(S, T, l_rel, sa[:, 0], sa[:, 1], sa[:, 2], sa[:, 3],
                                   use3, plus_floor=True)
            x = torch.where(torch.tensor(intro)[:, None], ic, x)
        on = torch.ones_like(use3)
        v, tau, beta = prim.householder(x, torch.stack([on, on, use3], 1))
        for g, k in enumerate(ks):
            for M, c0 in ((S, 0 if full else max(k - 1, 0)), (T, 0 if full else k)):
                rows = M[k:k + 3, c0:]
                rows -= tau[g] * torch.outer(v[g], v[g] @ rows)
            qc = Qw[qlo:qhi, k:k + 3]
            qc -= tau[g] * torch.outer(qc @ v[g], v[g])
        for g, k in enumerate(ks):
            if not intro[g]:
                S[k, k - 1] = beta[g]
                S[k + 1, k - 1] = 0.0
                if bool(use3[g]):
                    S[k + 2, k - 1] = 0.0

        def reach(k):
            return (S, WC if full else min(k + 4, WC)), (T, WC if full else k + 3)
        for g, k in enumerate(ks):
            if not bool(use3[g]):
                continue
            vr, tau_r, _ = prim.householder(T[k + 2, k:k + 3].flip(0), m3)
            vr = vr.flip(0)
            for M, r1 in reach(k):
                cols = M[:r1, k:k + 3]
                cols -= tau_r * torch.outer(cols @ vr, vr)
            cols = Zw[qlo:qhi, k:k + 3]
            cols -= tau_r * torch.outer(cols @ vr, vr)
            T[k + 2, k] = 0.0
            T[k + 2, k + 1] = 0.0
        for k in ks:
            c2, s2, _ = prim.givens(T[k + 1, k + 1], T[k + 1, k])
            for M, r1 in reach(k):
                rot_cols(M[:r1], k + 1, c2, -s2)
            rot_cols(Zw[qlo:qhi], k + 1, c2, -s2)
            T[k + 1, k] = 0.0
    return S, T, Qw, Zw


@functools.lru_cache(maxsize=None)
def _g3_hops(B):
    """Every hop of one B-bulge train at a size with a middle hop."""
    return qz_train_hops({1: 40, 3: 60}.get(B, 100), B, 7 + B)


@pytest.mark.parametrize("hop", ["intro", "middle", "last", "subdiag"])
@pytest.mark.parametrize("B", [1, 3, 12, 13])
def test_g3_ranges(B, hop):
    """Kernel G3 touches only the entries of a hop that can change:
    _g3_cut_hop equals the full-width twin tqd._qz_train_hop entry for entry
    (torch.equal, so a zero's sign is not compared) on the introduction
    hop, a middle hop, the last hop (where use3 turns false) and, with
    S[l_rel, l_rel - 1] != 0, an introduction hop that must take the full
    ranges (the cut ranges alone differ there)."""
    hops, sh = _g3_hops(B)
    HOP = 3 * B
    Sw, Tw, l_rel, ihi_rel, s0 = hops[{"middle": len(hops) // 2, "last": -1}.get(hop, 0)]
    if hop == "subdiag":
        Sw = Sw.clone()
        Sw[l_rel, l_rel - 1] = 0.7
    if hop == "last":
        assert any(l_rel + s0 + t - 3 * b == ihi_rel - 2
                   for t in range(HOP) for b in range(B))
    assert _g3_full(Sw, l_rel, s0, B, HOP) == (hop == "subdiag")
    want = tqd._qz_train_hop(Sw, Tw, sh, l_rel, ihi_rel, s0, B, HOP)
    got = _g3_cut_hop(Sw, Tw, sh, l_rel, ihi_rel, s0, B, HOP)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    if hop == "subdiag":
        cut = _g3_cut_hop(Sw, Tw, sh, l_rel, ihi_rel, s0, B, HOP, force_cut=True)
        assert not all(torch.equal(w, g) for w, g in zip(want, cut))


def _train_mode_model(S, T, Q, Z, l, ihi, sh, B):
    """G3's train mode (qz_sweep.cu) in torch, in place: the hops in order;
    after hop h, its left transform on column tile h (the columns window
    h+1 takes new) as the chase applies it, on every other tile it reaches
    as the strip blocks apply it (tile j takes hop h if h < j, or every hop
    once no window takes it, j >= H - 1) and on Q's and Z's columns; S's and
    T's rows above each window after the last hop, in hop order."""
    NP, WC, HOP = S.shape[0], 6 * B + 4, 3 * B
    H = gpu_gep.sweep_hops(l, ihi, B)
    ws0 = l - 3 * (B - 1) - 1
    J = -(-(NP - ws0 - WC) // HOP)

    def tile(Qw, h, j):
        ws, c0 = ws0 + h * HOP, ws0 + WC + j * HOP
        for M in (S, T):
            M[ws:ws + WC, c0:c0 + HOP] = Qw.T @ M[ws:ws + WC, c0:c0 + HOP]
    Zs = []
    for h in range(H):
        ws = ws0 + h * HOP
        win = (slice(ws, ws + WC),) * 2
        S[win], T[win], Qw, Zw = tqd._qz_train_hop(S[win], T[win], sh, l - ws, ihi - ws,
                                                   h * HOP, B, HOP)
        if h + 1 < H:
            tile(Qw, h, h)
        for j in range(J):
            if h < j or j >= H - 1:
                tile(Qw, h, j)
        Q[:, ws:ws + WC] = Q[:, ws:ws + WC] @ Qw
        Z[:, ws:ws + WC] = Z[:, ws:ws + WC] @ Zw
        Zs.append(Zw)
    for h, Zw in enumerate(Zs):
        ws = ws0 + h * HOP
        for M in (S, T):
            M[:ws, ws:ws + WC] = M[:ws, ws:ws + WC] @ Zw


@pytest.mark.parametrize("B,n,l,ihi,sub", [(1, 40, 0, 40, 0.0), (3, 60, 5, 50, 0.0),
                                           (4, 80, 20, 70, 0.7), (6, 90, 30, 44, 0.0)])
def test_train_mode_order(B, n, l, ihi, sub):
    """The train mode's order (_train_mode_model: the strips kept current by
    column tiles beside the chase, the right transforms after) gives the
    hop loop _qz_sweep's S, T, Q and Z bit for bit: every entry takes its
    left transforms in hop order and its right ones in hop order, by the
    same products (whole segments, an inner one with ihi < n and
    S[l, l-1] != 0, one shorter than a window)."""
    S, T, Q, Z, sh, P = qz_train_pencil(n, B, 25 + B, l, ihi)
    if l > 0:
        S[P + l, P + l - 1] = sub
    want = [torch.as_tensor(x.copy()) for x in (S, T, Q, Z)]
    got = [torch.as_tensor(x.copy()) for x in (S, T, Q, Z)]
    sh = torch.as_tensor(sh)
    tqd._qz_sweep(*want, P + l, P + ihi, sh, B)
    _train_mode_model(*got, P + l, P + ihi, sh, B)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_standardize_blocks_gep():
    S, T, Q, Z = planted_schur_pair(30, 30, 4)
    # unstandardized blocks: a real pair, a coupled T entry
    S[10, 9] = 0.8
    S[9, 10] = 0.5
    T[20, 21] = 0.3
    want = jqd.standardize_blocks_gep(*(jnp.asarray(x) for x in (S, T, Q, Z)))
    got = tqd.standardize_blocks_gep(*(from_numpy(x) for x in (S, T, Q, Z)))
    for w, g in zip(want, got):
        assert _rel(w, to_numpy(g)) <= 1e-12


def test_qz_schur_n48():
    """The driver at n=48 with the default configuration (WA = 32)."""
    n = 48
    rng = np.random.default_rng(1)
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n)) + 3 * np.eye(n)
    H, T, Q, Z = (np.asarray(x) for x in jht.hessenberg_triangular(A, B))
    want = jqd.qz_schur(*(jnp.asarray(x) for x in (H, T, Q, Z)))
    stats = {}
    got = tqd.qz_schur(*(from_numpy(x) for x in (H, T, Q, Z)), stats=stats)
    assert want[7] == got[7] == Error.SUCCESS
    for S_, T_, Q_, Z_ in (want[:4], got[:4]):
        assert hooks.schur_structure_error(S_) == 0.0
        assert hooks.triangular_structure_error(T_) == 0.0
        ra, rb = hooks.residual_gep(A, B, S_, T_, Q_, Z_)
        assert max(ra, rb, hooks.orthogonality(Q_), hooks.orthogonality(Z_)) < 5000
    ev_j = np.sort_complex((np.asarray(want[4]) + 1j * np.asarray(want[5])) / np.asarray(want[6]))
    ev_t = np.sort_complex((to_numpy(got[4]) + 1j * to_numpy(got[5])) / to_numpy(got[6]))
    assert np.abs(ev_j - ev_t).max() <= 1e-9 * np.abs(ev_j).max()
    assert stats["rounds"] > 0 and stats["recondense_calls"] > 0
