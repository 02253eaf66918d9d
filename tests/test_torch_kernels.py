"""Each hand-written CUDA kernel against its plain PyTorch twin, on the card.

These tests need a CUDA device and nvcc; without a card every test skips
(the CPU suite covers the plain twins against the JAX package instead).
On the card, ``python -m pytest tests/test_torch_kernels.py`` builds the
kernels and runs them.  Tolerances are stated per test: the kernels and
the twins run the same operations, differing only in summation order and
fused multiply-adds.
"""

import numpy as np
import pytest
import torch

from starneig_tpu_torch import kernels
from starneig_tpu_torch.ops import gpu_hess, gpu_reorder, gpu_schur
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
from starneig_tpu_torch.ops.reorder import _window_bubble
from starneig_tpu_torch.ops.schur import _aed_deflate, _aed_recondense, _train_hop
from starneig_tpu_torch.ops.small_schur import _small_schur_plain
from starneig_tpu_torch.testing.generators import planted_windows
from starneig_tpu_torch.testing.hooks import schur_form_error

U = np.finfo(np.float64).eps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _hess(w, seed):
    return np.triu(np.random.default_rng(seed).standard_normal((w, w)), -1)


def _block_eigs(S, m):
    """Sorted eigenvalues read off the diagonal blocks of S[:m, :m]."""
    er, ei = extract_eigenvalues(S[:m, :m])
    return np.sort_complex(er.cpu().numpy() + 1j * ei.cpu().numpy())


def _gemv_case(kind, trans, j, cuda):
    """(M, x) for a B1 case: a view with offsets into a small matrix; the
    panel loop's V[:, :j] (4000 rows, ld 288, a row offset); or T[:j, :j]
    (ld 288)."""
    rng = np.random.default_rng(int(trans) if j is None else j + int(trans))
    if kind == "view":
        M = torch.as_tensor(rng.standard_normal((700, 500)), device=cuda)[37:, 11:]
    elif kind == "panel":
        M = torch.as_tensor(rng.standard_normal((4100, 288)), device=cuda)[100:, :j]
    else:
        M = torch.as_tensor(rng.standard_normal((288, 288)), device=cuda)[:j, :j]
    x = torch.as_tensor(rng.standard_normal(M.shape[0] if trans else M.shape[1]),
                        device=cuda)
    return M, x


@pytest.mark.parametrize("kind,trans,j,tol", [
    ("view", False, None, 1e-13), ("view", True, None, 1e-13),
    *[("panel", True, j, 1e-12) for j in (1, 31, 32, 33, 288)],
    *[("T", True, j, 1e-12) for j in (32, 144, 288)]])
def test_gemv(cuda, kind, trans, j, tol):
    M, x = _gemv_case(kind, trans, j, cuda)
    n0 = kernels.LAUNCHES["hess_gemv"]
    got = gpu_hess.gemv(M, x, trans)
    assert kernels.LAUNCHES["hess_gemv"] == n0 + 1
    want = gpu_hess.gemv_plain(M, x, trans)
    scale = float(gpu_hess.gemv_plain(M.abs(), x.abs(), trans).max())
    # summation order only
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("kind,j", [("panel", 288), ("panel", 33), ("T", 144)])
def test_gemv_trans_repeatable(cuda, kind, j):
    """The transposed mode sums across blocks in a fixed order: two launches
    give the same bits."""
    M, x = _gemv_case(kind, True, j, cuda)
    first = gpu_hess.gemv(M, x, True)
    assert torch.equal(first, gpu_hess.gemv(M, x, True))


# at w = 96 and 130 several 32-step blocks of a sweep are in flight at once
@pytest.mark.parametrize("w,m", [(16, 16), (40, 40), (40, 31), (96, 96), (130, 130)])
def test_francis(cuda, w, m):
    Hn = _hess(w, w + m)
    Hn[m:], Hn[:, m:] = 0.0, 0.0
    H = torch.as_tensor(Hn, device=cuda)
    Z = torch.eye(w, dtype=torch.float64, device=cuda)
    th = U / 2 * np.linalg.norm(Hn)
    Sk, Zk, ik = gpu_schur.francis(H, Z, m, th)
    Sp, Zp, ip = _small_schur_plain(H, Z, m, th)
    assert int(ik) == int(ip) == 0
    assert schur_form_error(Sk) == 0.0 and schur_form_error(Sp) == 0.0
    assert np.abs(_block_eigs(Sk, m) - _block_eigs(Sp, m)).max() \
        <= 1e-10 * np.linalg.norm(Hn)
    S, Zn = Sk.cpu().numpy(), Zk.cpu().numpy()
    assert np.linalg.norm(Zn @ S @ Zn.T - Hn) / np.linalg.norm(Hn) / U < 500


def test_train_hops(cuda):
    B, WC, HOP = 3, 22, 9
    rng = np.random.default_rng(3)
    W = torch.as_tensor(np.stack([_hess(WC, g) for g in range(4)]), device=cuda)
    sh = rng.standard_normal((4, B, 4))
    sh[:, :, 3] = -sh[:, :, 1]
    sh = torch.as_tensor(sh, device=cuda)
    args = ([0, 1, 2, 3], [7, 1, -2, -2], [62, 0, 62, 11], [0, 0, 9, 9])
    Wk, Qk = gpu_schur.train_hops(W, sh, *args, B=B, HOP=HOP)
    Wp, Qp = _train_hop(W, sh, *args[1:], B=B, HOP=HOP)
    assert float((Wk - Wp).abs().max()) <= 1e-12 * float(W.abs().max())
    assert float((Qk - Qp).abs().max()) <= 1e-12
    assert torch.equal(Wk[1], W[1])          # the parked train


def _hop_case(B, G, seed, cuda, subdiag=False):
    """G windows of B-bulge trains (WC = 6B + 4, HOP = 3B): a train entering
    its range, a parked train, a train one hop later, one leaving its range,
    repeated to G.  A train entering its range at l_rel meets W[l_rel,
    l_rel - 1] = 0, as a sweep gives it, unless subdiag (then the kernel
    runs its full ranges)."""
    WC, HOP = 6 * B + 4, 3 * B
    rng = np.random.default_rng(seed)
    W = np.stack([_hess(WC, seed + g) for g in range(G)])
    sh = rng.standard_normal((G, B, 4))
    sh[:, :, 3] = -sh[:, :, 1]
    first = 3 * (B - 1) + 1
    trains = ([(first, WC + 40, 0), (1, 0, 0), (first - HOP, WC + 40, HOP),
               (first - HOP, first + HOP // 2, HOP)] * G)[:G]
    l_rel, ihi_rel, s0 = (list(t) for t in zip(*trains))
    if not subdiag:
        for g in range(G):
            if s0[g] == 0 and ihi_rel[g] > l_rel[g]:
                W[g, l_rel[g], l_rel[g] - 1] = 0.0
    return (torch.as_tensor(W, device=cuda), torch.as_tensor(sh, device=cuda), list(range(G)),
            l_rel, ihi_rel, s0, HOP)


# the n=4000 path's (B, TMAX), n=10,000's B with five trains, and n=20,000's
# B with two: B above the old kernel's limit of 64 (ROADMAP fault C1); then
# the n=4000 shape with nonzero subdiagonals at the introductions, the one
# input of the kernel's full-range path
@pytest.mark.parametrize("B,G,subdiag", [(25, 5, False), (65, 5, False), (132, 2, False),
                                         (25, 5, True)],
                         ids=["25-5", "65-5", "132-2", "25-5-subdiag"])
def test_train_hops_geometry(cuda, B, G, subdiag):
    W, sh, gidx, l_rel, ihi_rel, s0, HOP = _hop_case(B, G, 11 + B, cuda, subdiag)
    Wk, Qk = gpu_schur.train_hops(W, sh, gidx, l_rel, ihi_rel, s0, B=B, HOP=HOP)
    Wp, Qp = _train_hop(W, sh, l_rel, ihi_rel, s0, B=B, HOP=HOP)
    # per window, the same operations in another summation order and with
    # other FMA contractions: 1e-12 (W relative to |W|) below B = 65.  From
    # B = 65 on, 1e-11, or 4 times what one ulp of input moves the plain
    # twin's result where that is larger: the introduction of B bulges into
    # a random window amplifies a one-ulp change by up to ~1e5 (1.2e-11 |W|
    # at B = 65, 2.3e-11 |W| at B = 132 here), and each of the two rounds
    # every step of it
    scale = W.abs().amax(dim=(1, 2))
    ew = (Wk - Wp).abs().amax(dim=(1, 2)) / scale
    eq = (Qk - Qp).abs().amax(dim=(1, 2))
    if B < 65:
        tw = tq = torch.full_like(ew, 1e-12)
    else:
        sign = torch.as_tensor(np.random.default_rng(5).choice([-1.0, 1.0], W.shape),
                               device=cuda)
        Wu = torch.where(W == 0, W, torch.nextafter(W, sign * float("inf")))
        Wb, Qb = _train_hop(Wu, sh, l_rel, ihi_rel, s0, B=B, HOP=HOP)
        tw = torch.clamp(4 * (Wb - Wp).abs().amax(dim=(1, 2)) / scale, min=1e-11)
        tq = torch.clamp(4 * (Qb - Qp).abs().amax(dim=(1, 2)), min=1e-11)
    assert bool((ew <= tw).all()) and bool((eq <= tq).all()), (ew, tw, eq, tq)
    assert torch.equal(Wk[1], W[1])          # the parked train
    for g in range(G):
        Wn, Wo, Qn = W[g].cpu().numpy(), Wk[g].cpu().numpy(), Qk[g].cpu().numpy()
        assert np.linalg.norm(Qn.T @ Wn @ Qn - Wo) / np.linalg.norm(Wn) < 1e-13
        assert np.linalg.norm(Qn.T @ Qn - np.eye(len(Qn))) < 1e-12


def _deflate_input(WA, w, seed, plants=None, reject_gap=None):
    """A Schur-form window with planted 2x2 blocks.  With reject_gap, the
    bottom 2x2 block has an exact twin reject_gap rows above it (as
    testing/generators.py:planted_windows plants a rejected swap) and the
    1x1 blocks between are uncoupled from it, so its move is rejected after
    reject_gap accepted swaps."""
    rng = np.random.default_rng(seed)
    T = np.zeros((WA, WA))
    T[:w, :w] = np.triu(rng.standard_normal((w, w)))
    top = w - 4 - reject_gap if reject_gap else w
    for p in plants or range(6, top - 2, 8):
        T[p + 1, p] = -abs(rng.standard_normal())
        T[p, p + 1] = abs(rng.standard_normal())
    if reject_gap:
        b = w - 2
        for r in (b, top):
            T[r:r + 2, r:r + 2] = [[1.0, 2.0], [-0.5, 1.0]]
        T[top + 2:b, b:b + 2] = 0.0
        T[top:top + 2, b:b + 2] = [[3.0, -1.0], [2.0, 5.0]]
    V = np.eye(WA)
    V[:w, :w], _ = np.linalg.qr(np.eye(w) + 0.05 * rng.standard_normal((w, w)))
    return T, V


# the planted w=40 window; the n=4000 path's WA=322 buffer with w=60 and
# w=322, whose moves cross many of the engine's 32-swap segments; moves
# rejected after 20 swaps (mid-segment) and after 40 (in the second segment)
@pytest.mark.parametrize("WA,w,seed,plants,gap,fail", [
    (40, 40, 5, (6, 14, 30), None, 0), (322, 60, 5, None, None, 0),
    (322, 322, 6, None, None, 0), (322, 322, 9, None, 20, 1),
    (322, 60, 9, None, 40, 1)])
def test_aed_deflate(cuda, WA, w, seed, plants, gap, fail):
    T, V = _deflate_input(WA, w, seed, plants, gap)
    Td, Vd = torch.as_tensor(T, device=cuda), torch.as_tensor(V, device=cuda)
    Tk, Vk, kk, fk = gpu_schur.aed_deflate(Td, Vd, 0.8, w, 1e-13)
    # the plain twin on the CPU: the same swap sequence, 10^2-10^4 times
    # faster there than its host-driven loop on the card
    Tp, Vp, kp, fp = _aed_deflate(torch.as_tensor(T), torch.as_tensor(V), 0.8, w, 1e-13)
    assert (int(kk), int(fk)) == (int(kp), int(fp))
    assert int(fk) == fail
    # FMA contraction, summation order and the engine's accumulated segment
    # transforms change the rounding only
    Tk, Vk = Tk.cpu(), Vk.cpu()
    assert float((Tk - Tp).abs().max()) <= 1e-10 * float(np.abs(T).max())
    assert float((Vk - Vp).abs().max()) <= 1e-10
    Us = V.T @ Vk.numpy()
    assert np.linalg.norm(Us.T @ T @ Us - Tk.numpy()) / np.linalg.norm(T) / U < 500


def _recondense_input(cuda):
    # the input of tests/test_pallas_kernels.py:74
    rng = np.random.default_rng(3)
    T = np.triu(rng.standard_normal((40, 40)))
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    return T, Q, torch.as_tensor(T, device=cuda), torch.as_tensor(Q, device=cuda)


@pytest.mark.parametrize("kbot", [10, 1, 0])
def test_recondense(cuda, kbot):
    T, Q, Td, Qd = _recondense_input(cuda)
    Tk, Vk, bk = gpu_schur.aed_recondense(Td, Qd, 0.37, kbot)
    Tp, Vp, bp = _aed_recondense(Td, Qd, 0.37, kbot)
    # the same reflectors in another summation order
    assert float((Tk - Tp).abs().max()) <= 1e-12 * float(Td.abs().max())
    assert float((Vk - Vp).abs().max()) <= 1e-12
    assert abs(float(bk) - float(bp)) <= 1e-12


def test_recondense_near_breakdown(cuda):
    """kbot = 25 reduces to a subdiagonal of 3.8e-10 (ROADMAP section C):
    hold the kernel to the contract, as tests/test_torch_schur.py does."""
    T, Q, Td, Qd = _recondense_input(cuda)
    kbot, s = 25, 0.37
    Tk, Vk, bk = gpu_schur.aed_recondense(Td, Qd, s, kbot)
    To, Vo = Tk.cpu().numpy(), Vk.cpu().numpy()
    Us = Q.T @ Vo
    assert np.linalg.norm(Us.T @ T @ Us - To) / np.linalg.norm(T) < 1e-14
    assert np.linalg.norm(Us.T @ Us - np.eye(40)) < 1e-13
    assert np.abs(np.tril(To[:kbot, :kbot], -2)).max() == 0.0
    spike = Us.T @ np.where(np.arange(40) < kbot, s * Q[0], 0.0)
    assert abs(spike[0] - float(bk)) < 1e-13 and np.abs(spike[1:kbot]).max() < 1e-13


def _recondense_contract(T, V0, s, kbot, To, Vo, beta):
    """(similarity, orthogonality, below-subdiagonal, spike) of a recondense
    (To, Vo, beta) of (T, V0), as chip_smoke.recondense_contract."""
    Us = V0.T @ Vo
    res = np.linalg.norm(Us.T @ T @ Us - To) / np.linalg.norm(T)
    orth = np.linalg.norm(Us.T @ Us - np.eye(len(T)))
    struct = np.abs(np.tril(To[:kbot, :kbot], -2)).max(initial=0.0)
    spike = Us.T @ np.where(np.arange(len(T)) < kbot, s * V0[0], 0.0)
    return res, orth, struct, max(abs(spike[0] - beta), np.abs(spike[1:kbot]).max(initial=0.0))


# the window an AED round gives B5: the Hessenberg form of a dense matrix
# solved by B2, kbot at a block boundary.  WA=322 (n=4000), near 300: the
# reduction is determined elementwise there, so 1e-10 |T| of the plain twin
# and the contract; WA=802 (n=10,000), near 780: the contract, whose
# similarity and orthogonality grow as sqrt(WA) WA u (5e-13 at WA=802)
@pytest.mark.parametrize("WA,near,lim", [(322, 300, (1e-13, 1e-12, 1e-13)),
                                         (802, 780, (1e-12, 1e-11, 1e-12))])
def test_recondense_window(cuda, WA, near, lim):
    from starneig_tpu_torch.api import sep
    Hw, _ = sep.hessenberg(np.random.default_rng(2).standard_normal((WA, WA)), device=cuda)
    Sw, Zw, info = gpu_schur.francis(Hw, torch.eye(WA, dtype=torch.float64, device=cuda),
                                     WA, U / 2 * float(torch.linalg.norm(Hw)))
    assert int(info) == 0
    kb = near if float(Sw[near, near - 1]) == 0 else near + 1
    n0 = kernels.LAUNCHES["recondense"]
    Tk, Vk, bk = gpu_schur.aed_recondense(Sw, Zw, 0.3, kb)
    assert kernels.LAUNCHES["recondense"] == n0 + 1
    res, orth, struct, sp = _recondense_contract(
        Sw.cpu().numpy(), Zw.cpu().numpy(), 0.3, kb, Tk.cpu().numpy(), Vk.cpu().numpy(),
        float(bk))
    assert res < lim[0] and orth < lim[1] and struct == 0.0 and sp < lim[2]
    if WA == 322:
        Tp, Vp, bp = _aed_recondense(Sw, Zw, 0.3, kb)
        assert float((Tk - Tp).abs().max()) <= 1e-10 * float(Sw.abs().max())
        assert float((Vk - Vp).abs().max()) <= 1e-10
        assert abs(float(bk) - float(bp)) <= 1e-12


def test_schur_b70(cuda):
    """sep.schur at n=1,200 with 70 bulges a train (WA=202, NS=160, B=70,
    WC=424, TMAX=2): B3 above the old limit of 64 on the solver's own calls,
    held to the reference's gates (info 0, residual and orthogonality <
    500 u, standardized Schur form)."""
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.config import SchurConf
    n = 1200
    A = np.random.default_rng(1200).standard_normal((n, n))
    kernels.reset_launches()
    H, Q = sep.hessenberg(A, device=cuda)
    stats = {}
    S, Qs, _er, _ei, info = sep.schur(
        H, Q, conf=SchurConf(aed_window_size=200, aed_shift_count=160, shifts_per_window=140),
        stats=stats, device=cuda)
    assert tuple(stats[k] for k in ("WA", "NS", "B", "WC", "TMAX")) == (202, 160, 70, 424, 2)
    assert int(info) == 0 and kernels.LAUNCHES["train_hops"] > 0
    assert schur_form_error(S) == 0.0
    S, Qs = S.cpu().numpy(), Qs.cpu().numpy()
    assert np.linalg.norm(Qs @ S @ Qs.T - A) / np.linalg.norm(A) / U < 500
    assert np.linalg.norm(Qs @ Qs.T - np.eye(n)) / np.sqrt(n) / U < 500


# (G, W, seed, (dst0s, dst_limits, wlims)): frozen top and bottom rows and a
# capped insertion at W=24; at the n=4000 reordering's W=160, frozen rows at
# both ends and an insertion limit that stops window 1's chain early
@pytest.mark.parametrize("G,W,seed,lims", [
    (3, 24, 4, ([0, 1, 0], [24, 24, 6], [24, 23, 24])),
    (3, 160, 8, ([3, 1, 0], [160, 40, 160], [159, 160, 159]))])
def test_reorder_bubble(cuda, G, W, seed, lims):
    Ts, sels = planted_windows(G, W, seed)     # window 0 rejects a swap
    Td = torch.as_tensor(Ts, device=cuda)
    Tk, Qk, selk, dstk, nfk, nsk = gpu_reorder.window_bubble(Td, sels, *lims)
    assert nfk[0] >= 1
    Tk, Qk = Tk.cpu(), Qk.cpu()
    for g in range(G):
        Tp, Qp, selp, dstp, nfp, nsp = _window_bubble(
            torch.as_tensor(Ts[g]), sels[g], lims[0][g], lims[1][g], lims[2][g])
        assert (dstk[g], nfk[g], nsk[g]) == (dstp, nfp, nsp)
        np.testing.assert_array_equal(selk[g], selp)
        # the same swap sequence; FMA contraction, summation order and the
        # engine's accumulated segment transforms change the rounding only
        assert float((Tk[g] - Tp).abs().max()) <= 1e-10 * float(Td[g].abs().max())
        assert float((Qk[g] - Qp).abs().max()) <= 1e-10
