"""Multishift QZ with aggressive early deflation: the large-n GEP driver.

Port of ``starneig_tpu/ops/qz_driver.py``.  The mathematics is the JAX
package's: rounds of a deflation scan and then EITHER a windowed push of
an infinite eigenvalue (a negligible T diagonal in the active segment) OR
an AED round (window QZ solve, spike deflation with generalized block
swaps, shifts from the undeflated window, recondense to
Hessenberg-triangular form, window-transform GEMMs), each AED round
followed by sweeps of B-bulge QZ trains; a final 2x2 standardization pass.

What changes is the control, as in ``ops/schur.py``: the JAX package ran
the iteration as one device program; here it is a host loop over rounds
whose shape-deciding integers (ihi, l, the window size, kbot, the train
count) live on the host, read from the device a fixed number of times a
round: the subdiagonal and T's diagonal after the negligible-entry scan,
and one status vector after the window solve and deflation.  The serial
loops run as one kernel launch each on CUDA (the dispatchers
:func:`aed_deflate_gep`, :func:`aed_recondense_gep`, :func:`qz_train_hop`
and ``ops/qz.py:small_qz`` run the plain twins for CPU tensors).  The
trains run in windows of 6B+4 rows, as the SEP sweep does
(``ops/schur.py:_sweep_wave``): the kernel chases inside the window and
the off-window strips update by GEMMs.  The windowed infinite-eigenvalue
push runs its window chase as kernel G5 on CUDA (the dispatcher
:func:`inf_chase`; plain twin ``_inf_chase_kernel``); the deflating
rotation at the segment bottom (``_deflate_inf_bottom``) is one rotation
and stays plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.config import SchurConf
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import primitives as prim
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues_gen
from starneig_tpu_torch.ops.hess_triangular import cascade_step, rot_cols, rot_rows
from starneig_tpu_torch.ops.qz import ULP, _first_col_qz, small_qz, std_gep_2x2
from starneig_tpu_torch.ops.schur import DenseExtent, _pack_shifts
from starneig_tpu_torch.ops.swaps_gep import swap_adjacent_gep



# ---------------------------------------------------------------------------
# AED deflation for pencils
# ---------------------------------------------------------------------------

def _aed_deflate_gep(Sw, Tw, Qw, Zw, s: float, w: int, thresh: float):
    """Bottom-up spike deflation with generalized block moves: the plain
    twin of kernel G4.

    (Sw, Tw) is the generalized Schur form of the AED window (active
    w x w), (Qw, Zw) the window's left and right transforms; the spike is
    s * Qw[0, :].  Blocks whose spike entries are negligible deflate; the
    others move to the top by adjacent swaps (a rejected swap ends the
    scan).  Returns (Sw, Tw, Qw, Zw, kbot, fail, steps), the last three
    0-d int32 tensors.
    """
    WA = Sw.shape[0]
    WP = WA + 4
    Sp = Sw.new_zeros((WP, WP))
    Sp[:WA, :WA] = Sw
    Tp = Sw.new_zeros((WP, WP))
    Tp[:WA, :WA] = Tw
    Qp = Sw.new_zeros((WA, WP))
    Qp[:, :WA] = Qw
    Zp = Sw.new_zeros((WA, WP))
    Zp[:, :WA] = Zw

    def size_end(e):
        return 2 if e >= 1 and float(Sp[e, e - 1]) != 0.0 else 1

    def size_start(st):
        return 2 if st + 1 < WA and float(Sp[st + 1, st]) != 0.0 else 1

    kbot, ilst, src, fail, steps = w, 0, -1, False, 0
    while kbot > ilst and not fail and steps < 4 * WA * WA:
        if src < 0:
            sz = size_end(kbot - 1)
            start = kbot - sz
            sp0 = s * float(Qp[0, max(start, 0)])
            sp1 = s * float(Qp[0, max(kbot - 1, 0)])
            foot = max(abs(sp0), abs(sp1) * (1.0 if sz == 2 else 0.0))
            tst = abs(float(Sp[start, start])) + (
                abs(float(Sp[kbot - 1, kbot - 1])) if sz == 2 else 0.0)
            if foot <= max(ULP * tst, thresh):
                kbot, src = start, -1
            elif start == ilst:
                ilst, src = ilst + sz, -1
            else:
                src = start
        else:
            p = size_end(src - 1)
            a = src - p
            q = size_start(src)
            Qs, Zs, Ah, Bh, accept = swap_adjacent_gep(
                Sp[a:a + 4, a:a + 4].clone(), Tp[a:a + 4, a:a + 4].clone(), p, q)
            if accept:
                for M in (Sp, Tp):
                    M[a:a + 4] = Qs.T @ M[a:a + 4]
                    M[:, a:a + 4] = M[:, a:a + 4] @ Zs
                Sp[a:a + 4, a:a + 4] = Ah
                Tp[a:a + 4, a:a + 4] = Bh
                Qp[:, a:a + 4] = Qp[:, a:a + 4] @ Qs
                Zp[:, a:a + 4] = Zp[:, a:a + 4] @ Zs
                src = a
                if src == ilst:
                    ilst, src = ilst + q, -1
            else:
                src, fail = -1, True
        steps += 1
    i32 = dict(dtype=torch.int32, device=Sw.device)
    return (Sp[:WA, :WA].contiguous(), Tp[:WA, :WA].contiguous(),
            Qp[:, :WA].contiguous(), Zp[:, :WA].contiguous(),
            torch.tensor(kbot, **i32), torch.tensor(int(fail), **i32),
            torch.tensor(steps, **i32))


def aed_deflate_gep(Sw, Tw, Qw, Zw, s: float, w: int, thresh: float):
    """Spike deflation: kernel G4 for a CUDA tensor, :func:`_aed_deflate_gep`
    for a CPU tensor.  Returns (Sw, Tw, Qw, Zw, kbot, fail, steps)."""
    if Sw.is_cuda:
        return gpu_gep.aed_deflate_gep(Sw, Tw, Qw, Zw, s, w, thresh)
    return _aed_deflate_gep(Sw, Tw, Qw, Zw, s, w, thresh)


# ---------------------------------------------------------------------------
# recondense: spike condense + in-window HT re-reduction
# ---------------------------------------------------------------------------

def _aed_recondense_gep(Sw, Tw, Qw, Zw, s: float, kbot: int):
    """Return the undeflated window part to Hessenberg-triangular form with
    the spike condensed into beta e1: the plain twin of kernel G1's window
    mode.

    The spike s * Qw[0, :kbot] is chased bottom-up by the cascade's
    rotation pairs (left rotations zero its entries, right rotations zero
    the T fill: the cascade's column -1), then the cascade re-reduces the
    leading kbot block; T's lower triangle inside it is zeroed at the end.
    Returns (Sw, Tw, Qw, Zw, beta).
    """
    S, T, Q, Z = (M.clone() for M in (Sw, Tw, Qw, Zw))
    WA = S.shape[0]
    sp = torch.where(torch.arange(WA, device=S.device) < kbot, s * Q[0], 0.0)
    for i in range(kbot - 1, 0, -1):
        c, s_, r = prim.givens(sp[i - 1], sp[i])
        cascade_step(S, T, Q, Z, i, c, s_)
        sp[i - 1] = r
        sp[i] = 0.0
    beta = sp[0].clone()
    for j in range(kbot - 2):
        for i in range(kbot - 1, j + 1, -1):
            c, s_, _ = prim.givens(S[i - 1, j], S[i, j])
            cascade_step(S, T, Q, Z, i, c, s_)
            S[i, j] = 0.0
    T[:kbot, :kbot] = torch.triu(T[:kbot, :kbot])
    return S, T, Q, Z, beta


def aed_recondense_gep(Sw, Tw, Qw, Zw, s: float, kbot: int):
    """Recondense: kernel G1 (window mode) for a CUDA tensor,
    :func:`_aed_recondense_gep` for a CPU tensor.  Returns
    (Sw, Tw, Qw, Zw, beta)."""
    if Sw.is_cuda:
        return gpu_gep.ht_recondense(Sw, Tw, Qw, Zw, s, kbot)
    return _aed_recondense_gep(Sw, Tw, Qw, Zw, s, kbot)


# ---------------------------------------------------------------------------
# window transforms on the padded pencil
# ---------------------------------------------------------------------------

def _apply_window_gep(Spad, Tpad, Qpad, Zpad, Qw, Zw, Sw, Tw, m: int,
                      gp: int, spike: bool, beta):
    """Apply the window transforms (Qw, Zw) at padded offset gp to full
    rows and columns, plant the window's active m x m block and, for an
    AED window, the condensed spike column; in place."""
    W = Qw.shape[0]
    for M in (Spad, Tpad):
        M[gp:gp + W] = Qw.T @ M[gp:gp + W]
        M[:, gp:gp + W] = M[:, gp:gp + W] @ Zw
    Spad[gp:gp + m, gp:gp + m] = Sw[:m, :m]
    Tpad[gp:gp + m, gp:gp + m] = Tw[:m, :m]
    if spike:
        Spad[gp:gp + W, gp - 1] = 0.0
        Spad[gp, gp - 1] = beta
    Qpad[:, gp:gp + W] = Qpad[:, gp:gp + W] @ Qw
    Zpad[:, gp:gp + W] = Zpad[:, gp:gp + W] @ Zw


def _masked_window_pair(Spad, Tpad, gp: int, m: int, W: int):
    """(W, W) copies of the pencil's window at padded offset gp, zero
    outside the active m x m block."""
    Sw = Spad.new_zeros((W, W))
    Tw = Spad.new_zeros((W, W))
    Sw[:m, :m] = Spad[gp:gp + m, gp:gp + m]
    Tw[:m, :m] = Tpad[gp:gp + m, gp:gp + m]
    return Sw, Tw


# ---------------------------------------------------------------------------
# windowed infinite-eigenvalue push
# ---------------------------------------------------------------------------

def _inf_chase_kernel(Hw, Tw, jrel: int, mrel: int, lrel: int):
    """Move the T-diagonal zero at window-relative jrel down to mrel-1: the
    plain twin of kernel G5.

    Per step i: a left rotation from T's pair (T[i, i+1], T[i+1, i+1])
    zeroes T[i+1, i+1], and a right reflection from the H fill pair
    (H[i+1, i-1], H[i+1, i]) restores H's Hessenberg form (skipped at step
    lrel, the decoupled segment top).  Returns (Hw, Tw, Qw, Zw) with the
    accumulated window transforms.
    """
    Wb = Hw.shape[0]
    H, T = Hw.clone(), Tw.clone()
    Qw = torch.eye(Wb, dtype=H.dtype, device=H.device)
    Zw = torch.eye(Wb, dtype=H.dtype, device=H.device)
    T[jrel, jrel] = 0.0
    for i in range(max(jrel, 0), mrel - 1):
        i1 = i + 1
        c, s, r = prim.givens(T[i, i1], T[i1, i1])
        rot_rows(H, i1, c, s)
        rot_rows(T, i1, c, s)
        rot_cols(Qw, i1, c, s)
        T[i, i1] = r
        T[i1, i1] = 0.0
        T[i1, i] = 0.0
        if i == lrel:
            continue
        im1 = max(i - 1, 0)
        cr, sr, rr = prim.givens(H[i1, im1], H[i1, i])
        for X in (H, T, Zw):
            a, b = X[:, im1].clone(), X[:, i].clone()
            X[:, im1] = -sr * a + cr * b
            X[:, i] = cr * a + sr * b
        H[i1, i] = rr
        H[i1, im1] = 0.0
    return H, T, Qw, Zw


def inf_chase(Hw, Tw, jrel: int, mrel: int, lrel: int):
    """The window chase of the infinite push: kernel G5 for a CUDA tensor,
    :func:`_inf_chase_kernel` for a CPU tensor.  Returns (Hw, Tw, Qw, Zw)."""
    if Hw.is_cuda:
        return gpu_gep.inf_chase(Hw, Tw, jrel, mrel, lrel)
    return _inf_chase_kernel(Hw, Tw, jrel, mrel, lrel)


def _deflate_inf_bottom(Spad, Tpad, Zpad, i: int):
    """Right rotation deflating the infinite eigenvalue at padded row i (the
    segment bottom): zeroes S[i, i-1] and plants T[i, i] = 0; in place."""
    c, s, _ = prim.givens(Spad[i, i], Spad[i, i - 1])
    rot_cols(Spad, i, c, -s)
    Spad[i, i - 1] = 0.0
    rot_cols(Tpad, i, c, -s)
    Tpad[i, i - 1] = 0.0
    Tpad[i, i] = 0.0
    rot_cols(Zpad, i, c, -s)


# ---------------------------------------------------------------------------
# B-bulge QZ trains, chased in (6B+4)-row windows
# ---------------------------------------------------------------------------

def _qz_train_hop(Sw, Tw, sh, l_rel: int, ihi_rel: int, s0: int, B: int,
                  HOP: int):
    """HOP steps of one B-bulge QZ train inside its (WC, WC) window pair:
    the plain twin of kernel G3.

    Bulge b acts at k = l_rel + s - 3b for step s in [s0, s0 + HOP), if
    l_rel <= k <= ihi_rel - 2: a left 3-reflector on rows k..k+2 (from the
    first column of the shifted product at its introduction, k = l_rel,
    else from the bulge column k-1), then a right 3-reflector from T's row
    k+2 and a right rotation zeroing T[k+1, k], all at window width, with
    the window transforms accumulated.  Returns (Sw2, Tw2, Qw, Zw).
    """
    S, T = Sw.clone(), Tw.clone()
    WC = S.shape[0]
    dev = S.device
    Qw = torch.eye(WC, dtype=S.dtype, device=dev)
    Zw = torch.eye(WC, dtype=S.dtype, device=dev)
    m3 = torch.ones(3, dtype=torch.bool, device=dev)
    for t in range(HOP):
        s = s0 + t
        act = [b for b in range(B) if l_rel <= l_rel + s - 3 * b <= ihi_rel - 2]
        if not act:
            continue
        ks = [l_rel + s - 3 * b for b in act]
        use3 = torch.tensor([k <= ihi_rel - 3 for k in ks], device=dev)
        intro = [k == l_rel for k in ks]
        x = torch.stack([S[k:k + 3, k - 1] if not it else S.new_zeros(3)
                         for k, it in zip(ks, intro)])
        if any(intro):
            sa = sh[act]
            ic = _first_col_qz(S, T, l_rel, sa[:, 0], sa[:, 1], sa[:, 2], sa[:, 3],
                               use3, plus_floor=True)
            x = torch.where(torch.tensor(intro, device=dev)[:, None], ic, x)
        on = torch.ones_like(use3)
        v, tau, beta = prim.householder(x, torch.stack([on, on, use3], 1))
        for g, k in enumerate(ks):
            for M in (S, T):
                rows = M[k:k + 3]
                rows -= tau[g] * torch.outer(v[g], v[g] @ rows)
            qc = Qw[:, k:k + 3]
            qc -= tau[g] * torch.outer(qc @ v[g], v[g])
        for g, k in enumerate(ks):
            if not intro[g]:
                S[k, k - 1] = beta[g]
                S[k + 1, k - 1] = 0.0
                if bool(use3[g]):
                    S[k + 2, k - 1] = 0.0
        for g, k in enumerate(ks):
            if not bool(use3[g]):
                continue
            vr, tau_r, _ = prim.householder(T[k + 2, k:k + 3].flip(0), m3)
            vr = vr.flip(0)
            for M in (S, T, Zw):
                cols = M[:, k:k + 3]
                cols -= tau_r * torch.outer(cols @ vr, vr)
            T[k + 2, k] = 0.0
            T[k + 2, k + 1] = 0.0
        for k in ks:
            c2, s2, _ = prim.givens(T[k + 1, k + 1], T[k + 1, k])
            for M in (S, T, Zw):
                rot_cols(M, k + 1, c2, -s2)
            T[k + 1, k] = 0.0
    return S, T, Qw, Zw


def qz_train_hop(Sw, Tw, sh, l_rel: int, ihi_rel: int, s0: int, B: int,
                 HOP: int):
    """One hop of a QZ train: kernel G3 for a CUDA tensor,
    :func:`_qz_train_hop` for a CPU tensor.  Returns (Sw2, Tw2, Qw, Zw)."""
    if Sw.is_cuda:
        return gpu_gep.qz_sweep(Sw, Tw, sh, l_rel, ihi_rel, s0, B, HOP)
    return _qz_train_hop(Sw, Tw, sh, l_rel, ihi_rel, s0, B, HOP)


def _qz_sweep(Spad, Tpad, Qpad, Zpad, l: int, ihi: int, sh, B: int):
    """Chase one B-bulge train across the padded segment [l, ihi), in place:
    hops of 3B steps, each in the (6B+4)-row window that holds every bulge
    of the hop; the kernel (or its twin) runs the hop at window width and
    the off-window strips and Q, Z take the window transforms by GEMMs.
    The same steps as the JAX package's full-width ``_qz_sweep_batch``."""
    WC, HOP = 6 * B + 4, 3 * B
    steps = (ihi - l) - 2 + 3 * (B - 1) + 1
    for s0 in range(0, steps, HOP):
        ws = l + s0 - 3 * (B - 1) - 1
        we = ws + WC
        Sw2, Tw2, Qw, Zw = qz_train_hop(
            Spad[ws:we, ws:we].contiguous(), Tpad[ws:we, ws:we].contiguous(),
            sh, l - ws, ihi - ws, s0, B, HOP)
        for M, M2 in ((Spad, Sw2), (Tpad, Tw2)):
            M[ws:we, we:] = Qw.T @ M[ws:we, we:]
            M[:ws, ws:we] = M[:ws, ws:we] @ Zw
            M[ws:we, ws:we] = M2
        Qpad[:, ws:we] = Qpad[:, ws:we] @ Qw
        Zpad[:, ws:we] = Zpad[:, ws:we] @ Zw


# ---------------------------------------------------------------------------
# final standardization
# ---------------------------------------------------------------------------

def standardize_blocks_gep(S, T, Q, Z):
    """Standardize every 2x2 S-block of a generalized Schur form at once
    (dlagv2 for each; real pairs split exactly).  Returns new (S, T, Q, Z)."""
    n = S.shape[0]
    z1 = S.new_zeros(1)
    f1 = torch.zeros(1, dtype=torch.bool, device=S.device)
    sub = torch.cat([torch.diagonal(S, -1), z1])
    is_start = sub != 0
    prev = torch.cat([f1, is_start[:-1]])
    is_start = is_start & ~prev
    is_second = torch.cat([f1, is_start[:-1]])

    def blk(M):
        nx = torch.cat([torch.diagonal(M)[1:], torch.diagonal(M)[-1:]])
        up = torch.cat([torch.diagonal(M, 1), torch.diagonal(M)[-1:]])
        lo = torch.cat([torch.diagonal(M, -1), torch.diagonal(M)[-1:]])
        return torch.diagonal(M), up, lo, nx

    a00, a01, a10, a11, b00, b01, _b10, b11, cl, sl, cr, sr = std_gep_2x2(
        *blk(S), *blk(T))
    cl = torch.where(is_start, cl, 1.0)
    sl = torch.where(is_start, sl, 0.0)
    cr = torch.where(is_start, cr, 1.0)
    sr = torch.where(is_start, sr, 0.0)
    cl_r, sl_r, cr_r, sr_r = (torch.roll(x, 1) for x in (cl, sl, cr, sr))
    st, sc = is_start[:, None], is_second[:, None]

    def lrot_all(M):
        Md, Mu = torch.roll(M, -1, 0), torch.roll(M, 1, 0)
        return torch.where(st, cl[:, None] * M + sl[:, None] * Md,
                           torch.where(sc, -sl_r[:, None] * Mu + cl_r[:, None] * M, M))

    def rrot_all(M, c, s, c_r, s_r):
        Md, Mu = torch.roll(M, -1, 1), torch.roll(M, 1, 1)
        return torch.where(st.T, c * M + s * Md,
                           torch.where(sc.T, -s_r * Mu + c_r * M, M))

    S1 = rrot_all(lrot_all(S), cr, sr, cr_r, sr_r)
    T1 = rrot_all(lrot_all(T), cr, sr, cr_r, sr_r)
    Q1 = rrot_all(Q, cl, sl, cl_r, sl_r)
    Z1 = rrot_all(Z, cr, sr, cr_r, sr_r)

    r = torch.arange(n, device=S.device)
    S1[r, r] = torch.where(is_start, a00, torch.where(
        is_second, torch.roll(a11, 1), torch.diagonal(S1)))
    S1[r[:-1], r[1:]] = torch.where(is_start[:-1], a01[:-1], torch.diagonal(S1, 1))
    S1[r[1:], r[:-1]] = torch.where(is_start[:-1], a10[:-1], torch.diagonal(S1, -1))
    T1[r, r] = torch.where(is_start, b00, torch.where(
        is_second, torch.roll(b11, 1), torch.diagonal(T1)))
    T1[r[:-1], r[1:]] = torch.where(is_start[:-1], b01[:-1], torch.diagonal(T1, 1))
    T1[r[1:], r[:-1]] = torch.where(is_start[:-1], 0.0, torch.diagonal(T1, -1))
    return S1, T1, Q1, Z1


# ---------------------------------------------------------------------------
# rounds and the driver
# ---------------------------------------------------------------------------

class _Geometry:
    """The driver's geometry from the resolved configuration, as the JAX
    ``qz_schur`` derives it; the padding P also holds a train's whole
    (6B+4)-row window at either end."""

    def __init__(self, n: int, conf: SchurConf):
        self.B = min(12, max(1, n // 8))
        self.WC = 6 * self.B + 4
        small_w = min(max(64, conf.small_limit), n)
        self.WA = min(max(32, conf.aed_window_size + 2), n)
        self.P = max(3 * self.B + 4, small_w, self.WA, self.WC) + 2
        self.NP = n + 2 * self.P
        self.NS = max(2, min(conf.aed_shift_count // 2 * 2, 2 * (self.WA // 2)))
        self.TMAX = max(1, (self.NS // 2 + self.B - 1) // self.B)
        self.INFW = min(96, self.WA)
        self.nibble = conf.aed_nibble
        self.itmax = conf.iteration_limit


def _qz_round(Spad, Tpad, Qpad, Zpad, n: int, ihi: int, thresh: float,
              thresh_t: float, eyeW, g: _Geometry, stats: dict):
    """One QZ round, in place: deflation scan and peel, then EITHER the
    windowed push of the bottom-most infinite eigenvalue of the segment OR
    an AED round.  Returns (shifts (TMAX, B, 4), status) with status the
    host ints (new_ihi, l, ntr, sfail, nd, npairs, w, do_inf)."""
    P, WA, B, TMAX = g.P, g.WA, g.B, g.TMAX
    dev, dtype = Spad.device, Spad.dtype
    zshifts = Spad.new_zeros((TMAX, B, 4))

    # -- negligible-subdiagonal zeroing, T's diagonal (read 1) --
    sub_t = DenseExtent.zero_negligible(Spad, P, n, ihi, thresh)
    tdiag_t = torch.diagonal(Tpad[P:P + n, P:P + n]).abs()
    sub, tdiag = torch.stack([sub_t, tdiag_t]).cpu().numpy()
    while ihi > 0:
        if ihi == 1 or sub[max(ihi - 2, 0)] == 0.0:
            ihi -= 1
        elif ihi == 2 or sub[max(ihi - 3, 0)] == 0.0:
            ihi -= 2
        else:
            break
    if ihi <= 0:
        return zshifts, (ihi, 0, 0, False, 0, 0, 0, False)
    zb = np.nonzero(sub[:ihi - 1] == 0.0)[0]
    l = int(zb[-1]) + 1 if len(zb) else 0

    inf = np.nonzero(tdiag[l:ihi] <= thresh_t)[0]
    if len(inf):
        # push the bottom-most T-diagonal zero down to ihi - 1 in INFW
        # windows, then deflate the infinite eigenvalue
        p = l + int(inf[-1])
        while p < ihi - 1:
            a0 = max(p - 1, l)
            m = min(g.INFW, ihi - a0)
            Hw, Tw = _masked_window_pair(Spad, Tpad, P + a0, m, g.INFW)
            lrel = p - a0 if p == l else -1
            Hw, Tw, Qw, Zw = inf_chase(Hw, Tw, p - a0, m, lrel)
            _apply_window_gep(Spad, Tpad, Qpad, Zpad, Qw, Zw, Hw, Tw, m,
                              P + a0, False, None)
            stats["inf_chase_calls"] += 1
            p = a0 + m - 1
        _deflate_inf_bottom(Spad, Tpad, Zpad, P + ihi - 1)
        return zshifts, (ihi - 1, l, 0, False, 1, 0, 0, True)

    seg = ihi - l
    w = min(WA, seg)
    kwtop = ihi - w
    gk = P + kwtop
    Sw, Tw = _masked_window_pair(Spad, Tpad, gk, w, WA)
    if w < WA:
        r = torch.arange(w, WA, device=dev)
        Tw[r, r] = 1.0
    s_spike = float(sub[kwtop - 1]) if kwtop >= 1 else 0.0

    Sw, Tw, Qw, Zw, sinfo = small_qz(Sw, Tw, eyeW, eyeW, w, thresh, thresh_t)
    Sw, Tw, Qw, Zw, kbot_t, _dfail, _steps = aed_deflate_gep(
        Sw, Tw, Qw, Zw, s_spike, w, thresh)
    ar_w, ai_w, bt_w = extract_eigenvalues_gen(Sw, Tw)
    safe_bt = torch.where(bt_w.abs() < 1e-12,
                          torch.where(bt_w < 0, -1e-12, 1e-12), bt_w)

    # -- the round's status read (read 2) --
    head = torch.stack([sinfo, kbot_t]).to(dtype)
    status = torch.cat([head, ar_w / safe_bt, ai_w / safe_bt,
                        torch.diagonal(Sw, -1)]).cpu().numpy()
    sfail = bool(status[0] != 0)
    kbot = int(status[1])
    er, ei, tsub = np.split(status[2:], [WA, 2 * WA])
    nd = w - kbot
    shifts_h, npairs = _pack_shifts(er, ei, tsub, kbot, g.NS, B, TMAX)
    shifts = torch.from_numpy(shifts_h).to(dev)

    Sw, Tw, Qw, Zw, beta = aed_recondense_gep(Sw, Tw, Qw, Zw, s_spike, kbot)
    stats["recondense_calls"] += 1
    if kbot == 0:
        beta = Spad.new_zeros(())
    _apply_window_gep(Spad, Tpad, Qpad, Zpad, Qw, Zw, Sw, Tw, w, gk, True, beta)
    new_ihi = ihi - nd

    if npairs == 0:
        # exceptional fallback when the window gave no usable pair
        r0 = P + new_ihi - 1
        c0 = P + max(new_ihi - 1, 0)
        d0, t0 = Spad[r0, c0], Tpad[r0, c0]
        big = t0.abs() > 1e-12
        lam = torch.where(big, d0 / torch.where(big, t0, 1.0), d0)
        shifts = torch.stack([lam * 1.01, 0 * lam, lam * 0.99, 0 * lam]
                             ).expand(TMAX, B, 4)
        npairs = 1

    skip_sweep = ((nd > 0 and 100 * nd >= g.nibble * max(w, 1))
                  or new_ihi - l <= 2 or sfail)
    ntr = 0 if skip_sweep else (npairs + B - 1) // B
    return shifts, (new_ihi, l, ntr, sfail, nd, npairs, w, False)


def _qz_iter(Spad, Tpad, Qpad, Zpad, n: int, thresh: float, thresh_t: float,
             g: _Geometry, stats: dict):
    """The multishift-QZ iteration: a host loop over rounds, each AED round
    followed by its trains, one after another.  Returns (ihi, fail)."""
    eyeW = torch.eye(g.WA, dtype=Spad.dtype, device=Spad.device)
    ihi, it_seg, last_ihi, fail, rounds = n, 0, n, 0, 0
    log = stats["qz_log"]
    while ihi > 0 and fail == 0 and rounds < 2 * n + 10:
        shifts, (new_ihi, l, ntr, _sf, nd, _np, w, do_inf) = _qz_round(
            Spad, Tpad, Qpad, Zpad, n, ihi, thresh, thresh_t, eyeW, g, stats)
        log.append((w, w - nd, ntr, do_inf))
        it_seg = (0 if new_ihi != last_ihi else it_seg) + 1
        # a non-converged AED window is not fatal (dlaqr3 semantics); only
        # the per-segment iteration limit fails
        fail = int(it_seg > g.itmax)
        if ntr > 0 and fail == 0:
            for t in range(ntr):
                _qz_sweep(Spad, Tpad, Qpad, Zpad, g.P + l, g.P + new_ihi,
                          shifts[min(t, g.TMAX - 1)], g.B)
        if fail == 0:
            ihi = new_ihi
        last_ihi = new_ihi
        rounds += 1
    stats["rounds"] = rounds
    return ihi, fail


def qz_schur(H, T, Q=None, Z=None, conf: Optional[SchurConf] = None,
             stats: Optional[dict] = None):
    """Hessenberg-triangular pencil -> generalized real Schur form by
    multishift QZ with AED, on H's device.

    Q and Z (if given) accumulate on the right.  If ``stats`` is a dict it
    receives the geometry, the round count, ``qz_log`` (the (w, kbot, ntr,
    do_inf) of each round), the recondense calls (G1's window mode), the
    windowed infinite-push calls and the rounds that took that push.

    Returns (S, T, Q, Z, alpha_r, alpha_i, beta, info), info Error.SUCCESS
    or Error.DID_NOT_CONVERGE.
    """
    n = H.shape[0]
    dtype, dev = H.dtype, H.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    Q = eye if Q is None else Q
    Z = eye if Z is None else Z
    conf = (conf or SchurConf()).resolve(n)
    g = _Geometry(n, conf)
    P, NP = g.P, g.NP

    Spad = H.new_zeros((NP, NP))
    Spad[P:P + n, P:P + n] = H
    Tpad = H.new_zeros((NP, NP))
    Tpad[P:P + n, P:P + n] = T
    Qpad = H.new_zeros((n, NP))
    Qpad[:, P:P + n] = Q
    Zpad = H.new_zeros((n, NP))
    Zpad[:, P:P + n] = Z

    tiny = float(np.finfo(np.float64).tiny)
    u = ULP / 2
    thresh = max(u * float(torch.linalg.norm(H)), tiny)
    thresh_t = max(u * float(torch.linalg.norm(T)), tiny)

    st = dict(qz_log=[], recondense_calls=0, inf_chase_calls=0)
    ihi, fail = _qz_iter(Spad, Tpad, Qpad, Zpad, n, thresh, thresh_t, g, st)
    info = Error.DID_NOT_CONVERGE if (fail or ihi > 0) else Error.SUCCESS

    S, Tt, Qf, Zf = standardize_blocks_gep(
        Spad[P:P + n, P:P + n], Tpad[P:P + n, P:P + n], Qpad[:, P:P + n],
        Zpad[:, P:P + n])
    ar, ai, bt = extract_eigenvalues_gen(S, Tt)
    if stats is not None:
        stats.update(path="aed", WA=g.WA, NS=g.NS, B=g.B, WC=g.WC,
                     TMAX=g.TMAX, P=P, NP=NP, INFW=g.INFW, **st,
                     inf_rounds=sum(r[3] for r in st["qz_log"]))
    return S, Tt, Qf, Zf, ar, ai, bt, info
