"""Multishift QR Schur reduction with aggressive early deflation (SEP).

Port of ``starneig_tpu/ops/schur.py``.  The mathematics is the JAX
package's: AED rounds (deflation scan, window Schur solve, spike
deflation with block moves, shift extraction, recondense, window-transform
GEMMs) alternating with wavefront sweeps of staggered B-bulge trains, on a
(P + n + P)-padded buffer with the same geometry (``SchurConf().resolve``,
no TPU tiers or caps).

What changes is the control: the JAX package ran the whole iteration as
one device program; here it is a host loop over rounds.  Integers that
decide shapes and offsets (ihi, l, the window size, kbot, the train count)
live on the host, so every slice is a plain tensor index.  Each round reads
the device twice: the subdiagonal after the negligible-entry scan (to place
the window) and one status vector after the window solve and deflation
(info, kbot, the window eigenvalues).  Nothing syncs per step: the window
solve, the deflation, the recondense and the train hops are one kernel
launch each on CUDA (B2, B4, B5, B3 in :mod:`starneig_tpu_torch.ops.gpu_schur`;
the dispatchers :func:`aed_deflate`, :func:`aed_recondense` and
:func:`train_hops` run the plain twins for CPU tensors), and the hop count
of a sweep is computed on the host from the status.

Where the JAX version relied on ``lax.dynamic_slice`` clamping an
out-of-range start (and on scatters dropping or wrapping out-of-range
writes), the port clamps explicitly (:func:`_clamp`) and writes the chase
plants only where they change a value.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.config import SchurConf, DeflationCriterion
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import gpu_schur
from starneig_tpu_torch.ops import primitives as prim
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
from starneig_tpu_torch.ops.small_schur import small_schur
from starneig_tpu_torch.ops.swaps import swap_adjacent


def _clamp(x: int, lo: int, hi: int) -> int:
    """Clamp a slice start into [lo, hi], as lax.dynamic_slice does."""
    return max(lo, min(x, hi))


class DenseExtent:
    """Full-extent operations on the padded (NP, *) buffers, in place.

    Offsets are host ints; every operation is tensor indexing plus, for
    the window transforms, ``torch.matmul`` (the large GEMMs that the JAX
    package left to XLA).
    """

    @staticmethod
    def mul_rows(S, i0: int, h: int, Qw):
        """S[i0:i0+h, :] = Qw^T S[i0:i0+h, :]."""
        S[i0:i0 + h] = Qw.T @ S[i0:i0 + h]

    @staticmethod
    def mul_cols(S, j0: int, w: int, Qw):
        """S[:, j0:j0+w] = S[:, j0:j0+w] Qw."""
        S[:, j0:j0 + w] = S[:, j0:j0 + w] @ Qw

    @staticmethod
    def get_block(S, i0: int, j0: int, h: int, w: int):
        """A copy of S[i0:i0+h, j0:j0+w]."""
        return S[i0:i0 + h, j0:j0 + w].clone()

    @staticmethod
    def set_block(S, M, i0: int, j0: int):
        """S[i0:i0+h, j0:j0+w] = M for M of shape (h, w)."""
        S[i0:i0 + M.shape[0], j0:j0 + M.shape[1]] = M

    @staticmethod
    def get_diag_blocks(S, ws, w: int):
        """Window starts -> (G, w, w) copies of the diagonal blocks."""
        return torch.stack([S[s:s + w, s:s + w] for s in ws])

    @staticmethod
    def set_diag_blocks(S, Ms, ws):
        for g, s in enumerate(ws):
            S[s:s + Ms.shape[1], s:s + Ms.shape[1]] = Ms[g]

    @staticmethod
    def mul_rows_batch(S, ws, w: int, Qws):
        """S[ws_g:ws_g+w, :] = Qws[g]^T rows for disjoint windows."""
        for g, s in enumerate(ws):
            S[s:s + w] = Qws[g].T @ S[s:s + w]

    @staticmethod
    def mul_cols_batch(S, ws, w: int, Qws):
        """S[:, ws_g:ws_g+w] = cols Qws[g] for disjoint windows."""
        for g, s in enumerate(ws):
            S[:, s:s + w] = S[:, s:s + w] @ Qws[g]

    @staticmethod
    def zero_negligible(Spad, P: int, n: int, ihi: int, thresh: float):
        """Zero negligible subdiagonals above row ihi (inner coordinates).

        Returns the (n,) updated subdiagonal (last entry 0).
        """
        S = Spad[P:P + n, P:P + n]
        sub = torch.diagonal(S, -1)
        newsub = negligible_zeroed(torch.diagonal(S), sub, ihi, thresh)
        sub.copy_(newsub)
        return torch.cat([newsub, newsub.new_zeros(1)])

    @staticmethod
    def window(fn, *inputs):
        """The window math of a round or a hop: ``fn(*inputs)``.  A
        distributed extent runs it on one rank and hands its outputs to the
        others (``parallel/dm_core.py``)."""
        return fn(*inputs)


def negligible_zeroed(d, sub, ihi: int, thresh: float):
    """The subdiagonal ``sub`` of a matrix with diagonal ``d`` with its
    negligible entries above row ihi set to zero (a new tensor)."""
    ulp = torch.finfo(sub.dtype).eps
    tst = d[:-1].abs() + d[1:].abs()
    idx = torch.arange(sub.shape[0], device=sub.device)
    neg = (sub.abs() <= torch.clamp_min(ulp * tst, thresh)) & (idx + 1 < ihi)
    return torch.where(neg, 0.0, sub)


def standardize_blocks(S, Q):
    """Standardize every 2x2 diagonal block of a quasi-triangular S.

    All blocks are disjoint, so their rotations apply at once through
    shifted-row/column arithmetic.  Returns new (S, Q).
    """
    n = S.shape[0]
    z1 = S.new_zeros(1)
    f1 = torch.zeros(1, dtype=torch.bool, device=S.device)
    d = torch.diagonal(S)
    sub = torch.cat([torch.diagonal(S, -1), z1])
    sup = torch.cat([torch.diagonal(S, 1), z1])
    is_start = sub != 0
    prev = torch.cat([f1, is_start[:-1]])
    is_start = is_start & ~prev
    is_second = torch.cat([f1, is_start[:-1]])

    d_next = torch.cat([d[1:], z1])
    aa, bb, cc, dd, _r1, _i1, _r2, _i2, cs, sn = prim.standardize_2x2(
        d, sup, sub, d_next)
    cs = torch.where(is_start, cs, 1.0)
    sn = torch.where(is_start, sn, 0.0)
    cs_r = torch.roll(cs, 1)
    sn_r = torch.roll(sn, 1)
    st, sc = is_start[:, None], is_second[:, None]

    S_dn = torch.roll(S, -1, 0)
    S_up = torch.roll(S, 1, 0)
    S1 = torch.where(st, cs[:, None] * S + sn[:, None] * S_dn,
                     torch.where(sc, -sn_r[:, None] * S_up + cs_r[:, None] * S, S))
    C_dn = torch.roll(S1, -1, 1)
    C_up = torch.roll(S1, 1, 1)
    S2 = torch.where(st.T, cs * S1 + sn * C_dn,
                     torch.where(sc.T, -sn_r * C_up + cs_r * S1, S1))
    r = torch.arange(n, device=S.device)
    diag_new = torch.where(is_start, aa,
                           torch.where(is_second, torch.roll(dd, 1),
                                       torch.diagonal(S2)))
    S2[r, r] = diag_new
    sup_new = torch.where(is_start[:-1], bb[:-1], torch.diagonal(S2, 1))
    S2[r[:-1], r[1:]] = sup_new
    sub_new = torch.where(is_start[:-1], cc[:-1], torch.diagonal(S2, -1))
    S2[r[1:], r[:-1]] = sub_new

    Qd = torch.roll(Q, -1, 1)
    Qu = torch.roll(Q, 1, 1)
    Q2 = torch.where(st.T, cs * Q + sn * Qd,
                     torch.where(sc.T, -sn_r * Qu + cs_r * Q, Q))
    return S2, Q2


# ---------------------------------------------------------------------------
# AED helpers
# ---------------------------------------------------------------------------

def _aed_deflate(Tw, Vw, s: float, w: int, thresh: float):
    """Bottom-up spike deflation with block moves: the plain twin of B4.

    Tw is a (WA, WA) Schur form of the AED window (active w x w), Vw the
    window transform; the spike is s * Vw[0, :].  Blocks whose spike
    entries are negligible deflate (stay at the bottom); the others move to
    the top by adjacent swaps.  Returns (Tw, Vw, kbot, fail), kbot the rows
    left undeflated (0-d int32 tensors for kbot and fail).
    """
    WA = Tw.shape[0]
    WP = WA + 4
    ulp = torch.finfo(Tw.dtype).eps
    Tp = Tw.new_zeros((WP, WP))
    Tp[:WA, :WA] = Tw
    Vp = Tw.new_zeros((WA, WP))
    Vp[:, :WA] = Vw

    def size_ending_at(e):
        return 2 if e >= 1 and float(Tp[e, e - 1]) != 0.0 else 1

    def size_starting_at(st):
        return 2 if st + 1 < WA and float(Tp[st + 1, st]) != 0.0 else 1

    kbot, ilst, src, fail, steps = w, 0, -1, False, 0
    while kbot > ilst and not fail and steps < 4 * WA * WA:
        if src < 0:
            sz = size_ending_at(kbot - 1)
            start = kbot - sz
            sp0 = s * float(Vp[0, max(start, 0)])
            sp1 = s * float(Vp[0, max(kbot - 1, 0)])
            foot = max(abs(sp0), abs(sp1) * (1.0 if sz == 2 else 0.0))
            tst = abs(float(Tp[start, start])) + (
                abs(float(Tp[kbot - 1, kbot - 1])) if sz == 2 else 0.0)
            if foot <= max(ulp * tst, thresh):
                kbot, src = start, -1
            elif start == ilst:
                ilst, src = ilst + sz, -1
            else:
                src = start
        else:
            p = size_ending_at(src - 1)
            a = src - p
            q = size_starting_at(src)
            Qs, Dh, accept = swap_adjacent(Tp[a:a + 4, a:a + 4].clone(), p, q)
            Tp[a:a + 4] = Qs.T @ Tp[a:a + 4]
            Tp[:, a:a + 4] = Tp[:, a:a + 4] @ Qs
            Tp[a:a + 4, a:a + 4] = Dh
            Vp[:, a:a + 4] = Vp[:, a:a + 4] @ Qs
            if accept:
                src = a
                if src == ilst:
                    ilst, src = ilst + q, -1
            else:
                src, fail = -1, True
        steps += 1
    i32 = dict(dtype=torch.int32, device=Tw.device)
    return (Tp[:WA, :WA].contiguous(), Vp[:, :WA].contiguous(),
            torch.tensor(kbot, **i32), torch.tensor(int(fail), **i32))


def aed_deflate(Tw, Vw, s: float, w: int, thresh: float):
    """Spike deflation: kernel B4 for a CUDA tensor, :func:`_aed_deflate`
    for a CPU tensor.  Returns (Tw, Vw, kbot, fail)."""
    if Tw.is_cuda:
        return gpu_schur.aed_deflate(Tw, Vw, s, w, thresh)
    return _aed_deflate(Tw, Vw, s, w, thresh)


def _aed_recondense(Tw, Vw, s: float, kbot: int):
    """Return the undeflated window part to Hessenberg form with the spike
    condensed into the first column.

    Applies (1) a reflector turning s * Vw[0, :kbot] into beta e1 and (2)
    an unblocked Householder Hessenberg reduction of the leading kbot x
    kbot block, both to T from both sides and to V: the plain twin of B5.
    Returns (Tw, Vw, beta).
    """
    T = Tw.clone()
    V = Vw.clone()
    WA = T.shape[0]

    def apply_both(v, tau, lo, hi):
        T[lo:hi] -= tau * torch.outer(v, v @ T[lo:hi])
        T[:, lo:hi] -= tau * torch.outer(T[:, lo:hi] @ v, v)
        V[:, lo:hi] -= tau * torch.outer(V[:, lo:hi] @ v, v)

    if kbot >= 1:
        v0, tau0, beta = prim.householder(s * V[0, :kbot])
        apply_both(v0, tau0, 0, kbot)
    else:
        beta = T.new_zeros(())
    for j in range(min(kbot - 1, WA - 2)):
        shift = j + 1
        v, tau, b = prim.householder(T[shift:kbot, j].clone())
        apply_both(v, tau, shift, kbot)
        T[shift + 1:kbot, j] = 0.0
        T[shift, j] = b
    return T, V, beta


def aed_recondense(Tw, Vw, s: float, kbot: int):
    """Recondense: kernel B5 for a CUDA tensor, :func:`_aed_recondense`
    for a CPU tensor.  Returns (Tw, Vw, beta)."""
    if Tw.is_cuda:
        return gpu_schur.aed_recondense(Tw, Vw, s, kbot)
    return _aed_recondense(Tw, Vw, s, kbot)


# ---------------------------------------------------------------------------
# windowed multishift sweep
# ---------------------------------------------------------------------------

def _train_hop_one(Wnd, sh, l_rel: int, ihi_rel: int, s0: int,
                   B: int, HOP: int):
    """One train's HOP steps inside its (WC, WC) window, in place on Wnd.

    Bulge b performs its column-k action at k = l_rel + s - 3b for step s
    in [s0, s0 + HOP).  Returns the window transform Qw.
    """
    WP = Wnd.shape[0]
    dev = Wnd.device
    Qw = torch.eye(WP, dtype=Wnd.dtype, device=dev)
    lr = _clamp(l_rel, 0, WP - 3)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    for t in range(HOP):
        s = s0 + t
        ks = [l_rel + s - 3 * b for b in range(B)]
        active = [l_rel <= k <= ihi_rel - 2 for k in ks]
        kc = [k if a else 1 for k, a in zip(ks, active)]
        intro = [a and k == l_rel for k, a in zip(ks, active)]
        use3 = [k <= ihi_rel - 3 for k in ks]

        r0 = [_clamp(k, 0, WP - 3) for k in kc]
        c0 = [_clamp(max(k - 1, 0), 0, WP - 1) for k in kc]
        ridx = torch.tensor([[r, r + 1, r + 2] for r in r0], device=dev)
        cols3 = Wnd[ridx, torch.tensor(c0, device=dev)[:, None]]
        use3_t = torch.tensor(use3, device=dev)
        intro_cols = prim.first_column_shifted(
            Wnd[lr:lr + 3, lr:lr + 3], sh[:, 0], sh[:, 1], sh[:, 2], sh[:, 3],
            use3_t)
        x = torch.where(torch.tensor(intro, device=dev)[:, None],
                        intro_cols, cols3)
        v, tau, beta = prim.householder(
            x, torch.stack([ones, ones, use3_t], 1))
        tau = torch.where(torch.tensor(active, device=dev), tau, 0.0)

        lo = l_rel + s - 3 * (B - 1)
        loc = _clamp(lo, 0, WP - 3 * B)
        vs = v.flip(0)
        taus = tau.flip(0)
        R = Wnd[loc:loc + 3 * B].reshape(B, 3, WP)
        w_ = torch.einsum("bi,bin->bn", vs, R)
        R = R - taus[:, None, None] * vs[:, :, None] * w_[:, None, :]
        Wnd[loc:loc + 3 * B] = R.reshape(3 * B, WP)

        # exact bulge-column plants, for the bulges past their introduction
        fix = [b for b in range(B) if active[b] and not intro[b]]
        if fix:
            k_f = torch.tensor([kc[b] for b in fix], device=dev)
            Wnd[k_f, k_f - 1] = beta[fix]
            Wnd[k_f + 1, k_f - 1] = 0.0
            f3 = torch.tensor([kc[b] for b in fix if use3[b]], device=dev,
                              dtype=torch.long)
            Wnd[f3 + 2, f3 - 1] = 0.0

        for M in (Wnd, Qw):
            C = M[:, loc:loc + 3 * B].reshape(WP, B, 3)
            wc = torch.einsum("nbi,bi->nb", C, vs)
            C = C - taus[None, :, None] * wc[:, :, None] * vs[None, :, :]
            M[:, loc:loc + 3 * B] = C.reshape(WP, 3 * B)
    return Qw


def _train_hop(Wnds, shifts, l_rel, ihi_rel, s0, B: int, HOP: int):
    """Advance G B-bulge trains HOP rows inside their windows: the plain
    twin of B3 (no vigilant deflation).

    ``Wnds`` (G, WC, WC), ``shifts`` (G, B, 4) of (sr1, si1, sr2, si2)
    rows, and host int sequences ``l_rel``, ``ihi_rel``, ``s0``.  A parked
    train (l_rel = 1, ihi_rel = 0) is an exact no-op.  Returns
    (Wnds2, Qw).
    """
    out = Wnds.clone()
    Qws = [_train_hop_one(out[g], shifts[g], int(l_rel[g]), int(ihi_rel[g]),
                          int(s0[g]), B, HOP) for g in range(Wnds.shape[0])]
    return out, torch.stack(Qws)


def train_hops(Wnds, shifts, gidx, l_rel, ihi_rel, s0, B: int, HOP: int):
    """One hop of G trains: kernel B3 for a CUDA tensor, :func:`_train_hop`
    for a CPU tensor.  Train g takes the shifts ``shifts[gidx[g]]`` of the
    (TMAX, B, 4) shift tensor.  Returns (Wnds2, Qw)."""
    if Wnds.is_cuda:
        return gpu_schur.train_hops(Wnds, shifts, gidx, l_rel, ihi_rel, s0,
                                    B=B, HOP=HOP)
    return _train_hop(Wnds, shifts[list(gidx)], l_rel, ihi_rel, s0,
                      B=B, HOP=HOP)


# stagger between consecutive trains of the wavefront, in hops: windows of
# neighbouring trains are 9B rows apart, more than WC = 6B+4, so all
# active windows are disjoint
_WAVE_STAG = 3


def _sweep_wave(Spad, Qpad, l: int, ihi: int, shifts, ntr: int, G: int,
                B: int, ext=DenseExtent):
    """Chase up to G staggered B-bulge trains across [l, ihi) in one pass.

    Train g runs ``_WAVE_STAG`` hops behind train g-1, so the active chase
    windows are disjoint: one B3 launch (``ext.window``) advances all of
    them, and the off-window row and column strips update by GEMMs (rows
    first, then columns; disjoint windows make the transforms commute).
    Trains outside their hop range are left out of the launch (the JAX
    version parks them as exact no-ops).  Every access to Spad and Qpad
    goes through ``ext``; both update in place.
    """
    WC = 6 * B + 4
    HOP = 3 * B
    steps = (ihi - l) - 2 + 3 * (B - 1) + 1
    nh = (steps + HOP - 1) // HOP
    total = nh + _WAVE_STAG * (max(ntr, 1) - 1)
    for h in range(total):
        trains = [g for g in range(min(G, ntr)) if 0 <= h - _WAVE_STAG * g < nh]
        if not trains:
            continue
        s0 = [(h - _WAVE_STAG * g) * HOP for g in trains]
        ws = [l + s - 3 * (B - 1) - 1 for s in s0]
        Wnds = ext.get_diag_blocks(Spad, ws, WC)
        Wnd2, Qw = ext.window(
            lambda W: train_hops(W, shifts, trains, [l - x for x in ws],
                                 [ihi - x for x in ws], s0, B=B, HOP=HOP),
            Wnds)
        ext.mul_rows_batch(Spad, ws, WC, Qw)
        ext.mul_cols_batch(Spad, ws, WC, Qw)
        ext.set_diag_blocks(Spad, Wnd2, ws)
        ext.mul_cols_batch(Qpad, ws, WC, Qw)


# ---------------------------------------------------------------------------
# shift selection (host side, from the round's status read)
# ---------------------------------------------------------------------------

def _pack_shifts(er, ei, tsub, kbot: int, NS: int, B: int, TMAX: int):
    """Select up to NS shifts from the undeflated window diagonal.

    ``er``/``ei`` (numpy, length WA) are the window eigenvalues, ``tsub``
    the window's subdiagonal and ``kbot`` the undeflated row count.  Takes
    the bottom-most even-sized run [start, kbot) that does not straddle a
    2x2 block, re-aligns conjugate pairs with the dlaqr0 3-rotation
    shuffle, and packs pairs bottom-first into a (TMAX, B, 4) array of
    (sr1, si1, sr2, si2) rows, replicating the last valid pair into unused
    slots.  Returns (shifts, npairs).
    """
    WA = er.shape[0]
    kreq = min(NS, (kbot // 2) * 2)
    start = kbot - kreq
    sc = _clamp(start, 1, WA - 1)
    if start >= 1 and tsub[sc - 1] != 0:
        start += 1
    kreq = kbot - start
    start += kreq % 2                     # drop the topmost value if odd
    kreq = max(kbot - start, 0)

    j = np.arange(NS)
    src = np.clip(start + j, 0, WA - 1)
    wr = np.where(j < kreq, er[src], 0.0)
    wi = np.where(j < kreq, ei[src], 0.0)
    for t in range(max(NS // 2, 1)):
        i = kreq - 1 - 2 * t
        ic = _clamp(i, 2, NS - 1)
        if i >= 2 and wi[ic] != -wi[ic - 1]:
            for a in (wr, wi):
                a[ic], a[ic - 1], a[ic - 2] = a[ic - 1], a[ic - 2], a[ic]

    npairs = kreq // 2
    pe = np.minimum(np.arange(TMAX * B), max(npairs - 1, 0))
    a1 = np.clip(kreq - 1 - 2 * pe, 0, NS - 1)
    a0 = np.clip(a1 - 1, 0, NS - 1)
    quad = np.stack([wr[a1], wi[a1], wr[a0], wi[a0]], axis=-1)
    return quad.reshape(TMAX, B, 4), npairs


# ---------------------------------------------------------------------------
# AED round
# ---------------------------------------------------------------------------

def _aed_round(Spad, Qpad, ihi: int, thresh: float, eyeW, P: int, WA: int,
               NS: int, B: int, TMAX: int, nibble: int, n: int,
               ext=DenseExtent):
    """One AED round, in place on Spad and Qpad.

    Negligible-subdiagonal zeroing, converged-block peel, segment scan, AED
    window Schur solve (B2), spike deflation with block moves (B4), shift
    extraction, recondense (B5), and the window-transform GEMMs.  Every
    access to Spad and Qpad goes through ``ext``, and the window math
    (B2, B4, the status read, B5) runs inside ``ext.window``.  Returns
    (shifts (TMAX, B, 4) tensor, status) with status the host ints
    (new_ihi, l, ntr, sfail, nd, npairs, w), w the window's active size.
    """
    dev, dtype = Spad.device, Spad.dtype

    # -- negligible-subdiagonal zeroing + converged-block peel (read 1) --
    sub = ext.zero_negligible(Spad, P, n, ihi, thresh).cpu().numpy()
    while ihi > 0:
        if ihi == 1 or sub[max(ihi - 2, 0)] == 0.0:
            ihi -= 1
        elif ihi == 2 or sub[max(ihi - 3, 0)] == 0.0:
            ihi -= 2
        else:
            break
    zb = np.nonzero(sub[:max(ihi - 1, 0)] == 0.0)[0]
    l = int(zb[-1]) + 1 if len(zb) and ihi > 0 else 0
    if ihi <= 0:
        return Spad.new_zeros((TMAX, B, 4)), (ihi, 0, 0, False, 0, 0, 0)

    seg = ihi - l                         # >= 2 after the peel
    w = min(WA, seg)
    kwtop = ihi - w
    gk = P + kwtop
    win = ext.get_block(Spad, gk, gk, WA, WA)
    win[w:] = 0.0
    win[:, w:] = 0.0
    # spike = the subdiagonal entering the window; 0 when kwtop == l
    s_spike = float(sub[kwtop - 1]) if kwtop >= 1 else 0.0

    def window_math(win):
        Tw, Vw, sinfo = small_schur(win, eyeW, w, thresh)
        Tw, Vw, kbot_t, _dfail = aed_deflate(Tw, Vw, s_spike, w, thresh)
        er_w, ei_w = extract_eigenvalues(Tw)
        # -- the round's status read (read 2) --
        head = torch.stack([sinfo, kbot_t]).to(dtype)
        status = torch.cat([head, er_w, ei_w,
                            torch.diagonal(Tw, -1)]).cpu().numpy()
        Tw, Vw, beta = aed_recondense(Tw, Vw, s_spike, int(status[1]))
        return Tw, Vw, beta, status

    Tw, Vw, beta, status = ext.window(window_math, win)
    sfail = status[0] != 0
    kbot = int(status[1])
    er_h, ei_h, tsub = np.split(status[2:], [WA, 2 * WA])
    nd = w - kbot
    shifts_h, npairs = _pack_shifts(er_h, ei_h, tsub, kbot, NS, B, TMAX)
    shifts = torch.from_numpy(shifts_h).to(dev)

    # window transform at full extents (Vw is the identity outside the
    # active block): rows, then columns, then the exact window plant and
    # the spike column (beta on top, zeros below)
    ext.mul_rows(Spad, gk, WA, Vw)
    ext.mul_cols(Spad, gk, WA, Vw)
    ext.set_block(Spad, Tw[:w, :w], gk, gk)
    spike = Spad.new_zeros((WA, 1))
    spike[0, 0] = beta
    ext.set_block(Spad, spike, gk, gk - 1)
    ext.mul_cols(Qpad, gk, WA, Vw)

    new_ihi = ihi - nd
    if npairs == 0:
        # exceptional-shift fallback when the window gave no usable pair
        tail = ext.get_block(Spad, P + new_ihi - 1, P + max(new_ihi - 2, 0),
                             1, 2)
        hq = tail[0, 0]
        d0 = tail[0, 1] if new_ihi >= 2 else hq
        esh = d0 + 0.75 * hq.abs()
        shifts = torch.stack([esh, 0 * esh, esh, 0 * esh]).expand(TMAX, B, 4)
        npairs = 1

    # nibble test + tiny-segment skip
    skip_sweep = ((nd > 0 and 100 * nd >= nibble * w)
                  or new_ihi - l <= 2 or sfail)
    ntr = 0 if skip_sweep else (npairs + B - 1) // B
    return shifts, (new_ihi, l, ntr, bool(sfail), nd, npairs, w)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _schur_iter(Spad, Qpad, thresh: float, eyeW, P: int, WA: int, NS: int,
                B: int, TMAX: int, nibble: int, itmax: int, n: int,
                log: Optional[list] = None, ext=DenseExtent):
    """The multishift-QR iteration: a host loop over AED rounds, each
    followed by a wavefront sweep when the round asks for one.  ``log``,
    if a list, receives (w, kbot, ntr) for each round: the window's active
    size, the rows it left undeflated, and the trains of its sweep.
    ``ext`` carries every access to the padded buffers: ``DenseExtent``
    for whole buffers, a sharded extent (``parallel/dm_core.py``) for
    column shards of them.

    Returns (ihi, fail, rounds): converged when ihi == 0, failed when
    fail != 0.
    """
    ihi, it_seg, last_ihi, fail, rounds = n, 0, n, 0, 0
    while ihi > 0 and fail == 0 and rounds < 2 * n + 10:
        shifts, (new_ihi, l, ntr, _sfail, nd, _np, w) = _aed_round(
            Spad, Qpad, ihi, thresh, eyeW, P=P, WA=WA, NS=NS, B=B,
            TMAX=TMAX, nibble=nibble, n=n, ext=ext)
        if log is not None:
            log.append((w, w - nd, ntr))
        it_seg = (0 if new_ihi != last_ihi else it_seg) + 1
        # a non-converged AED window is not fatal (dlaqr3 semantics); only
        # the per-segment iteration limit fails
        fail = int(it_seg > itmax)
        if ntr > 0 and fail == 0:
            _sweep_wave(Spad, Qpad, P + l, P + new_ihi, shifts, ntr,
                        G=TMAX, B=B, ext=ext)
        if fail == 0:
            ihi = new_ihi
        last_ihi = new_ihi
        rounds += 1
    return ihi, fail, rounds


def aed_geometry(n: int, conf):
    """(WA, NS, B, WC, TMAX, P) from a resolved SchurConf: the AED window,
    the shift count, the bulges a train, the train chase window, the trains
    of a sweep, and the padding on each side of the (n, n) matrix."""
    WA = min(max(32, conf.aed_window_size + 2), n)
    NS = max(2, min(conf.aed_shift_count // 2 * 2, 2 * (WA // 2)))
    B = max(2, min(conf.shifts_per_window // 2, NS // 2, max(2, n // 12)))
    WC = 6 * B + 4                        # train chase window
    TMAX = max(1, (NS // 2 + B - 1) // B)
    P = max(3 * B + 4, WC + 2, WA) + 2 + WC
    return WA, NS, B, WC, TMAX, P


def _resolve_threshold(H, conf) -> float:
    """Deflation threshold (norm-stable default: u ||H||_F)."""
    finfo = torch.finfo(H.dtype)
    tiny = finfo.tiny
    if conf.left_threshold == DeflationCriterion.NORM_STABLE:
        thresh = finfo.eps / 2 * float(torch.linalg.norm(H))
    elif conf.left_threshold == DeflationCriterion.LAPACK:
        thresh = tiny
    else:
        thresh = float(conf.left_threshold)
    return max(thresh, tiny)


def schur(H, Q=None, conf: Optional[SchurConf] = None,
          stats: Optional[dict] = None):
    """Reduce an upper Hessenberg H to real Schur form S = Qs^T H Qs.

    Q (if given) accumulates on the right.  Runs on H's device.  If
    ``stats`` is a dict it receives the geometry, the round count and
    ``aed_log``, the (w, kbot, ntr) of each round.

    Returns:
      (S, Q, eig_real, eig_imag, info) with info Error.SUCCESS or
      Error.DID_NOT_CONVERGE (the outputs then hold a partially reduced,
      still similar matrix).
    """
    n = H.shape[0]
    dtype, dev = H.dtype, H.device
    Q = torch.eye(n, dtype=dtype, device=dev) if Q is None else Q
    conf = (conf or SchurConf()).resolve(n)
    thresh = _resolve_threshold(H, conf)

    if n <= min(conf.small_limit, 300):
        # the whole problem below the small limit: one Francis solve
        S0, Z, sinfo = small_schur(H, torch.eye(n, dtype=dtype, device=dev),
                                   n, thresh)
        info = Error.SUCCESS if int(sinfo) == 0 else Error.DID_NOT_CONVERGE
        S0, QZ = standardize_blocks(S0, Q @ Z)
        er, ei = extract_eigenvalues(S0)
        if stats is not None:
            stats.update(path="small", rounds=0)
        return S0, QZ, er, ei, info

    WA, NS, B, WC, TMAX, P = aed_geometry(n, conf)
    NP = n + 2 * P

    Spad = H.new_zeros((NP, NP))
    Spad[P:P + n, P:P + n] = H
    Qpad = H.new_zeros((n, NP))
    Qpad[:, P:P + n] = Q
    eyeW = torch.eye(WA, dtype=dtype, device=dev)

    log = []
    ihi, fail, rounds = _schur_iter(
        Spad, Qpad, thresh, eyeW, P=P, WA=WA, NS=NS, B=B, TMAX=TMAX,
        nibble=conf.aed_nibble, itmax=conf.iteration_limit, n=n, log=log)
    info = Error.DID_NOT_CONVERGE if (fail or ihi > 0) else Error.SUCCESS
    if stats is not None:
        stats.update(path="aed", rounds=rounds, WA=WA, NS=NS, B=B, WC=WC,
                     TMAX=TMAX, P=P, NP=NP, aed_log=log)

    S, Qf = standardize_blocks(Spad[P:P + n, P:P + n], Qpad[:, P:P + n])
    er, ei = extract_eigenvalues(S)
    return S, Qf, er, ei, info
