"""Scalar linear-algebra primitives, elementwise over torch tensors.

Port of ``starneig_tpu/ops/primitives.py``: reflector generation (dlarfg),
plane rotations (dlartg), 2x2 eigenvalues and standardization (dlanv2) and
the double-shift first column (dlaqr1).  Every function is written as
``torch.where`` select chains over tensors of any (broadcast) shape, with
the same formulas, guards and conventions as the JAX package:
``_safe_div`` maps a zero denominator to 0 and ``_sign(0) == +1``.  The
CUDA kernels carry ``__device__`` twins of these functions in
``kernels/csrc/common.cuh`` with identical control flow.
"""

from __future__ import annotations

import torch


def _safe_div(num, den):
    """num/den with den == 0 mapped to 0 (used only on inactive lanes)."""
    den_ok = den != 0
    return torch.where(den_ok, num / torch.where(den_ok, den, 1.0), 0.0)


def _sign(x):
    """sign(x) with sign(0) == +1 (Fortran SIGN(1, x) semantics)."""
    return (x >= 0).to(x.dtype) * 2 - 1


def hypot2(x, y):
    """Robust sqrt(x^2 + y^2) (dlapy2)."""
    ax, ay = x.abs(), y.abs()
    w = torch.maximum(ax, ay)
    z = torch.minimum(ax, ay)
    r = _safe_div(z, w)
    return torch.where(w == 0, 0.0, w * torch.sqrt(1.0 + r * r))


def householder(x, mask=None):
    """Householder reflector annihilating x[..., 1:] (dlarfg semantics).

    Returns (v, tau, beta) with v[..., 0] == 1 and
    ``(I - tau v v^T) x = beta e1`` over the last axis.  ``mask`` marks the
    active entries: inactive ones count as zero and v is zero there.  The
    input is pre-scaled by max|x| (v and tau are scale invariant, beta
    scales back), exactly as the JAX version does.
    """
    if mask is not None:
        x = torch.where(mask, x, 0.0)
    m = x.abs().amax(-1, keepdim=True)
    msafe = torch.where(m == 0, 1.0, m)
    xs = x / msafe
    alpha = xs[..., :1]
    tail = xs.clone()
    tail[..., 0] = 0.0
    xnorm = torch.sqrt((tail * tail).sum(-1, keepdim=True))
    beta = -_sign(alpha) * hypot2(alpha, xnorm)
    degenerate = xnorm == 0
    tau = torch.where(degenerate, 0.0, _safe_div(beta - alpha, beta))
    v = torch.where(degenerate, 0.0, tail * _safe_div(1.0, alpha - beta))
    if mask is not None:
        v = torch.where(mask, v, 0.0)
    v[..., 0] = 1.0
    beta = torch.where(degenerate, alpha, beta) * msafe
    return v, tau[..., 0], beta[..., 0]


def givens(f, g):
    """Plane rotation zeroing g (dlartg): [c s; -s c] @ [f; g] = [r; 0]."""
    rmag = hypot2(f, g)
    r0 = _sign(f) * rmag
    rsafe = torch.where(r0 == 0, 1.0, r0)
    c = torch.where(g == 0, 1.0, torch.where(f == 0, 0.0, f / rsafe))
    s = torch.where(g == 0, 0.0, torch.where(f == 0, 1.0, g / rsafe))
    r = torch.where(g == 0, f, torch.where(f == 0, g, r0))
    return c, s, r


def eig2x2(a, b, c, d):
    """Eigenvalues of [[a, b], [c, d]] -> (re1, im1, re2, im2)."""
    sc = a.abs() + b.abs() + c.abs() + d.abs()
    sc = torch.where(sc == 0, 1.0, sc)
    a, b, c, d = a / sc, b / sc, c / sc, d / sc
    p = 0.5 * (a - d)
    bc = b * c
    disc = p * p + bc
    sq = torch.sqrt(disc.abs())
    real_case = disc >= 0
    z = p + _sign(p) * sq
    mid = 0.5 * (a + d)
    lam1_r = torch.where(real_case, d + z, mid)
    lam2_r = torch.where(real_case,
                         torch.where(z == 0, d, d - _safe_div(bc, z)), mid)
    lam1_i = torch.where(real_case, 0.0, sq)
    lam2_i = torch.where(real_case, 0.0, -sq)
    return lam1_r * sc, lam1_i * sc, lam2_r * sc, lam2_i * sc


def standardize_2x2(a, b, c, d):
    """Standardize a real 2x2 Schur block (dlanv2 semantics).

    Returns (aa, bb, cc, dd, rt1r, rt1i, rt2r, rt2i, cs, sn) with
    ``[cs sn; -sn cs]^T [a b; c d] [cs sn; -sn cs] = [aa bb; cc dd]`` and
    either cc == 0 or aa == dd with bb * cc < 0.
    """
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    finfo = torch.finfo(a.dtype)
    eps, tiny = finfo.eps, finfo.tiny
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)

    # general path quantities (guarded)
    temp0 = a - d
    p0 = 0.5 * temp0
    bcmax = torch.maximum(b.abs(), c.abs())
    bcmis = torch.minimum(b.abs(), c.abs()) * _sign(b) * _sign(c)
    scale = torch.maximum(p0.abs(), bcmax)
    z0 = _safe_div(p0, scale) * p0 + _safe_div(bcmax, scale) * bcmis
    real_gen = z0 >= 4.0 * eps

    # general / real eigenvalues branch
    zr = p0 + _sign(p0) * torch.sqrt(scale.clamp_min(0)) \
        * torch.sqrt(z0.clamp_min(0))
    a_r = d + zr
    d_r = d - _safe_div(bcmax, zr) * bcmis
    tau_r = hypot2(c, zr)
    cs_r = _safe_div(zr, tau_r)
    sn_r = _safe_div(c, tau_r)
    b_r = b - c
    c_r = zero

    # general / complex-or-equal branch
    sigma = b + c
    tau_c = hypot2(sigma, temp0)
    cs_c = torch.sqrt(0.5 * (1.0 + _safe_div(sigma.abs(), tau_c)))
    sn_c = -_safe_div(p0, tau_c * cs_c) * _sign(sigma)
    aa = a * cs_c + b * sn_c
    bb = -a * sn_c + b * cs_c
    cc = c * cs_c + d * sn_c
    dd = -c * sn_c + d * cs_c
    a1 = aa * cs_c + cc * sn_c
    b1 = bb * cs_c + dd * sn_c
    c1 = -aa * sn_c + cc * cs_c
    d1 = -bb * sn_c + dd * cs_c
    tmid = 0.5 * (a1 + d1)
    a1 = tmid
    d1 = tmid
    # (i) c1 != 0, b1 != 0 and sign(b1) == sign(c1): real almost-equal pair
    sab = torch.sqrt(b1.abs())
    sac = torch.sqrt(c1.abs())
    p1 = _sign(c1) * sab * sac
    tau1 = _safe_div(one, torch.sqrt((b1 + c1).abs().clamp_min(tiny)))
    a_i = tmid + p1
    d_i = tmid - p1
    b_i = b1 - c1
    c_i = zero
    cs1 = sab * tau1
    sn1 = sac * tau1
    cs_i = cs_c * cs1 - sn_c * sn1
    sn_i = cs_c * sn1 + sn_c * cs1
    # (ii) c1 != 0 and b1 == 0: swap
    b_ii = -c1
    c_ii = zero
    cs_ii = -sn_c
    sn_ii = cs_c
    sub_i = (c1 != 0) & (b1 != 0) & (_sign(b1) == _sign(c1))
    sub_ii = (c1 != 0) & (b1 == 0)
    a_cx = torch.where(sub_i, a_i, a1)
    b_cx = torch.where(sub_i, b_i, torch.where(sub_ii, b_ii, b1))
    c_cx = torch.where(sub_i, c_i, torch.where(sub_ii, c_ii, c1))
    d_cx = torch.where(sub_i, d_i, d1)
    cs_cx = torch.where(sub_i, cs_i, torch.where(sub_ii, cs_ii, cs_c))
    sn_cx = torch.where(sub_i, sn_i, torch.where(sub_ii, sn_ii, sn_c))

    a_g = torch.where(real_gen, a_r, a_cx)
    b_g = torch.where(real_gen, b_r, b_cx)
    c_g = torch.where(real_gen, c_r, c_cx)
    d_g = torch.where(real_gen, d_r, d_cx)
    cs_g = torch.where(real_gen, cs_r, cs_cx)
    sn_g = torch.where(real_gen, sn_r, sn_cx)

    # top-level select chain
    case1 = c == 0
    case2 = (~case1) & (b == 0)
    case3 = (~case1) & (~case2) & (temp0 == 0) & (_sign(b) != _sign(c))

    aa_f = torch.where(case1, a, torch.where(case2, d, torch.where(case3, a, a_g)))
    bb_f = torch.where(case1, b, torch.where(case2, -c, torch.where(case3, b, b_g)))
    cc_f = torch.where(case1, c, torch.where(case2, zero, torch.where(case3, c, c_g)))
    dd_f = torch.where(case1, d, torch.where(case2, a, torch.where(case3, d, d_g)))
    cs_f = torch.where(case1 | case3, one, torch.where(case2, zero, cs_g))
    sn_f = torch.where(case1 | case3, zero, torch.where(case2, one, sn_g))

    # a standardized complex block has aa == dd exactly
    dd_f = torch.where(cc_f == 0, dd_f, aa_f)
    rt1r = aa_f
    rt2r = dd_f
    imag = torch.sqrt(bb_f.abs()) * torch.sqrt(cc_f.abs())
    rt1i = torch.where(cc_f == 0, zero, imag)
    rt2i = -rt1i
    return aa_f, bb_f, cc_f, dd_f, rt1r, rt1i, rt2r, rt2i, cs_f, sn_f


def first_column_shifted(h, sr1, si1, sr2, si2, use3):
    """First column of (H - s1 I)(H - s2 I), scaled (dlaqr1 semantics).

    ``h`` is the (3, 3) leading block; when ``use3`` is false only its 2x2
    part counts and the third entry is 0.  Shifts and ``use3`` broadcast
    (a batch of shift pairs against one block).  Returns (..., 3).
    """
    use3 = torch.as_tensor(use3, device=h.device)
    h11, h12, h13 = h[0, 0], h[0, 1], h[0, 2]
    h21, h22, h23 = h[1, 0], h[1, 1], h[1, 2]
    h31, h32, h33 = h[2, 0], h[2, 1], h[2, 2]

    s3 = (h11 - sr2).abs() + si2.abs() + h21.abs() + h31.abs()
    h21s3 = _safe_div(h21, s3)
    h31s3 = _safe_div(h31, s3)
    v1_3 = (h11 - sr1) * _safe_div(h11 - sr2, s3) - si1 * _safe_div(si2, s3) \
        + h12 * h21s3 + h13 * h31s3
    v2_3 = h21s3 * (h11 + h22 - sr1 - sr2) + h23 * h31s3
    v3_3 = h31s3 * (h11 + h33 - sr1 - sr2) + h21s3 * h32

    s2 = (h11 - sr2).abs() + si2.abs() + h21.abs()
    h21s2 = _safe_div(h21, s2)
    v1_2 = h21s2 * h12 + (h11 - sr1) * _safe_div(h11 - sr2, s2) \
        - si1 * _safe_div(si2, s2)
    v2_2 = h21s2 * (h11 + h22 - sr1 - sr2)

    v1 = torch.where(use3, torch.where(s3 == 0, 0.0, v1_3),
                     torch.where(s2 == 0, 0.0, v1_2))
    v2 = torch.where(use3, torch.where(s3 == 0, 0.0, v2_3),
                     torch.where(s2 == 0, 0.0, v2_2))
    v3 = torch.where(use3, torch.where(s3 == 0, 0.0, v3_3), 0.0)
    v1, v2, v3 = torch.broadcast_tensors(v1, v2, v3)
    return torch.stack([v1, v2, v3], -1)
