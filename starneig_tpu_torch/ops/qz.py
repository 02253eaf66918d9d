"""QZ iteration: generalized Schur form of a small Hessenberg-triangular pencil.

Port of ``starneig_tpu/ops/qz.py``: double-implicit-shift Moler-Stewart QZ
(dhgeqz's algorithm) for an AED window, or for a whole problem below the
small limit:

  * H-subdiagonal deflation with the pairwise test plus an absolute floor,
  * infinite eigenvalues (a negligible T diagonal): the zero is chased to
    the segment bottom with left rotations and deflated by a right rotation
    zeroing H[i, i-1],
  * double-shift sweeps: a left 3-reflector chases the bulge through H
    while a right 3-reflector and a rotation restore T's triangularity,
  * converged 2x2 blocks standardized (dlagv2's semantics).

:func:`_small_qz_plain` runs the JAX package's state machine as a host loop
(one scalar read per decision); :func:`small_qz` is the dispatcher: kernel
G2 (:func:`starneig_tpu_torch.ops.gpu_gep.qz_window`) for a CUDA tensor,
the plain loop for a CPU tensor.
"""

from __future__ import annotations

import torch

from starneig_tpu_torch.ops import gpu_gep
from starneig_tpu_torch.ops import primitives as prim
from starneig_tpu_torch.ops.hess_triangular import rot_cols, rot_rows

ITMAX_PER_BLOCK = 40
FLOOR = torch.finfo(torch.float64).tiny ** 0.5   # the pivots' safety floor
ULP = torch.finfo(torch.float64).eps


def _safe(x, floor):
    return torch.where(x.abs() < floor, torch.where(x < 0, -floor, floor), x)


def _pencil_m2(h11, h12, h21, h22, t11, t12, t22, floor):
    """M = H2 inv(T2) for a 2x2 pencil with T upper triangular."""
    t11 = _safe(t11, floor)
    t22 = _safe(t22, floor)
    m11 = h11 / t11
    m21 = h21 / t11
    m12 = (h12 - m11 * t12) / t22
    m22 = (h22 - m21 * t12) / t22
    return m11, m12, m21, m22


def _shifts_qz(H, T, i: int, its: int):
    """Double shift from the trailing 2x2 of the pencil; exceptional every 10."""
    m11, m12, m21, m22 = _pencil_m2(H[i - 1, i - 1], H[i - 1, i], H[i, i - 1],
                                    H[i, i], T[i - 1, i - 1], T[i - 1, i],
                                    T[i, i], FLOOR)
    if its > 0 and its % 10 == 0:
        s = (H[i, i - 1] / _safe(T[i - 1, i - 1], FLOOR)).abs() + \
            (H[i - 1, i - 2] / _safe(T[i - 2, i - 2], FLOOR)).abs()
        e11 = 0.75 * s + m22
        a, b, c, d = e11, -0.4375 * s, s, e11
    else:
        a, b, c, d = m11, m12, m21, m22
    rt1r, rt1i, rt2r, rt2i = prim.eig2x2(a, b, c, d)
    real_pair = rt1i == 0
    use1 = (m22 - rt1r).abs() <= (m22 - rt2r).abs()
    sr1 = torch.where(real_pair, torch.where(use1, rt1r, rt2r), rt1r)
    sr2 = torch.where(real_pair, sr1, rt2r)
    si1 = torch.where(real_pair, 0.0, rt1i)
    return sr1, si1, sr2, -si1


def _first_col_qz(H, T, l: int, sr1, si1, sr2, si2, use3=True,
                  plus_floor: bool = False):
    """First column of (H T^-1 - s1)(H T^-1 - s2), restricted to 3 rows.

    T's pivots are floored at FLOOR keeping their sign, or at +FLOOR with
    ``plus_floor`` (the JAX QZ train's rule).  The shifts and ``use3`` may
    be batched (a (B,) tensor each); returns (..., 3).
    """
    if plus_floor:
        def piv(x):
            return torch.where(x.abs() < FLOOR, FLOOR, x)
    else:
        def piv(x):
            return _safe(x, FLOOR)
    t11, t22, t33 = piv(T[l, l]), piv(T[l + 1, l + 1]), piv(T[l + 2, l + 2])
    t12, t13, t23 = T[l, l + 1], T[l, l + 2], T[l + 1, l + 2]
    invT = H.new_zeros((3, 3))
    invT[0, 0] = 1.0 / t11
    invT[1, 1] = 1.0 / t22
    invT[2, 2] = 1.0 / t33
    invT[0, 1] = -t12 / (t11 * t22)
    invT[1, 2] = -t23 / (t22 * t33)
    invT[0, 2] = (t12 * t23 - t13 * t22) / (t11 * t22 * t33)
    M3 = H[l:l + 3, l:l + 3] @ invT
    return prim.first_column_shifted(M3, sr1, si1, sr2, si2, use3)


def std_gep_2x2(a11, a12, a21, a22, b11, b12, b21, b22):
    """Elementwise core of :func:`standardize_gep_2x2` over tensors of any
    (broadcast) shape: returns the standardized entries (a11', a12', a21',
    a22', b11', b12', b21', b22') and the rotations (cl, sl, cr, sr)."""
    floor = FLOOR
    m11, m12, m21, m22 = _pencil_m2(a11, a12, a21, a22, b11, b12, b22, floor)
    l1r, l1i, _l2r, _l2i = prim.eig2x2(m11, m12, m21, m22)
    # a numerically singular B2 holds an infinite eigenvalue and splits as
    # a real pair (dlagv2)
    bnorm = b11.abs() + b12.abs() + b22.abs()
    b_sing = torch.minimum(b11.abs(), b22.abs()) <= 8 * ULP * bnorm
    is_real = (l1i == 0) | b_sing

    # real case: right rotation from the null vector of (A - lam B)'s
    # larger row
    lam = l1r
    r00, r01 = a11 - lam * b11, a12 - lam * b12
    r10, r11 = a21, a22 - lam * b22
    use_r1 = r10 * r10 + r11 * r11 > r00 * r00 + r01 * r01
    w0 = -torch.where(use_r1, r11, r01)
    w1 = torch.where(use_r1, r10, r00)
    nw = torch.sqrt(w0 * w0 + w1 * w1)
    degenerate = nw < floor
    nws = torch.where(degenerate, 1.0, nw)
    cr = torch.where(degenerate, 1.0, w0 / nws)
    sr = torch.where(degenerate, 0.0, w1 / nws)

    # infinite-eigenvalue split: B2's null vector to the first column
    inf_at_11 = b11.abs() <= b22.abs()
    rinf = torch.sqrt(b12 * b12 + b11 * b11)
    rdeg = rinf < floor
    rsafe = torch.where(rdeg, 1.0, rinf)
    cr_i = torch.where(inf_at_11, 1.0, torch.where(rdeg, 1.0, -b12 / rsafe))
    sr_i = torch.where(inf_at_11, 0.0, torch.where(rdeg, 0.0, b11 / rsafe))
    cr = torch.where(b_sing, cr_i, cr)
    sr = torch.where(b_sing, sr_i, sr)

    # B' = B Gr; the left rotation zeroes B'[1, 0] (A'[1, 0] in the split)
    cl, sl, _ = prim.givens(b11 * cr + b12 * sr, b22 * sr)
    cl_i, sl_i, _ = prim.givens(a11 * cr + a12 * sr, a21 * cr + a22 * sr)
    cl = torch.where(b_sing, cl_i, cl)
    sl = torch.where(b_sing, sl_i, sl)
    cr = torch.where(is_real, cr, 1.0)
    sr = torch.where(is_real, sr, 0.0)
    cl = torch.where(is_real, cl, 1.0)
    sl = torch.where(is_real, sl, 0.0)

    def gl_t_x_gr(x11, x12, x21, x22):
        """G_l^T X G_r with G = [[c, -s], [s, c]]."""
        y11 = cl * x11 + sl * x21
        y12 = cl * x12 + sl * x22
        y21 = -sl * x11 + cl * x21
        y22 = -sl * x12 + cl * x22
        return (y11 * cr + y12 * sr, -y11 * sr + y12 * cr,
                y21 * cr + y22 * sr, -y21 * sr + y22 * cr)

    A11, A12, A21, A22 = gl_t_x_gr(a11, a12, a21, a22)
    B11, B12, _B21, B22 = gl_t_x_gr(b11, b12, b21, b22)
    # exact zeros: A's (2,1) in the real case, B's (2,1) always, and the
    # zero beta of the singular-B split
    A21 = torch.where(is_real, 0.0, A21)
    B21 = torch.zeros_like(B11)
    B11 = torch.where(b_sing, 0.0, B11)
    return A11, A12, A21, A22, B11, B12, B21, B22, cl, sl, cr, sr


def standardize_gep_2x2(A2, B2):
    """Standardize a 2x2 pencil block (dlagv2 semantics, B upper triangular).

    Returns (A2', B2', cl, sl, cr, sr): rotations with A2' = G_l^T A2 G_r,
    B2' = G_l^T B2 G_r (G = [[c, -s], [s, c]]) and either A2'[1, 0] == 0
    (real eigenvalues, both triangular; a numerically singular B2 splits
    with the exact zero beta on top) or a complex-pair block.
    """
    out = std_gep_2x2(A2[0, 0], A2[0, 1], A2[1, 0], A2[1, 1],
                      B2[0, 0], B2[0, 1], B2[1, 0], B2[1, 1])
    A2n = torch.stack(out[0:4]).reshape(2, 2)
    B2n = torch.stack(out[4:8]).reshape(2, 2)
    return (A2n, B2n, *out[8:])


# ---------------------------------------------------------------------------
# the state machine's moves, in place on the padded (w+3) buffers
# ---------------------------------------------------------------------------

def _find_l(Hp, w: int, i: int, thresh_h: float) -> int:
    """Largest l in (0, i] with a negligible H[l, l-1]; else 0."""
    H = Hp[:w, :w]
    d = torch.diagonal(H)
    sub = torch.diagonal(H, -1)
    tst = d[:-1].abs() + d[1:].abs()
    neg = sub.abs() <= torch.clamp_min(ULP * tst, thresh_h)
    idx = torch.arange(1, w, device=H.device)
    cand = neg & (idx > 0) & (idx <= i)
    return int(torch.where(cand, idx, 0).max()) if w > 1 else 0


def _find_inf(Hp, Tp, w: int, l: int, i: int, thresh_h: float,
              thresh_t: float) -> int:
    """The topmost negligible T diagonal in [l, i] that can be chased (dhgeqz's
    ILAZRO/ILAZR2 test), or -1."""
    tdiag = torch.diagonal(Tp[:w, :w]).abs()
    tsmall = tdiag <= torch.clamp_min(ULP * tdiag.max(), thresh_t)
    idx = torch.arange(w, device=Tp.device)
    cand = tsmall & (idx >= l) & (idx <= i)
    if not bool(cand.any()):
        return -1
    j = int(torch.where(cand, idx, w).min())
    if j == l:
        return j
    hjm = float(Hp[j, max(j - 1, 0)].abs())
    hsub = float(Hp[min(j + 1, w - 1), j].abs())
    hdia = float(Hp[j, j].abs())
    ok = hjm * hsub <= max(thresh_h, ULP * hdia * (hjm + hsub + hdia))
    return j if ok else -1


def _process_inf(Hp, Tp, Qp, Zp, j: int, l: int, i: int,
                 thresh_t: float) -> int:
    """Chase the zero T[j, j] down with left rotations and, if it reaches
    row i, deflate the infinite eigenvalue with a right rotation zeroing
    H[i, i-1].  Returns the new i."""
    Tp[j, j] = 0.0
    stopped = False
    for jc in range(j, i):
        c, s, _ = prim.givens(Hp[jc, jc], Hp[jc + 1, jc])
        rot_rows(Hp, jc + 1, c, s)
        Hp[jc + 1, jc] = 0.0
        if jc == j and jc > l and jc >= 1:
            # dhgeqz's ILAZR2: drop the negligible fill below the subdiagonal
            Hp[jc + 1, jc - 1] = 0.0
        rot_rows(Tp, jc + 1, c, s)
        rot_cols(Qp, jc + 1, c, s)
        tsig = float(Tp[jc + 1, jc + 1].abs()) > max(
            thresh_t, ULP * float(Tp[jc, jc + 1].abs()))
        if tsig:
            stopped = True
            break
        Tp[jc + 1, jc + 1] = 0.0
    if stopped:
        return i
    c, s, _ = prim.givens(Hp[i, i], Hp[i, i - 1])
    rot_cols(Hp, i, c, -s)
    Hp[i, i - 1] = 0.0
    rot_cols(Tp, i, c, -s)
    Tp[i, i - 1] = 0.0
    rot_cols(Zp, i, c, -s)
    return i - 1


def _sweep(Hp, Tp, Qp, Zp, w: int, l: int, i: int, its: int):
    """One double-shift QZ sweep over the active block [l, i], in place."""
    sr1, si1, sr2, si2 = _shifts_qz(Hp[:w, :w], Tp[:w, :w], i, its)
    dev = Hp.device
    m3 = torch.ones(3, dtype=torch.bool, device=dev)
    m2 = m3.clone()
    m2[2] = False
    for k in range(l, i):
        use3 = k <= i - 2
        if k == l:
            x = _first_col_qz(Hp, Tp, l, sr1, si1, sr2, si2)
        else:
            x = Hp[k:k + 3, k - 1].clone()
        v, tau, beta = prim.householder(x, m3 if use3 else m2)
        # left reflector on H, T rows k..k+2 and Q columns k..k+2
        for M in (Hp, Tp):
            rows = M[k:k + 3]
            rows -= tau * torch.outer(v, v @ rows)
        qc = Qp[:, k:k + 3]
        qc -= tau * torch.outer(qc @ v, v)
        if k > l:
            Hp[k, k - 1] = beta
            Hp[k + 1, k - 1] = 0.0
            if use3:
                Hp[k + 2, k - 1] = 0.0
        if use3:
            # right reflector from T's row k+2, zeroing T[k+2, k:k+2]
            vr, tau_r, _ = prim.householder(Tp[k + 2, k:k + 3].flip(0), m3)
            vr = vr.flip(0)
            for M in (Hp, Tp, Zp):
                cols = M[:, k:k + 3]
                cols -= tau_r * torch.outer(cols @ vr, vr)
            Tp[k + 2, k] = 0.0
            Tp[k + 2, k + 1] = 0.0
        # right rotation zeroing T[k+1, k]
        c2, s2, _ = prim.givens(Tp[k + 1, k + 1], Tp[k + 1, k])
        rot_cols(Hp, k + 1, c2, -s2)
        rot_cols(Tp, k + 1, c2, -s2)
        Tp[k + 1, k] = 0.0
        rot_cols(Zp, k + 1, c2, -s2)


def _deflate2(Hp, Tp, Qp, Zp, i: int):
    """Standardize the converged 2x2 block at rows (i-1, i), in place."""
    A2n, B2n, cl, sl, cr, sr = standardize_gep_2x2(
        Hp[i - 1:i + 1, i - 1:i + 1].clone(), Tp[i - 1:i + 1, i - 1:i + 1].clone())
    rot_rows(Hp, i, cl, sl)
    rot_rows(Tp, i, cl, sl)
    rot_cols(Qp, i, cl, sl)
    rot_cols(Hp, i, cr, sr)
    rot_cols(Tp, i, cr, sr)
    rot_cols(Zp, i, cr, sr)
    Hp[i - 1:i + 1, i - 1:i + 1] = A2n
    Tp[i - 1:i + 1, i - 1:i + 1] = B2n


def _small_qz_plain(H, T, Q, Z, m: int, thresh_h: float = 0.0,
                    thresh_t: float = 0.0):
    """Plain PyTorch window QZ: the twin of kernel G2.  Same contract as
    :func:`small_qz`; the control flow runs on the host."""
    w = H.shape[0]
    max_total_iter = 40 * w
    WP = w + 3
    Hp = H.new_zeros((WP, WP))
    Hp[:w, :w] = H
    Tp = H.new_zeros((WP, WP))
    Tp[:w, :w] = T
    Qp = H.new_zeros((w, WP))
    Qp[:, :w] = Q
    Zp = H.new_zeros((w, WP))
    Zp[:, :w] = Z
    i, its, total, failed = m - 1, 0, 0, False
    while i >= 0 and not failed and total < max_total_iter:
        l = _find_l(Hp, w, i, thresh_h)
        if l > 0:
            Hp[l, l - 1] = 0.0
        jinf = _find_inf(Hp, Tp, w, l, i, thresh_h, thresh_t)
        if jinf >= 0:
            i = _process_inf(Hp, Tp, Qp, Zp, jinf, l, i, thresh_t)
            its = 0
        elif l >= i - 1:
            if l == i - 1:
                _deflate2(Hp, Tp, Qp, Zp, i)
            i = i - 1 if l == i else i - 2
            its = 0
        else:
            _sweep(Hp, Tp, Qp, Zp, w, l, i, its)
            its += 1
            failed = its >= ITMAX_PER_BLOCK
        total += 1
    info = torch.tensor(i + 1 if failed else 0, dtype=torch.int32,
                        device=H.device)
    return (Hp[:w, :w].clone(), Tp[:w, :w].clone(), Qp[:, :w].clone(),
            Zp[:, :w].clone(), info)


def small_qz(H, T, Q, Z, m: int, thresh_h: float = 0.0, thresh_t: float = 0.0):
    """Generalized real Schur form of the active m x m pencil (H, T).

    Args:
      H: (w, w) upper Hessenberg; T: (w, w) upper triangular (active block).
      Q, Z: (w, w) accumulation matrices (left and right transforms).
      m: active size; thresh_h, thresh_t: absolute deflation floors.

    Returns:
      (S, Tt, Q, Z, info): S quasi-triangular, Tt upper triangular with
      zero diagonal entries marking infinite eigenvalues; info a 0-d int32
      tensor, 0 on success else the failing row + 1 (stopping at the total
      iteration cap, 40 w, is not a failure, as in the JAX machine).
    """
    if H.is_cuda:
        return gpu_gep.qz_window(H, T, Q, Z, m, float(thresh_h),
                                 float(thresh_t))
    return _small_qz_plain(H, T, Q, Z, m, float(thresh_h), float(thresh_t))
