"""Dense Francis double-implicit-shift QR for small / window problems.

Port of ``starneig_tpu/ops/small_schur.py``: the recursion base of the
Schur component (the AED window solver and the whole-problem solver below
the small limit).  :func:`_small_schur_plain` is the plain PyTorch version
of the algorithm, a host loop over iterations:

  * bottom-up deflation with the pairwise negligibility test plus a
    caller-provided absolute floor,
  * Wilkinson double shifts from the trailing 2x2, exceptional every 10
    iterations, at most 30 iterations per block,
  * a 3-element bulge chase with full-width row and full-height column
    updates on the (w+2)-padded matrix,
  * 2x2 block standardization on deflation.

:func:`small_schur` is the entry point: it launches kernel B2
(:func:`starneig_tpu_torch.ops.gpu_schur.francis`) for a CUDA tensor and
runs this plain version for a CPU tensor.
"""

from __future__ import annotations

import torch

from starneig_tpu_torch.ops import gpu_schur
from starneig_tpu_torch.ops import primitives as prim

ITMAX_PER_BLOCK = 30  # exceptional-shift cadence 10; hard per-block cap


def _find_deflation(H, ilo: int, i: int, thresh: float) -> int:
    """Largest l in (ilo, i] with negligible H[l, l-1]; else ilo."""
    ulp = torch.finfo(H.dtype).eps
    d = torch.diagonal(H)
    sub = torch.diagonal(H, -1)
    tst = d[:-1].abs() + d[1:].abs()
    neg = sub.abs() <= torch.clamp_min(ulp * tst, thresh)
    idx = torch.arange(1, H.shape[0], device=H.device)
    cand = neg & (idx > ilo) & (idx <= i)
    return max(ilo, int(torch.where(cand, idx, ilo).max()))


def _shifts(H, i: int, its: int):
    """Wilkinson double shift from the trailing 2x2; exceptional every 10."""
    h11, h12 = H[i - 1, i - 1], H[i - 1, i]
    h21, h22 = H[i, i - 1], H[i, i]
    if its > 0 and its % 10 == 0:
        s = H[i, i - 1].abs() + H[i - 1, max(i - 2, 0)].abs()
        e11 = 0.75 * s + h22
        a, b, c, d = e11, -0.4375 * s, s, e11
    else:
        a, b, c, d = h11, h12, h21, h22
    rt1r, rt1i, rt2r, rt2i = prim.eig2x2(a, b, c, d)
    real_pair = rt1i == 0
    use1 = (h22 - rt1r).abs() <= (h22 - rt2r).abs()
    sr1 = torch.where(real_pair, torch.where(use1, rt1r, rt2r), rt1r)
    sr2 = torch.where(real_pair, sr1, rt2r)
    si1 = torch.where(real_pair, 0.0, rt1i)
    return sr1, si1, sr2, -si1


def _sweep(Hp, Zp, l: int, i: int, sr1, si1, sr2, si2):
    """One double-shift bulge chase over the active block [l, i], in place."""
    mask3 = torch.ones(3, dtype=torch.bool, device=Hp.device)
    mask2 = mask3.clone()
    mask2[2] = False
    for k in range(l, i):
        use3 = k <= i - 2
        if k == l:
            x = prim.first_column_shifted(Hp[k:k + 3, k:k + 3],
                                          sr1, si1, sr2, si2, use3)
        else:
            x = Hp[k:k + 3, k - 1].clone()
            if not use3:
                x[2] = 0.0
        v, tau, beta = prim.householder(x, mask3 if use3 else mask2)

        rows = Hp[k:k + 3, :]
        rows -= tau * torch.outer(v, v @ rows)
        if k > l:  # plant the exact chase column
            Hp[k, k - 1] = beta
            Hp[k + 1, k - 1] = 0.0
            if use3:
                Hp[k + 2, k - 1] = 0.0
        cols = Hp[:, k:k + 3]
        cols -= tau * torch.outer(cols @ v, v)
        zc = Zp[:, k:k + 3]
        zc -= tau * torch.outer(zc @ v, v)


def _deflate_block(Hp, Zp, l: int, i: int):
    """Standardize a converged 2x2 block (l == i-1) in place."""
    if l != i - 1:
        return
    aa, bb, cc, dd, *_rt, cs, sn = prim.standardize_2x2(
        Hp[i - 1, i - 1], Hp[i - 1, i], Hp[i, i - 1], Hp[i, i])
    r0, r1 = Hp[i - 1].clone(), Hp[i].clone()
    Hp[i - 1] = cs * r0 + sn * r1
    Hp[i] = -sn * r0 + cs * r1
    c0, c1 = Hp[:, i - 1].clone(), Hp[:, i].clone()
    Hp[:, i - 1] = cs * c0 + sn * c1
    Hp[:, i] = -sn * c0 + cs * c1
    Hp[i - 1, i - 1], Hp[i - 1, i] = aa, bb
    Hp[i, i - 1], Hp[i, i] = cc, dd
    z0, z1 = Zp[:, i - 1].clone(), Zp[:, i].clone()
    Zp[:, i - 1] = cs * z0 + sn * z1
    Zp[:, i] = -sn * z0 + cs * z1


def _small_schur_plain(H, Z, m: int, thresh: float = 0.0, ilo: int = 0,
                       max_total_iter: int = 0, with_steps: bool = False):
    """Plain PyTorch Francis solver: the twin of kernel B2.

    Same contract as :func:`small_schur`.  Control flow runs on the host:
    one scalar read per iteration (the deflation point).
    """
    w = H.shape[0]
    if max_total_iter == 0:
        max_total_iter = 30 * w
    Hp = H.new_zeros((w + 2, w + 2))
    Hp[:w, :w] = H
    Zp = H.new_zeros((w, w + 2))
    Zp[:, :w] = Z
    i, its, total, failed, steps = m - 1, 0, 0, False, 0
    while i >= ilo and not failed and total < max_total_iter:
        l = _find_deflation(Hp[:w, :w], ilo, i, thresh)
        if l > ilo:
            Hp[l, l - 1] = 0.0
        if l >= i - 1:
            _deflate_block(Hp, Zp, l, i)
            i = i - 1 if l == i else i - 2
            its = 0
        else:
            shifts = _shifts(Hp[:w, :w], i, its)
            _sweep(Hp, Zp, l, i, *shifts)
            steps += i - l
            its += 1
            failed = its >= ITMAX_PER_BLOCK
        total += 1
    i32 = dict(dtype=torch.int32, device=H.device)
    out = (Hp[:w, :w].clone(), Zp[:, :w].clone(),
           torch.tensor(i + 1 if failed else 0, **i32))
    return (*out, torch.tensor(steps, **i32)) if with_steps else out


def small_schur(H, Z, m: int, thresh: float = 0.0, ilo: int = 0,
                max_total_iter: int = 0, with_steps: bool = False):
    """Real Schur form of the active m x m Hessenberg block of H.

    Args:
      H: (w, w) upper Hessenberg in [0, m) x [0, m); anything outside the
        active block is ignored (zeros recommended).
      Z: (w, w) initial accumulation matrix; transforms accumulate as Z Q.
      m: active size (m <= w).
      thresh: absolute deflation floor (0 = pure LAPACK pairwise test).
      ilo: active block start.
      max_total_iter: 0 -> auto (30 * w).

    Returns:
      (S, Z, info): S (w, w), Z (w, w), info a 0-d int32 tensor on H's
      device, 0 on success else the failing row + 1.  With ``with_steps``
      also the chase steps the sweeps ran (a sweep over [l, i] is i - l
      steps), a 0-d int32 tensor on H's device.
    """
    if H.is_cuda:
        return gpu_schur.francis(H, Z, m, float(thresh), ilo, max_total_iter,
                                 with_steps)
    return _small_schur_plain(H, Z, m, float(thresh), ilo, max_total_iter,
                              with_steps)
