"""Wrappers of the GEP kernels G1-G5.

The JAX package runs its GEP path (``ops/hess_triangular.py``,
``ops/qz.py``, ``ops/qz_driver.py``) as XLA ``fori_loop``/``while_loop``
programs with no Pallas kernel; their step counts are serial (about n^2/2
rotation steps for the HT cascade, thousands of chase steps a window).  The
port runs those loops as hand-written CUDA kernels, one launch each (G1:
two kernels back to back, the cascade and the Q/Z update).  Each wrapper
here launches its kernel on CUDA tensors and raises on any other; the op
that owns the plain PyTorch twin dispatches on the device:

  wrapper          kernel               dispatcher and plain twin
  ---------------  -------------------  --------------------------------------
  ht_cascade       ht_cascade.cu        ops/hess_triangular.py: ht_reduce,
                                        _ht_reduce
  ht_recondense    ht_cascade.cu        ops/qz_driver.py: aed_recondense_gep,
                   (window mode)        _aed_recondense_gep
  qz_window        qz_window.cu         ops/qz.py: small_qz, _small_qz_plain
  qz_sweep         qz_sweep.cu          ops/qz_driver.py: qz_train_hop,
                                        _qz_train_hop
  aed_deflate_gep  aed_deflate_gep.cu   ops/qz_driver.py: aed_deflate_gep,
                                        _aed_deflate_gep
  inf_chase        inf_chase.cu         ops/qz_driver.py: inf_chase,
                                        _inf_chase_kernel

The pencil reordering's window bubble (G6) has its wrapper beside the SEP
bubble's, in ``ops/gpu_reorder.py``.
"""

from __future__ import annotations

import torch

from starneig_tpu_torch import kernels


def _check_square(name, *Ms):
    n = Ms[0].shape[0]
    for M in Ms:
        if tuple(M.shape) != (n, n):
            raise ValueError(f"{name}: every matrix must be ({n}, {n}), "
                             f"got {tuple(M.shape)}")
    return n


def ht_cascade(A, B, Q, Z):
    """Kernel G1: the interleaved Givens HT cascade on CUDA tensors (see
    :func:`starneig_tpu_torch.ops.hess_triangular._ht_reduce`; B upper
    triangular).  Returns new (A, B, Q, Z)."""
    n = _check_square("ht_cascade", A, B, Q, Z)
    A, B, Q, Z = (M.contiguous().clone() for M in (A, B, Q, Z))
    kernels.require_cuda_f64("ht_cascade", A, B, Q, Z)
    if n <= 2:
        return A, B, Q, Z                 # no rotation: nothing to launch
    rot = A.new_empty(4 * (n - 2) * (n - 1) // 2)
    lib = kernels.lib()
    kernels.LAUNCHES["ht_cascade"] += 1
    kernels.check(lib.ht_cascade(A.data_ptr(), B.data_ptr(), Q.data_ptr(),
                                 Z.data_ptr(), rot.data_ptr(), n,
                                 kernels.stream_ptr(A)), "ht_cascade")
    return A, B, Q, Z


def ht_recondense(Sw, Tw, Qw, Zw, s: float, kbot: int):
    """Kernel G1 in window mode: the AED spike condensed into beta e1 by the
    cascade's rotation pairs, then the cascade on the leading kbot block,
    on CUDA tensors (see
    :func:`starneig_tpu_torch.ops.qz_driver._aed_recondense_gep`).  Returns
    (Sw, Tw, Qw, Zw, beta), beta a 0-d tensor."""
    WA = _check_square("ht_recondense", Sw, Tw, Qw, Zw)
    if not 0 <= kbot <= WA:
        raise ValueError(f"ht_recondense: kbot {kbot} outside [0, {WA}]")
    S, T, Q, Z = (M.contiguous().clone() for M in (Sw, Tw, Qw, Zw))
    beta = S.new_zeros(1)
    kernels.require_cuda_f64("ht_recondense", S, T, Q, Z)
    lib = kernels.lib()
    kernels.LAUNCHES["ht_cascade"] += 1
    kernels.check(lib.ht_recondense(S.data_ptr(), T.data_ptr(), Q.data_ptr(),
                                    Z.data_ptr(), WA, int(kbot), float(s),
                                    beta.data_ptr(), kernels.stream_ptr(Sw)),
                  "ht_recondense")
    return S, T, Q, Z, beta[0]


def qz_window(H, T, Q, Z, m: int, thresh_h: float = 0.0, thresh_t: float = 0.0):
    """Kernel G2: the window QZ machine on the active m x m block of CUDA
    tensors (contract of :func:`starneig_tpu_torch.ops.qz.small_qz`).
    Returns (S, Tt, Q, Z, info)."""
    w = _check_square("qz_window", H, T, Q, Z)
    WP = w + 3
    Hp = H.new_zeros((WP, WP))
    Hp[:w, :w] = H
    Tp = H.new_zeros((WP, WP))
    Tp[:w, :w] = T
    Qp = H.new_zeros((w, WP))
    Qp[:, :w] = Q
    Zp = H.new_zeros((w, WP))
    Zp[:, :w] = Z
    info = torch.zeros(1, dtype=torch.int32, device=H.device)
    kernels.require_cuda_f64("qz_window", Hp, Tp, Qp, Zp)
    lib = kernels.lib()
    kernels.LAUNCHES["qz_window"] += 1
    kernels.check(lib.qz_window(Hp.data_ptr(), Tp.data_ptr(), Qp.data_ptr(),
                                Zp.data_ptr(), w, int(m), float(thresh_h),
                                float(thresh_t), info.data_ptr(),
                                kernels.stream_ptr(H)), "qz_window")
    return (Hp[:w, :w].contiguous(), Tp[:w, :w].contiguous(),
            Qp[:, :w].contiguous(), Zp[:, :w].contiguous(), info[0])


def qz_sweep(Sw, Tw, shifts, l_rel: int, ihi_rel: int, s0: int, B: int,
             HOP: int):
    """Kernel G3: HOP steps of one B-bulge QZ train inside its (WC, WC)
    window pair, CUDA tensors only (see
    :func:`starneig_tpu_torch.ops.qz_driver._qz_train_hop`).  ``shifts`` is
    the train's (B, 4) shift rows.  Returns (Sw2, Tw2, Qw, Zw)."""
    WC = _check_square("qz_sweep", Sw, Tw)
    if WC != 6 * B + 4:
        raise ValueError(f"qz_sweep: window {WC} is not 6 B + 4 = {6 * B + 4}")
    S, T = Sw.contiguous().clone(), Tw.contiguous().clone()
    Qw, Zw = torch.empty_like(S), torch.empty_like(S)
    sh = shifts.contiguous()
    if tuple(sh.shape) != (B, 4):
        raise ValueError(f"qz_sweep: shifts {tuple(sh.shape)} are not ({B}, 4)")
    kernels.require_cuda_f64("qz_sweep", S, T, Qw, Zw, sh)
    lib = kernels.lib()
    kernels.LAUNCHES["qz_sweep"] += 1
    kernels.check(lib.qz_sweep(S.data_ptr(), T.data_ptr(), Qw.data_ptr(),
                               Zw.data_ptr(), sh.data_ptr(), WC, B, HOP,
                               int(l_rel), int(ihi_rel), int(s0),
                               kernels.stream_ptr(Sw)), "qz_sweep")
    return S, T, Qw, Zw


def aed_deflate_gep(Sw, Tw, Qw, Zw, s: float, w: int, thresh: float):
    """Kernel G4: the GEP AED spike test and generalized block moves on CUDA
    tensors (see :func:`starneig_tpu_torch.ops.qz_driver._aed_deflate_gep`).
    Returns (Sw, Tw, Qw, Zw, kbot, fail, steps), the last three 0-d int32
    tensors."""
    WA = _check_square("aed_deflate_gep", Sw, Tw, Qw, Zw)
    WP = WA + 4
    Sp = Sw.new_zeros((WP, WP))
    Sp[:WA, :WA] = Sw
    Tp = Sw.new_zeros((WP, WP))
    Tp[:WA, :WA] = Tw
    Qp = Sw.new_zeros((WA, WP))
    Qp[:, :WA] = Qw
    Zp = Sw.new_zeros((WA, WP))
    Zp[:, :WA] = Zw
    stat = torch.zeros(3, dtype=torch.int32, device=Sw.device)
    kernels.require_cuda_f64("aed_deflate_gep", Sp, Tp, Qp, Zp)
    lib = kernels.lib()
    kernels.LAUNCHES["aed_deflate_gep"] += 1
    kernels.check(lib.aed_deflate_gep(Sp.data_ptr(), Tp.data_ptr(),
                                      Qp.data_ptr(), Zp.data_ptr(), WA, int(w),
                                      float(s), float(thresh), stat.data_ptr(),
                                      kernels.stream_ptr(Sw)), "aed_deflate_gep")
    return (Sp[:WA, :WA].contiguous(), Tp[:WA, :WA].contiguous(),
            Qp[:, :WA].contiguous(), Zp[:, :WA].contiguous(),
            stat[0], stat[1], stat[2])


def inf_chase(Hw, Tw, jrel: int, mrel: int, lrel: int):
    """Kernel G5: the window chase of the infinite push on a (Wb, Wb) CUDA
    window pair (see :func:`starneig_tpu_torch.ops.qz_driver._inf_chase_kernel`).
    Returns (Hw, Tw, Qw, Zw)."""
    Wb = _check_square("inf_chase", Hw, Tw)
    if not (0 <= jrel < Wb and mrel <= Wb):
        raise ValueError(f"inf_chase: jrel {jrel}, mrel {mrel} outside the window {Wb}")
    H, T = Hw.contiguous().clone(), Tw.contiguous().clone()
    Qw, Zw = torch.empty_like(H), torch.empty_like(H)
    kernels.require_cuda_f64("inf_chase", H, T, Qw, Zw)
    lib = kernels.lib()
    kernels.LAUNCHES["inf_chase"] += 1
    kernels.check(lib.inf_chase(H.data_ptr(), T.data_ptr(), Qw.data_ptr(),
                                Zw.data_ptr(), Wb, int(jrel), int(mrel), int(lrel),
                                kernels.stream_ptr(Hw)), "inf_chase")
    return H, T, Qw, Zw
