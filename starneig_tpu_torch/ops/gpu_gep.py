"""Wrappers of the GEP kernels G1-G5.

The JAX package runs its GEP path (``ops/hess_triangular.py``,
``ops/qz.py``, ``ops/qz_driver.py``) as XLA ``fori_loop``/``while_loop``
programs with no Pallas kernel; their step counts are serial (about n^2/2
rotation steps for the HT cascade, thousands of chase steps a window).  The
port runs those loops as hand-written CUDA kernels, one launch each (G1,
blocked: a generation call a block of cascades and a sliver call a block,
the deferred updates as products; its window mode a chain launch and a
replay launch).  Each wrapper
here launches its kernel on CUDA tensors and raises on any other; the op
that owns the plain PyTorch twin dispatches on the device:

  wrapper          kernel               dispatcher and plain twin
  ---------------  -------------------  --------------------------------------
  ht_cascade       ht_cascade.cu        ops/hess_triangular.py: ht_reduce,
  (ht_generate,                         ht_blocked with _ht_generate and
   ht_slivers)                          _ht_slivers (oracle: _ht_reduce)
  ht_recondense    ht_recondense.cu     ops/qz_driver.py: aed_recondense_gep,
  (G1's window                          _aed_recondense_gep (stages:
   mode)                                testing/recondense.py)
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
    """Kernel G1: the blocked HT reduction of CUDA tensors (B upper
    triangular): :func:`ht_generate` a block of ``hess_triangular.NB``
    cascades, then :func:`ht_slivers` and the deferred updates as products
    (:func:`starneig_tpu_torch.ops.hess_triangular.ht_blocked`; plain twins
    ``_ht_generate``, ``_ht_slivers``).  Returns new (A, B, Q, Z)."""
    from starneig_tpu_torch.ops.hess_triangular import ht_blocked
    _check_square("ht_cascade", A, B, Q, Z)
    kernels.require_cuda_f64("ht_cascade", *(M.contiguous() for M in (A, B, Q, Z)))
    return ht_blocked(A, B, Q, Z, ht_generate, ht_slivers)


def ht_generate(A, B, rot, J0: int, J1: int):
    """Kernel G1's generation of cascades J0 .. J1-1 on CUDA tensors, in
    place: A's and B's rows J0+1 .. take the cascades' rotations, logged
    into rot (see :func:`starneig_tpu_torch.ops.hess_triangular._ht_generate`)."""
    n = _check_square("ht_generate", A, B)
    kernels.require_cuda_f64("ht_generate", A, B, rot)
    work = A.new_empty(max(n, 1))
    lib = kernels.lib()
    kernels.LAUNCHES["ht_cascade"] += 1
    kernels.check(lib.ht_generate(A.data_ptr(), B.data_ptr(), rot.data_ptr(),
                                  work.data_ptr(), n, int(J0), int(J1),
                                  kernels.stream_ptr(A)),
                  "ht_generate")


def ht_slivers(rot, n: int, J0: int, J1: int, L: int):
    """Kernel G1's sliver factors of block [J0, J1) from the log, CUDA
    tensors only (see
    :func:`starneig_tpu_torch.ops.hess_triangular._ht_slivers`).  Returns
    (S, 2, w, w)."""
    from starneig_tpu_torch.ops.hess_triangular import sliver_windows
    kernels.require_cuda_f64("ht_slivers", rot)
    S, w = len(sliver_windows(n, J0, J1, L)), L + J1 - J0
    if w > 160:
        raise ValueError(f"ht_slivers: a factor of order {w} (L + block) exceeds "
                         "a block's shared memory; at most 160 (nb <= 40)")
    U = rot.new_empty((S, 2, w, w))
    lib = kernels.lib()
    kernels.LAUNCHES["ht_cascade"] += 1
    kernels.check(lib.ht_slivers(rot.data_ptr(), U.data_ptr(), n, int(J0), int(J1),
                                 int(L), S, kernels.stream_ptr(rot)), "ht_slivers")
    return U


def ht_recondense(Sw, Tw, Qw, Zw, s: float, kbot: int, smem_cap: int = 0):
    """Kernel G1 in window mode: the AED spike condensed into beta e1 by the
    cascade's rotation pairs, then the cascade on the leading kbot block,
    on CUDA tensors (see
    :func:`starneig_tpu_torch.ops.qz_driver._aed_recondense_gep`; the
    kernel's stages are :func:`~starneig_tpu_torch.testing.recondense.recondense_chain`
    and :func:`~starneig_tpu_torch.testing.recondense.recondense_replay`): a
    chain launch and a replay launch, whatever kbot.  Tw's leading kbot
    block must be upper triangular.  ``smem_cap`` (bytes, 0: all the card
    allows) caps the shared memory a launch gives to what grows with kbot;
    what does not fit runs from global memory, as at a large kbot (the
    tests lower it to reach those layouts at a small kbot).  Returns (Sw,
    Tw, Qw, Zw, beta), beta a 0-d tensor."""
    WA = _check_square("ht_recondense", Sw, Tw, Qw, Zw)
    if not 0 <= kbot <= WA:
        raise ValueError(f"ht_recondense: kbot {kbot} outside [0, {WA}]")
    S, T, Q, Z = (M.contiguous().clone() for M in (Sw, Tw, Qw, Zw))
    beta = S.new_zeros(1)
    # T's packed leading block and the cascade's vectors where they do not
    # fit shared memory; the log
    t_scratch = S.new_empty(max(kbot * (kbot + 3) // 2 + 5 * kbot, 1))
    log = S.new_empty(max(2 * kbot * (kbot - 1), 1))
    kernels.require_cuda_f64("ht_recondense", S, T, Q, Z)
    lib = kernels.lib()
    kernels.LAUNCHES["ht_recondense"] += 1
    kernels.check(lib.ht_recondense(S.data_ptr(), T.data_ptr(), Q.data_ptr(),
                                    Z.data_ptr(), t_scratch.data_ptr(), log.data_ptr(),
                                    WA, int(kbot), float(s), beta.data_ptr(),
                                    int(smem_cap), kernels.stream_ptr(Sw)),
                  "ht_recondense")
    return S, T, Q, Z, beta[0]


def qz_window(H, T, Q, Z, m: int, thresh_h: float = 0.0, thresh_t: float = 0.0,
              stats=None):
    """Kernel G2: the window QZ machine on the active m x m block of CUDA
    tensors (contract of :func:`starneig_tpu_torch.ops.qz.small_qz`).
    Returns (S, Tt, Q, Z, info); with a ``stats`` dict, also sets
    ``stats["chase_steps"]``, the sweeps' chase steps (a device read)."""
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
    info = torch.zeros(2, dtype=torch.int32, device=H.device)
    kernels.require_cuda_f64("qz_window", Hp, Tp, Qp, Zp)
    lib = kernels.lib()
    kernels.LAUNCHES["qz_window"] += 1
    kernels.check(lib.qz_window(Hp.data_ptr(), Tp.data_ptr(), Qp.data_ptr(),
                                Zp.data_ptr(), w, int(m), float(thresh_h),
                                float(thresh_t), info.data_ptr(),
                                kernels.stream_ptr(H)), "qz_window")
    if stats is not None:
        stats["chase_steps"] = int(info[1])
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
    # one contiguous copy of each window (the caller's views stay as they are)
    S = Sw.clone(memory_format=torch.contiguous_format)
    T = Tw.clone(memory_format=torch.contiguous_format)
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
    Returns (Hw, Tw, Qw, Zw), new tensors; Qw and Zw are transposed views
    (the kernel writes a finished column of each as a contiguous row)."""
    Wb = _check_square("inf_chase", Hw, Tw)
    if not (0 <= jrel < Wb and mrel <= Wb):
        raise ValueError(f"inf_chase: jrel {jrel}, mrel {mrel} outside the window {Wb}")
    Hin, Tin = Hw.contiguous(), Tw.contiguous()
    H, T, QT, ZT = (torch.empty_like(Hin) for _ in range(4))
    kernels.require_cuda_f64("inf_chase", Hin, Tin, H, T, QT, ZT)
    lib = kernels.lib()
    kernels.LAUNCHES["inf_chase"] += 1
    kernels.check(lib.inf_chase(Hin.data_ptr(), Tin.data_ptr(), H.data_ptr(), T.data_ptr(),
                                QT.data_ptr(), ZT.data_ptr(), Wb, int(jrel), int(mrel),
                                int(lrel), kernels.stream_ptr(Hw)), "inf_chase")
    return H, T, QT.t(), ZT.t()
