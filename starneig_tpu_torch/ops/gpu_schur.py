"""Wrappers of the Schur solver's window kernels B2, B3, B4 and B5.

Port of ``starneig_tpu/ops/pallas_schur.py``.  The TPU kernels there ran
the serial window work in df32 with the window resident in VMEM; the
H100 kernels (``kernels/csrc/francis.cu``, ``train_hops.cu``,
``aed_deflate.cu``, ``recondense.cu``) run it in native fp64: one thread
block per window (B3: per train, W in shared memory where it fits), and
for B5 a cluster of blocks that split the window's rows.  Each wrapper
here launches its kernel on CUDA tensors and raises on any other.  The op
that owns the plain PyTorch twin dispatches on the device:

  wrapper          kernel            dispatcher and plain twin
  ---------------  ----------------  -----------------------------------------
  francis          francis.cu        ops/small_schur.py: small_schur,
                                     _small_schur_plain
  train_hops       train_hops.cu     ops/schur.py: train_hops, _train_hop
  aed_deflate      aed_deflate.cu    ops/schur.py: aed_deflate, _aed_deflate
  aed_recondense   recondense.cu     ops/schur.py: aed_recondense,
                                     _aed_recondense
"""

from __future__ import annotations

import ctypes

import torch

from starneig_tpu_torch import kernels


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def francis(H, Z, m: int, thresh: float = 0.0, ilo: int = 0,
            max_total_iter: int = 0, with_steps: bool = False):
    """Kernel B2: Francis double-shift QR on the active m x m block of CUDA
    tensors (contract of :func:`starneig_tpu_torch.ops.small_schur.small_schur`).
    Returns (S, Z, info), and with ``with_steps`` also the chase steps the
    sweeps ran (a 0-d int32 tensor on the card, written beside info)."""
    w = H.shape[0]
    if max_total_iter == 0:
        max_total_iter = 30 * w
    Hp = H.new_zeros((w + 2, w + 2))
    Hp[:w, :w] = H
    Zp = H.new_zeros((w, w + 2))
    Zp[:, :w] = Z
    info = torch.zeros(2, dtype=torch.int32, device=H.device)
    kernels.require_cuda_f64("francis", Hp, Zp)
    lib = kernels.lib()
    kernels.LAUNCHES["francis"] += 1
    kernels.check(lib.francis(Hp.data_ptr(), Zp.data_ptr(), w, m, ilo,
                              max_total_iter, float(thresh), info.data_ptr(),
                              kernels.stream_ptr(H)), "francis")
    out = (Hp[:w, :w].contiguous(), Zp[:, :w].contiguous(), info[0])
    return (*out, info[1]) if with_steps else out


def train_hops(Wnds, shifts, gidx, l_rel, ihi_rel, s0, B: int, HOP: int):
    """Kernel B3: advance G bulge trains HOP steps inside their (WC, WC)
    windows, CUDA tensors only.

    ``Wnds`` is (G, WC, WC); train g uses ``shifts[gidx[g]]`` (a (B, 4)
    slice of the (TMAX, B, 4) shift tensor) and the host ints
    ``l_rel[g]``, ``ihi_rel[g]``, ``s0[g]``.  Returns (Wnds2, Qw), Qw the
    (G, WC, WC) window transforms.
    """
    G, WC = Wnds.shape[0], Wnds.shape[1]
    out = Wnds.contiguous().clone()
    Qw = torch.empty_like(out)
    sh = shifts.contiguous()
    kernels.require_cuda_f64("train_hops", out, Qw, sh)
    lib = kernels.lib()
    kernels.LAUNCHES["train_hops"] += 1
    kernels.check(lib.train_hops(
        out.data_ptr(), Qw.data_ptr(), sh.data_ptr(), G, B, WC, HOP,
        _ints(gidx), _ints(l_rel), _ints(ihi_rel), _ints(s0),
        kernels.stream_ptr(Wnds)), "train_hops")
    return out, Qw


def aed_deflate(Tw, Vw, s: float, w: int, thresh: float):
    """Kernel B4: AED spike deflation with block moves on CUDA tensors (see
    :func:`starneig_tpu_torch.ops.schur._aed_deflate`).  Returns
    (T, V, kbot, fail), kbot and fail as 0-d int32 tensors."""
    WA = Tw.shape[0]
    WP = WA + 4
    Tp = Tw.new_zeros((WP, WP))
    Tp[:WA, :WA] = Tw
    Vp = Tw.new_zeros((WA, WP))
    Vp[:, :WA] = Vw
    stat = torch.zeros(2, dtype=torch.int32, device=Tw.device)
    kernels.require_cuda_f64("aed_deflate", Tp, Vp)
    lib = kernels.lib()
    kernels.LAUNCHES["aed_deflate"] += 1
    kernels.check(lib.aed_deflate(Tp.data_ptr(), Vp.data_ptr(), WA, w,
                                  float(s), float(thresh), stat.data_ptr(),
                                  kernels.stream_ptr(Tw)), "aed_deflate")
    return (Tp[:WA, :WA].contiguous(), Vp[:, :WA].contiguous(),
            stat[0], stat[1])


def aed_recondense(Tw, Vw, s: float, kbot: int):
    """Kernel B5: the spike reflector and the Hessenberg re-reduction of
    the leading kbot x kbot block, on CUDA tensors (see
    :func:`starneig_tpu_torch.ops.schur._aed_recondense`).  Returns
    (T, V, beta), beta a 0-d tensor."""
    WA = Tw.shape[0]
    if tuple(Tw.shape) != (WA, WA) or tuple(Vw.shape) != (WA, WA):
        raise ValueError(f"aed_recondense: T {tuple(Tw.shape)} and V "
                         f"{tuple(Vw.shape)} must both be ({WA}, {WA})")
    if not 0 <= kbot <= WA:
        raise ValueError(f"aed_recondense: kbot {kbot} outside [0, {WA}]")
    T = Tw.contiguous().clone()
    V = Vw.contiguous().clone()
    beta = T.new_zeros(1)
    kernels.require_cuda_f64("aed_recondense", T, V)
    lib = kernels.lib()
    kernels.LAUNCHES["recondense"] += 1
    kernels.check(lib.recondense(T.data_ptr(), V.data_ptr(), WA, int(kbot),
                                 float(s), beta.data_ptr(),
                                 kernels.stream_ptr(Tw)), "recondense")
    return T, V, beta[0]
