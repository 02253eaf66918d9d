"""B1: the Hessenberg panel loop's matrix-vector products.

Port of ``starneig_tpu/ops/pallas_hess.py`` (the df32 ``_matvec_kernel``
behind ``matvec_df``).  On the H100 f64 is native, so the hi/lo splits,
shadow buffers and lane padding of the TPU version are gone: the kernel
(``kernels/csrc/hess_gemv.cu``) reads the f64 matrix view in place.

:func:`gemv` is the wrapper: for a CPU tensor it computes the plain
version :func:`gemv_plain`; for a CUDA tensor it launches the kernel (or
raises on a layout the kernel does not take).
"""

from __future__ import annotations

import torch

from starneig_tpu_torch import kernels


def gemv_plain(M, x, trans: bool = False):
    """u = M x (or M^T x): the plain twin of the kernel."""
    return M.T @ x if trans else M @ x


def gemv(M, x, trans: bool = False):
    """u = M x, or M^T x with ``trans``, for a 2-D view M with unit column
    stride (any leading dimension) and a contiguous vector x."""
    if not M.is_cuda:
        return gemv_plain(M, x, trans)
    rows, cols = M.shape
    if M.dtype != torch.float64 or x.dtype != torch.float64 or not x.is_cuda:
        raise ValueError("gemv: needs float64 CUDA tensors")
    if cols > 1 and M.stride(1) != 1:
        raise ValueError("gemv: M needs unit column stride")
    if not x.is_contiguous() or x.shape[0] != (rows if trans else cols):
        raise ValueError("gemv: x must be contiguous and match M")
    if rows == 0 or cols == 0:
        return M.new_zeros(cols if trans else rows)
    u = M.new_empty(cols if trans else rows)
    lib = kernels.lib()
    kernels.LAUNCHES["hess_gemv"] += 1
    kernels.check(lib.hess_gemv(
        M.data_ptr(), M.stride(0), rows, cols, x.data_ptr(), u.data_ptr(),
        int(trans), kernels.stream_ptr(M)), "hess_gemv")
    return u
