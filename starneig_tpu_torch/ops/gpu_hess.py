"""B1, the Hessenberg panel loop's matrix-vector products, and H1, the
whole panel in one launch.

B1 ports ``starneig_tpu/ops/pallas_hess.py`` (the df32 ``_matvec_kernel``
behind ``matvec_df``).  On the H100 f64 is native, so the hi/lo splits,
shadow buffers and lane padding of the TPU version are gone: the kernel
(``kernels/csrc/hess_gemv.cu``) reads the f64 matrix view in place.
:func:`gemv` is its wrapper: for a CPU tensor it computes the plain
version :func:`gemv_plain`; for a CUDA tensor it launches the kernel (or
raises on a layout the kernel does not take).

H1 (``kernels/csrc/hess_panel.cu``) runs the JAX package's panel loop
(``starneig_tpu/ops/hessenberg.py:_panel``, one ``fori_loop`` a panel) as
one cooperative launch.  :func:`panel` is its wrapper, for CUDA tensors
only; ``ops/hessenberg.py:_panel`` calls it on the card and the plain
twin ``panel_factor`` on the CPU.
"""

from __future__ import annotations

import ctypes

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


def panel_grid(n: int, nb: int, t0: int = 0, grid: int = 0):
    """(blocks, work doubles) of an H1 launch on a panel of width nb with
    n - t0 trailing rows: the grid it takes when given none (``grid`` 0),
    or ``grid`` as it is."""
    lib = kernels.lib()
    g, work = ctypes.c_int(grid), ctypes.c_longlong(0)
    kernels.check(lib.hess_panel_grid(n, nb, t0, ctypes.addressof(g),
                                      ctypes.addressof(work)), "hess_panel")
    return g.value, work.value


def panel(A, k: int, nb: int, t0: int = 0, end=None, grid: int = 0):
    """``ops.hessenberg._panel`` on the card: (V, T, Y, P) of columns
    k..k+nb-1 of A (float64 CUDA, n x n, unit column stride; unchanged) in
    one cooperative launch of H1.  ``grid`` (blocks) overrides the
    occupancy's grid; one the card cannot hold at once raises."""
    n = A.shape[0]
    if not (A.is_cuda and A.dtype == torch.float64 and A.dim() == 2
            and A.shape[1] == n and A.stride(1) == 1):
        raise ValueError("panel: needs a square float64 CUDA matrix with unit column stride")
    if not 0 <= t0 <= k or k + nb > n or nb < 1:
        raise ValueError(f"panel: columns {k}..{k + nb - 1} and t0 {t0} outside n={n}")
    lim = n if end is None else int(end)
    V, Y, P = (A.new_zeros((n, nb)) for _ in range(3))
    T = A.new_zeros((nb, nb))
    g, nwork = panel_grid(n, nb, t0, grid)
    work = A.new_empty(nwork)
    lib = kernels.lib()
    kernels.LAUNCHES["hess_panel"] += 1
    kernels.check(lib.hess_panel(
        A.data_ptr(), A.stride(0), n, k, nb, t0, lim, V.data_ptr(), T.data_ptr(),
        Y.data_ptr(), P.data_ptr(), work.data_ptr(), nwork, g,
        kernels.stream_ptr(A)), "hess_panel")
    return V, T, Y, P
