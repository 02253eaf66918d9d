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
twin ``panel_factor`` on the CPU.  :func:`panel_plan` splits a launch's
shared memory between the reflector its matvecs read and the columns of
the frozen matrix it keeps there (the rest streamed); it needs no card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


# the shared memory one block may have on an H100 (bytes,
# cudaDevAttrMaxSharedMemoryPerBlockOptin); the wrapper reads the card's
H100_SMEM = 232448


class PanelPlan(NamedTuple):
    """Where an H1 launch keeps what its matvecs read (cs0 = k + 1 rounded
    down to even): v[vs:n) staged in shared memory (v[cs0:vs) read from L2),
    columns [gend, n) of each slab's A[t0:, cs0:] in the block's shared
    memory, [cs0, gend) streamed from HBM every column."""
    grid: int
    rpb: int
    cs0: int
    vs: int
    res_cols: int
    gend: int
    smem_bytes: int
    resident_bytes: int
    streamed_bytes: int


def _fixed_doubles(nv: int, nb: int, rpb: int) -> int:
    """hess_panel.cu's fixed_doubles: the shared doubles before the
    resident columns (nv staged entries of v, six slab vectors, three
    nb-vectors and the column's scalars)."""
    return (((nv + 1) & ~1) + 6 * rpb + 3 * nb + 8 + 1) & ~1


def panel_plan(n: int, k: int, nb: int, t0: int = 0, grid: int = 132,
               smem_budget: int = H100_SMEM) -> PanelPlan:
    """The layout of an H1 launch on ``grid`` blocks within ``smem_budget``
    bytes of shared memory a block: v over [cs0, n) staged where it fits
    beside the fixed scratch, and as many of each slab's right-most columns
    as the rest holds; where it does not fit, only v's right-most entries,
    no resident columns, and v's others read from L2.  Column bounds and
    vs are even (rows and v are read in 16-byte pairs).  Needs no card."""
    rows = n - t0
    rpb = -(-rows // grid)
    cs0 = (k + 1) & ~1
    span = n - cs0
    per_col = 8 * max(rpb, 1)

    def smem(vs, w):
        return 8 * _fixed_doubles(n - vs, nb, rpb) + per_col * (w + (w & 1))
    vs, w = cs0, 0
    if smem(cs0, 0) <= smem_budget:
        w = max(0, min(span, (smem_budget - smem(cs0, 0)) // per_col))
        if w > 0 and (n - w) & 1:
            w -= 1
        while w > 0 and smem(cs0, w) > smem_budget:
            w -= 2
        w = max(w, 0)
    else:
        # only v's right-most entries, as many as the scratch leaves room for
        vs = max(cs0, n - max(0, smem_budget // 8 - _fixed_doubles(0, nb, rpb)))
        vs += vs & 1
        while vs < n and smem(vs, 0) > smem_budget:
            vs += 2
        if vs >= n:
            raise ValueError(f"panel_plan: {smem_budget} bytes of shared memory hold no plan "
                             f"(n={n}, nb={nb}, t0={t0}, grid={grid})")
    gend = n - w
    return PanelPlan(grid, rpb, cs0, vs, w, gend, smem(vs, w), 8 * rows * w,
                     8 * rows * (gend - cs0))


def panel_grid(n: int, nb: int, t0: int = 0, grid: int = 0):
    """(blocks, work doubles, zeroed flags, shared bytes a block may have) of an
    H1 launch on a panel of width nb with n - t0 trailing rows: the grid it
    takes when given none (``grid`` 0), or ``grid`` as it is."""
    lib = kernels.lib()
    g, work = ctypes.c_int(grid), ctypes.c_longlong(0)
    nsync, smem = ctypes.c_int(0), ctypes.c_int(0)
    kernels.check(lib.hess_panel_grid(n, nb, t0, ctypes.addressof(g), ctypes.addressof(work),
                                      ctypes.addressof(nsync), ctypes.addressof(smem)),
                  "hess_panel")
    return g.value, work.value, nsync.value, smem.value


def panel(A, k: int, nb: int, t0: int = 0, end=None, grid: int = 0, smem_budget=None):
    """``ops.hessenberg._panel`` on the card: (V, T, Y, P) of columns
    k..k+nb-1 of A (float64 CUDA, n x n, unit column stride; unchanged) in
    one cooperative launch of H1, on the layout of :func:`panel_plan`.
    ``grid`` (blocks) overrides the SM count, one the card cannot hold at
    once raises; ``smem_budget`` (bytes a block, at most the card's) caps
    the plan."""
    n = A.shape[0]
    if not (A.is_cuda and A.dtype == torch.float64 and A.dim() == 2
            and A.shape[1] == n and A.stride(1) == 1):
        raise ValueError("panel: needs a square float64 CUDA matrix with unit column stride")
    if not 0 <= t0 <= k or k + nb > n or nb < 1:
        raise ValueError(f"panel: columns {k}..{k + nb - 1} and t0 {t0} outside n={n}")
    lim = n if end is None else int(end)
    V, Y, P = (A.new_zeros((n, nb)) for _ in range(3))
    T = A.new_zeros((nb, nb))
    g, nwork, nsync, smax = panel_grid(n, nb, t0, grid)
    plan = panel_plan(n, k, nb, t0, g, smax if smem_budget is None else min(smem_budget, smax))
    work = A.new_empty(nwork)
    sync = torch.zeros(nsync, dtype=torch.int32, device=A.device)
    lib = kernels.lib()
    kernels.LAUNCHES["hess_panel"] += 1
    kernels.check(lib.hess_panel(
        A.data_ptr(), A.stride(0), n, k, nb, t0, lim, V.data_ptr(), T.data_ptr(),
        Y.data_ptr(), P.data_ptr(), work.data_ptr(), nwork, sync.data_ptr(), g,
        plan.res_cols, plan.vs, plan.smem_bytes, kernels.stream_ptr(A)), "hess_panel")
    return V, T, Y, P
