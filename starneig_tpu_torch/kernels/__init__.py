"""Hand-written Hopper kernels: build on first use, bind with ctypes.

The CUDA C++ sources in ``csrc/`` compile with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface.  Each C entry point
launches its kernel on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  Nothing here runs at import: :func:`lib` builds (once per
source content, cached under ``_build/``) and loads the library the first
time a wrapper launches a kernel on a CUDA tensor.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds, where
it calls its C entry and nowhere else, the kernels that entry launches,
computed on the host from the call's arguments (one for most entries; G1's
generation four a cascade, its window mode a chain and a replay), so a
run's count equals the program's kernels in a device trace.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES = {"hess_gemv": 0, "francis": 0, "train_hops": 0, "aed_deflate": 0,
            "recondense": 0, "reorder_bubble": 0, "ht_cascade": 0,
            "ht_recondense": 0, "qz_window": 0, "qz_sweep": 0, "qz_train": 0,
            "qz_train_far": 0, "aed_deflate_gep": 0, "inf_chase": 0,
            "reorder_bubble_gep": 0, "hess_panel": 0, "eig_backsolve": 0,
            "eig_backsolve_gep": 0}

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_SIGNATURES = {
    # M, ld, rows, cols, x, u, trans, stream
    "hess_gemv": [_P, _LL, _I, _I, _P, _P, _I, _P],
    # Hp, Zp, w, m, ilo, maxiter, thresh, info, stream
    "francis": [_P, _P, _I, _I, _I, _I, _D, _P, _P],
    # wnd, qw, shifts, G, B, WC, HOP, gidx, l_rel, ihi_rel, s0, stream
    "train_hops": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # Tp, Vp, WA, w, s, thresh, stat, stream
    "aed_deflate": [_P, _P, _I, _I, _D, _D, _P, _P],
    # T, V, WA, kbot, s, beta, stream
    "recondense": [_P, _P, _I, _I, _D, _P, _P],
    # Tp, Qp, sel, state, G, W, stream
    "reorder_bubble": [_P, _P, _P, _P, _I, _I, _P],
    # A, B, rot, work, n, J0, J1, stream
    "ht_generate": [_P, _P, _P, _P, _I, _I, _I, _P],
    # A, B, rot, work, n, ld, lo, hi, j, J0, steps, rbase, stream
    "ht_generate_shard": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    # rot, U, n, J0, J1, L, S, rbase, stream
    "ht_slivers": [_P, _P, _I, _I, _I, _I, _I, _LL, _P],
    # S, T, Q, Z, Tscratch, log, WA, kbot, s, beta, stream
    "ht_recondense": [_P, _P, _P, _P, _P, _P, _I, _I, _D, _P, _I, _P],
    # Hp, Tp, Qp, Zp, w, m, thresh_h, thresh_t, info, stream
    "qz_window": [_P, _P, _P, _P, _I, _I, _D, _D, _P, _P],
    # S, T, Qw, Zw, shifts, WC, B, HOP, l_rel, ihi_rel, s0, stream
    "qz_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # S, T, Q, Z, stack, shifts, sync, NP, n, B, l, ihi, H, stream
    "qz_train": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # Sp, Tp, Qp, Zp, WA, w, s, thresh, stat, stream
    "aed_deflate_gep": [_P, _P, _P, _P, _I, _I, _D, _D, _P, _P],
    # Hin, Tin, H, T, QT, ZT, Wb, jrel, mrel, lrel, stream
    "inf_chase": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # Sp, Tp, Qp, Zp, sel, state, G, W, stream
    "reorder_bubble_gep": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # n, nb, t0, grid (int*, in and out), work (long long*, out), sync
    # (int*, out), smem_max (int*, out)
    "hess_panel_grid": [_I, _I, _I, _P, _P, _P, _P],
    # A, lda, n, k, nb, t0, lim, V, T, Y, P, work, work_len, sync, grid,
    # res_cols, vs, smem_bytes, stream
    "hess_panel": [_P, _LL, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _LL, _P, _I, _I, _I, _I,
                   _P],
    # S, n, lam_r, lam_i, smin, pos, pair, kind, order, m, omega, smlnum,
    # xr, xi, close, f0r, f0i, scale, stream
    "eig_backsolve": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _D, _D, _P, _P, _P, _P, _P,
                      _P, _P],
    # S, T, n, ar, ai, bt, smin, pos, pair, kind, order, m, omega, smlnum,
    # xr, xi, close, f0r, f0i, scale, stream
    "eig_backsolve_gep": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _D, _D, _P, _P,
                          _P, _P, _P, _P, _P],
}

_lib = None
build_seconds = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_names() -> frozenset:
    """The names of the ``__global__`` functions ``csrc/`` defines: the
    program's kernels, as a device trace names them (templates without
    their arguments)."""
    import re
    names = set()
    for p in _sources():
        text = re.sub(r"//[^\n]*", "", p.read_text())
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text))
    return frozenset(names)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into one .so keyed by the sources' content: one
    nvcc per source, all started together, then one link."""
    global build_seconds
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libstarneig_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, logs = [], []
    for src, obj, proc in jobs:
        _out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"{src.name} ({proc.returncode}):\n{err}")
    objs = [str(obj) for _s, obj, _p in jobs]
    try:
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for o in objs:
            Path(o).unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print("".join(logs), flush=True)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor t's device, as a raw pointer.

    Read with the raw-stream call PyTorch's own kernel launchers use
    (``torch._inductor`` imports it as ``get_raw_stream``): it skips the
    ``torch.cuda.Stream`` object that ``torch.cuda.current_stream`` builds,
    which costs the panel loop's small launches several microseconds of
    host time each."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda_f64(name: str, *tensors):
    """Raise unless every tensor is a contiguous float64 CUDA tensor."""
    import torch
    for t in tensors:
        if not (t.is_cuda and t.dtype == torch.float64 and t.is_contiguous()):
            raise ValueError(f"{name}: needs contiguous float64 CUDA tensors, "
                             f"got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
