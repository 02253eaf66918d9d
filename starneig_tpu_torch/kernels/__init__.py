"""Hand-written Hopper kernels: build on first use, bind with ctypes.

The CUDA C++ sources in ``csrc/`` compile with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface.  Each C entry point
launches its kernel on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  Nothing here runs at import: :func:`lib` builds (once per
source content, cached under ``_build/``) and loads the library the first
time a wrapper launches a kernel on a CUDA tensor.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches, and nowhere else, so a run can show which kernels it went
through.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"hess_gemv": 0, "francis": 0, "train_hops": 0, "aed_deflate": 0}

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_SIGNATURES = {
    # M, ld, rows, cols, x, u, trans, scratch, stream
    "hess_gemv": [_P, _LL, _I, _I, _P, _P, _I, _P, _P],
    # Hp, Zp, w, m, ilo, maxiter, thresh, info, stream
    "francis": [_P, _P, _I, _I, _I, _I, _D, _P, _P],
    # wnd, qw, shifts, G, B, WC, HOP, gidx, l_rel, ihi_rel, s0, stream
    "train_hops": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # Tp, Vp, WA, w, s, thresh, stat, stream
    "aed_deflate": [_P, _P, _I, _I, _D, _D, _P, _P],
}

_lib = None
build_seconds = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """Compile csrc/*.cu into one .so keyed by the sources' content."""
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
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
    """The current CUDA stream of tensor t's device, as a raw pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f64(name: str, *tensors):
    """Raise unless every tensor is a contiguous float64 CUDA tensor."""
    import torch
    for t in tensors:
        if not (t.is_cuda and t.dtype == torch.float64 and t.is_contiguous()):
            raise ValueError(f"{name}: needs contiguous float64 CUDA tensors, "
                             f"got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
