#!/usr/bin/env python3
"""A/B of hand-written kernel versions on one CUDA card, in turns.

    python3 chip_ab.py francis NAME=path/to/francis_NAME.cu [...]
    python3 chip_ab.py gemv NAME=path/to/hess_gemv_NAME.cu [...]

Each extra source is another version of ``kernels/csrc/francis.cu`` (B2)
or ``kernels/csrc/hess_gemv.cu`` (B1) whose C entry point is renamed to
``francis_NAME`` or ``hess_gemv_NAME`` (for example the parent commit's
file, exported under another symbol); it is compiled beside the repo's
kernels, which run as ``cur``.  A B1 version whose entry point takes a
``scratch`` argument (the earlier two-pass transposed mode) gets a
scratch buffer of ceil(rows / 128) * cols doubles.

francis: every version on the windows of ``CASES`` (info 0, Schur form
error 0, block eigenvalues within 1e-10 |H| of the plain twin run on the
CPU, residual and orthogonality < 500 u), then the w=322 window of
``chip_smoke.py`` timed by CUDA events in turns first, NAME, NAME, first
against the first extra version.

gemv: the transposed mode of every version against ``M.T @ x`` at the
panel loop's shapes, V[:, :j] (4000 rows, ld 288) and T[:j, :j], checked
against ``M.T @ x`` and bit-for-bit across two launches, then timed as a
CUDA graph of 100 calls back to back (device time with the launch gaps of
a graph) and under ``torch.profiler`` (kernel time alone).

Prints the card's name and power limit first; exits nonzero if a check
fails.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import U, block_eigs, cuda_ms, device_ms, hessenberg_np  # noqa: E402
from starneig_tpu_torch import kernels  # noqa: E402

CASES = [(40, 40, 0), (40, 31, 1), (96, 96, 3), (130, 130, 4), (322, 322, 2)]
_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
SCRATCH_GEMV = [_P, _LL, _I, _I, _P, _P, _I, _P, _P]


def build(entry: str, specs):
    """{name: (ctypes function, takes scratch)}: the repo's entry as
    "cur", and each NAME=path compiled into its own library."""
    kernels.build(verbose=True)
    fns = {"cur": (getattr(kernels.lib(), entry), False)}
    jobs = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        so = Path(path).with_suffix(".so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-I", str(kernels.CSRC), "-o", str(so), path]
        jobs[name] = (path, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for name, (path, so, proc) in jobs.items():
        _out, err = proc.communicate()
        print(f"--- build {name} ({path}): rc {proc.returncode}\n{err}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}")
        fn = getattr(ctypes.CDLL(str(so)), f"{entry}_{name}")
        scratch = entry == "hess_gemv" and "void* scratch" in Path(path).read_text()
        fn.argtypes = SCRATCH_GEMV if scratch else kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = (fn, scratch)
    return fns


def run_francis(fn, H, m, th):
    w = H.shape[0]
    Hp = H.new_zeros((w + 2, w + 2))
    Hp[:w, :w] = H
    Zp = H.new_zeros((w, w + 2))
    Zp[:, :w] = torch.eye(w, dtype=H.dtype, device=H.device)
    info = torch.zeros(1, dtype=torch.int32, device=H.device)
    kernels.check(fn(Hp.data_ptr(), Zp.data_ptr(), w, m, 0, 30 * w, float(th),
                     info.data_ptr(), kernels.stream_ptr(H)), "francis")
    return Hp[:w, :w], Zp[:, :w], info


def ab_francis(specs) -> bool:
    from starneig_tpu_torch.ops.small_schur import _small_schur_plain
    from starneig_tpu_torch.testing.hooks import schur_form_error
    fns = build("francis", specs)
    dev = torch.device("cuda:0")
    ok = True
    for w, m, seed in CASES:
        Hn = hessenberg_np(w, seed)
        Hn[m:, :], Hn[:, m:] = 0.0, 0.0
        th = U / 2 * float(np.linalg.norm(Hn))
        Sp, _Zp, ip = _small_schur_plain(torch.from_numpy(Hn),
                                         torch.eye(w, dtype=torch.float64), m, th)
        ref, nh = block_eigs(Sp, m), np.linalg.norm(Hn)
        for name, (fn, _s) in fns.items():
            S, Z, info = run_francis(fn, torch.from_numpy(Hn).to(dev), m, th)
            form = schur_form_error(S)
            Sn, Zn = S.cpu().numpy(), Z.cpu().numpy()
            res = np.linalg.norm(Zn @ Sn @ Zn.T - Hn) / nh / U
            orth = np.linalg.norm(Zn @ Zn.T - np.eye(w)) / np.sqrt(w) / U
            d = float(np.abs(block_eigs(S, m) - ref).max()) / nh
            good = (int(info) == 0 and int(ip) == 0 and form == 0.0 and d < 1e-10
                    and res < 500 and orth < 500)
            ok &= good
            print(f"{name} w={w} m={m}: info {int(info)}, Schur form error {form}, "
                  f"block eigenvalues {d:.2e} |H| from the plain twin, residual "
                  f"{res:.1f}u, orth {orth:.1f}u: {'ok' if good else 'FAIL'}", flush=True)
    Hn = hessenberg_np(322, 2)
    H = torch.from_numpy(Hn).to(dev)
    th = U / 2 * float(np.linalg.norm(Hn))
    names = list(fns)
    first = names[1] if len(names) > 1 else "cur"
    for name in names:
        if name == first:
            continue
        t = [cuda_ms(lambda f=fns[v][0]: run_francis(f, H, 322, th), 3)
             for v in (first, name, name, first)]
        print(f"w=322 window solve, turns {first}/{name}/{name}/{first}: "
              + " / ".join(f"{x:.2f}" for x in t) + " ms", flush=True)
    return ok


def call_gemv(fn, scratch, M, x):
    u = M.new_empty(M.shape[1])
    args = [M.data_ptr(), M.stride(0), M.shape[0], M.shape[1], x.data_ptr(),
            u.data_ptr(), 1]
    if scratch:
        scr = M.new_empty(((M.shape[0] + 127) // 128) * M.shape[1])
        args.append(scr.data_ptr())
    kernels.check(fn(*args, kernels.stream_ptr(M)), "hess_gemv")
    return u


def graph_us(fn, n: int = 100, replays: int = 5) -> float:
    """Microseconds a call from a CUDA graph of n calls back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * replays) * 1e3


def ab_gemv(specs) -> bool:
    fns = build("hess_gemv", specs)
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(1)
    V = torch.randn(4000, 288, generator=g, dtype=torch.float64).to(dev)
    T = torch.randn(288, 288, generator=g, dtype=torch.float64).to(dev)
    a = torch.randn(4000, generator=g, dtype=torch.float64).to(dev)
    shapes = ([(f"V[:, :{j}]", V[:, :j], a) for j in (1, 32, 144, 288)]
              + [(f"T[:{j}, :{j}]", T[:j, :j], a[:j].contiguous()) for j in (32, 144, 288)])
    ok = True
    for sname, M, x in shapes:
        want = M.T @ x
        scale = float((M.abs().T @ x.abs()).max())
        cells = []
        for name, (fn, scr) in fns.items():
            u1, u2 = call_gemv(fn, scr, M, x), call_gemv(fn, scr, M, x)
            good = (torch.equal(u1, u2)
                    and float((u1 - want).abs().max()) <= 1e-12 * scale)
            ok &= good
            f = lambda fn=fn, scr=scr: call_gemv(fn, scr, M, x)   # noqa: E731
            t = [graph_us(f) for _ in range(2)]
            cells.append(f"{name} {t[0]:.2f}/{t[1]:.2f} (profiler "
                         f"{device_ms(f, 200) * 1e3:.2f}){'' if good else ' FAIL'}")
        lib = lambda: torch.mv(M.T, x)              # noqa: E731
        t = [graph_us(lib) for _ in range(2)]
        print(f"{sname}^T x, us a call: M.T @ x {t[0]:.2f}/{t[1]:.2f} (profiler "
              f"{device_ms(lib, 200) * 1e3:.2f}) | " + " | ".join(cells), flush=True)
    return ok


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("francis", "gemv"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ok = (ab_francis if sys.argv[1] == "francis" else ab_gemv)(sys.argv[2:])
    print("all checks passed" if ok else "a check FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
