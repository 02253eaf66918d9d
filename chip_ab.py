#!/usr/bin/env python3
"""A/B of hand-written kernel versions on one CUDA card, in turns.

    python3 chip_ab.py francis NAME=path/to/francis_NAME.cu [...]
    python3 chip_ab.py gemv NAME=path/to/hess_gemv_NAME.cu [...]
    python3 chip_ab.py deflate NAME=path/to/aed_deflate_NAME.cu [...]
    python3 chip_ab.py bubble NAME=path/to/reorder_bubble_NAME.cu [...]
    python3 chip_ab.py mainpath ROOT [ROOT ...]

Each extra source is another version of a kernel in ``kernels/csrc/``
(``francis.cu`` B2, ``hess_gemv.cu`` B1, ``aed_deflate.cu`` B4,
``reorder_bubble.cu`` the window bubble) whose C entry point is renamed
to ``ENTRY_NAME`` (for example the parent commit's file, exported under
another symbol); it is compiled beside the repo's kernels, with
``kernels/csrc`` on the include path, and the repo's own version runs as
``cur``.  A B1 version whose entry point takes a ``scratch`` argument
(the earlier two-pass transposed mode) gets a scratch buffer of
ceil(rows / 128) * cols doubles.

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

deflate: every version on ``chip_smoke.DEFLATE_CASES`` against the plain
twin run on the CPU (kbot and fail equal, T and V within 1e-10 relative,
similarity residual < 500 u), then WA=322 at w=322 and w=60 timed in
turns, with the microseconds a swap.

bubble: every version on ``chip_smoke.BUBBLE_CASES`` against the plain
twin run on the CPU (dst, nfail, swaps and the selection equal, T and Q
within 1e-10), then the G=2, W=160 batch timed in turns, with the
microseconds a swap of its longest window.

mainpath: each ROOT (a checkout holding its own ``starneig_tpu_torch``,
such as this repo and an unpacked parent commit) in a process of its
own, in the order given: n=4000 (A from default_rng(0)) through
hessenberg, schur, select(Re > 0) and reorder_schur, timed, then schur
and reorder_schur again under torch.profiler; prints one JSON line a
root with the phase times and each kernel's device total and launches.

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
if sys.argv[1:2] == ["_mainpath_one"]:   # that checkout's package, not this one's
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))

from chip_smoke import (BUBBLE_CASES, DEFLATE_CASES, DEFLATE_S, DEFLATE_TH,  # noqa: E402
                        U, block_eigs, bubble_check, cuda_ms, deflate_check,
                        device_ms, hessenberg_np, tally)
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


def turns(fns, label, fn_of):
    """Time fn_of(f) for every version against the first extra one, in turns
    first, NAME, NAME, first (CUDA events); returns {name: [ms, ...]}."""
    names = list(fns)
    first = names[1] if len(names) > 1 else "cur"
    out = {}
    for name in names:
        if name == first:
            continue
        t = [fn_of(fns[v][0]) for v in (first, name, name, first)]
        print(f"{label}, turns {first}/{name}/{name}/{first}: "
              + " / ".join(f"{x:.3f}" for x in t) + " ms", flush=True)
        out.setdefault(first, []).extend([t[0], t[3]])
        out.setdefault(name, []).extend([t[1], t[2]])
    return out


def run_deflate(fn, T, V, w):
    WA = T.shape[0]
    Tp = T.new_zeros((WA + 4, WA + 4))
    Tp[:WA, :WA] = T
    Vp = T.new_zeros((WA, WA + 4))
    Vp[:, :WA] = V
    stat = torch.zeros(2, dtype=torch.int32, device=T.device)
    kernels.check(fn(Tp.data_ptr(), Vp.data_ptr(), WA, w, DEFLATE_S, DEFLATE_TH,
                     stat.data_ptr(), kernels.stream_ptr(T)), "aed_deflate")
    return Tp[:WA, :WA], Vp[:, :WA], stat[0], stat[1]


def ab_deflate(specs) -> bool:
    from starneig_tpu_torch.ops import schur
    from starneig_tpu_torch.ops.schur import _aed_deflate
    fns = build("aed_deflate", specs)
    dev = torch.device("cuda:0")
    ok, inputs = True, {}
    for label, _WA, w, make in DEFLATE_CASES:
        T, V = make(dev)
        Tc, Vc = T.cpu(), V.cpu()
        with tally(schur, "swap_adjacent", lambda *a: 1) as nsw:
            ref = _aed_deflate(Tc, Vc, DEFLATE_S, w, DEFLATE_TH)
        inputs[label] = (T, V, w, nsw[0])
        for name, (fn, _s) in fns.items():
            out = [x.cpu() for x in run_deflate(fn, T, V, w)]
            try:
                d, res = deflate_check(label, Tc, Vc, out, ref)
                msg = f"max abs err {d:.2e}, similarity residual {res:.1f}u: ok"
            except AssertionError as exc:
                ok, msg = False, f"FAIL ({exc})"
            print(f"{name} {label} ({nsw[0]} swaps): kbot {int(out[2])} fail "
                  f"{int(out[3])}; {msg}", flush=True)
    for label in ("w=322", "w=60"):
        T, V, w, n = inputs[label]
        t = turns(fns, f"B4 {label} ({n} swaps)",
                  lambda f: cuda_ms(lambda: run_deflate(f, T, V, w), 3))
        for name, ms in t.items():
            print(f"  {name}: {min(ms) / n * 1e3:.3f} us a swap", flush=True)
    return ok


def run_bubble(fn, Td, sels, lims):
    """The wrapper ops/gpu_reorder.py:window_bubble around another version."""
    G, W = Td.shape[0], Td.shape[1]
    Tp = Td.new_zeros((G, W + 4, W + 4))
    Tp[:, :W, :W] = Td
    Qp = Td.new_zeros((G, W, W + 4))
    Qp[:, :, :W] = torch.eye(W, dtype=Td.dtype, device=Td.device)
    sel = np.zeros((G, W + 4), np.int32)
    sel[:, :W] = sels
    st = np.zeros((G, 4), np.int32)
    st[:, 0], st[:, 1], st[:, 2] = lims
    sel_d, st_d = torch.from_numpy(sel).to(Td.device), torch.from_numpy(st).to(Td.device)
    kernels.check(fn(Tp.data_ptr(), Qp.data_ptr(), sel_d.data_ptr(), st_d.data_ptr(),
                     G, W, kernels.stream_ptr(Td)), "reorder_bubble")
    host = torch.cat([sel_d, st_d], 1).cpu().numpy()
    st = host[:, W + 4:]
    return (Tp[:, :W, :W], Qp[:, :, :W], host[:, :W].astype(bool),
            st[:, 0], st[:, 1], st[:, 3])


def ab_bubble(specs) -> bool:
    from starneig_tpu_torch.ops.reorder import _window_bubble
    from starneig_tpu_torch.testing.generators import planted_windows
    fns = build("reorder_bubble", specs)
    dev = torch.device("cuda:0")
    ok, timed_case = True, None
    for G, W, seed, lims in BUBBLE_CASES:
        Ts, sels = planted_windows(G, W, seed)
        Td = torch.as_tensor(Ts, device=dev)
        refs = [_window_bubble(torch.as_tensor(Ts[g]), sels[g], lims[0][g], lims[1][g],
                               lims[2][g]) for g in range(G)]
        for name, (fn, _s) in fns.items():
            Tk, Qk, selk, dstk, nfk, nsk = run_bubble(fn, Td, sels, lims)
            msg = "ok"
            try:
                d = max(bubble_check(f"{name} W={W} window {g}", torch.as_tensor(Ts[g]),
                                     (Tk[g].cpu(), Qk[g].cpu(), selk[g], dstk[g], nfk[g],
                                      nsk[g]), refs[g]) for g in range(G))
                msg = f"max abs err {d:.2e}: ok"
            except AssertionError as exc:
                ok, msg = False, f"FAIL ({exc})"
            print(f"{name} G={G} W={W}: swaps {nsk.tolist()}, failed {nfk.tolist()}, "
                  f"dst {dstk.tolist()}; {msg}", flush=True)
            if (G, W) == (2, 160):
                timed_case = (Td, sels, lims, int(nsk.max()))
    Td, sels, lims, nmax = timed_case
    t = turns(fns, f"bubble G=2 W=160 (longest window {nmax} swaps)",
              lambda f: cuda_ms(lambda: run_bubble(f, Td, sels, lims), 3))
    for name, ms in t.items():
        print(f"  {name}: {min(ms) / nmax * 1e3:.3f} us a swap of the longest window",
              flush=True)
    return ok


def mainpath_one(root: str) -> None:
    """In a fresh process: the n=4000 path of the package under root
    (hessenberg, schur, select, reorder_schur) timed, then schur and
    reorder_schur again under torch.profiler: each kernel's device total
    and launches.  Prints one JSON line."""
    import json
    import time
    from torch.profiler import ProfilerActivity, profile
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.convert import from_numpy
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    kernels.lib()
    A = from_numpy(np.random.default_rng(0).standard_normal((4000, 4000)), "cuda")
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    H, Q = sep.hessenberg(A)
    sync()
    t1 = time.perf_counter()
    S, Q2, *_rest, info = sep.schur(H, Q)
    sync()
    t2 = time.perf_counter()
    sel = sep.select(S, lambda lam: lam.real > 0)
    sync()
    t3 = time.perf_counter()
    S2, Q3, m, rinfo = sep.reorder_schur(S, Q2, sel)
    sync()
    t4 = time.perf_counter()
    res = float(torch.linalg.norm(Q3 @ S2 @ Q3.T - A) / torch.linalg.norm(A)) / U
    out = dict(root=root, info=int(info), rinfo=int(rinfo), hessenberg_ms=(t1 - t0) * 1e3,
               schur_ms=(t2 - t1) * 1e3, reorder_ms=(t4 - t3) * 1e3,
               reorder_residual_u=res, kernels={})
    phases = (("schur", lambda: sep.schur(H, Q)),
              ("reorder", lambda: sep.reorder_schur(S, Q2, sel)))
    for phase, fn in phases:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
                out["kernels"][f"{phase}:{name}"] = [
                    e.self_device_time_total / 1e3, e.count]
    print("MAINPATH " + json.dumps(out), flush=True)


def ab_mainpath(roots) -> bool:
    """Each ROOT (a checkout with its own starneig_tpu_torch) in its own
    process, in the order given (parent, change, change, parent)."""
    ok = True
    for root in roots:
        r = subprocess.run([sys.executable, __file__, "_mainpath_one", root],
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("MAINPATH ")]
        if r.returncode != 0 or not lines:
            print(f"{root}: rc {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}",
                  flush=True)
            ok = False
            continue
        print(lines[-1], flush=True)
    return ok


# clock: where a B4 version spends its cycles.  The counters go into
# copies of the sources made here, under kernels/_build/clock; the kernels
# that ship have none.
def _patch(text: str, edits) -> str:
    import re
    for old, new in edits:
        text, n = re.subn(old, lambda _m, new=new: new, text, count=1)
        if n != 1:
            raise RuntimeError(f"clock: the source has changed, no match for {old!r}")
    return text


# the one-thread design (the kernel before the engine): thread 0's cycles
# in the 4x4 load, swap_adjacent by (p, q), the row pass, the column pass,
# the write-back with its barrier, the loop-top barrier and the test steps
ONE_THREAD_EDITS = [
    (r"int\* __restrict__ stat\) \{",
     "int* __restrict__ stat, long long* __restrict__ ctr, double* __restrict__ sink) {\n"
     "  long long clk_[16] = {};\n  const long long tstart = clock64();"),
    (r"  __syncthreads\(\);\n\n  while \(true\) \{",
     "  __syncthreads();\n  long long tl = clock64();\n  while (true) {"),
    (r"(// every thread has read the state before it changes\n)",
     "// every thread has read the state before it changes\n"
     "    const long long t0 = clock64(); clk_[15] += t0 - tl;\n"),
    (r"      __syncthreads\(\);\n      continue;\n",
     "      __syncthreads();\n      tl = clock64(); clk_[12] += tl - t0; clk_[13] += 1;\n"
     "      continue;\n"),
    (r"    // move the block starting at src one position up\n",
     "    long long t1 = t0, t2 = t0;\n"),
    (r"      bool accept = swap_adjacent\(D, p, q, Qs, Dh\);\n",
     "      { double s_ = 0; for (int i_ = 0; i_ < 16; ++i_) s_ += D[i_];\n"
     "        if (s_ == 1234.5678) sink[0] = s_; }\n      t1 = clock64();\n"
     "      bool accept = swap_adjacent(D, p, q, Qs, Dh);\n"),
    (r"      s_accept = accept;\n",
     "      s_accept = accept;\n      t2 = clock64();\n"
     "      { const int k_ = (p - 1) * 2 + (q - 1); clk_[k_] += 1; clk_[4 + k_] += t2 - t1;\n"
     "        clk_[8] += t1 - t0; }\n"),
    (r"(T\[\(a \+ i\) \* WP \+ c\] = o\[i\];\n    \}\n    __syncthreads\(\);\n)",
     "T[(a + i) * WP + c] = o[i];\n    }\n    __syncthreads();\n"
     "    const long long t3 = clock64(); clk_[9] += t3 - t2;\n"),
    (r"(row\[i\] = o\[i\];\n    \}\n    __syncthreads\(\);\n)",
     "row[i] = o[i];\n    }\n    __syncthreads();\n"
     "    const long long t4 = clock64(); clk_[10] += t4 - t3;\n"),
    (r"(      s_steps \+= 1;\n    \}\n    __syncthreads\(\);\n  \})",
     "      s_steps += 1;\n    }\n    __syncthreads();\n"
     "    tl = clock64(); clk_[11] += tl - t4;\n  }"),
    (r"    stat\[1\] = s_fail;\n",
     "    stat[1] = s_fail;\n    clk_[14] = clock64() - tstart;\n"
     "    for (int i_ = 0; i_ < 16; ++i_) ctr[i_] = clk_[i_];\n"),
    (r'extern "C" int aed_deflate\w*\(', 'extern "C" int aed_deflate_clk('),
    (r"double thresh, void\* stat, void\* stream\)",
     "double thresh, void* stat, void* ctr, void* sink, void* stream)"),
    (r"static_cast<int\*>\(stat\)\);",
     "static_cast<int*>(stat), static_cast<long long*>(ctr), static_cast<double*>(sink));"),
]
ONE_THREAD_NAMES = ["n11", "n12", "n21", "n22", "c11", "c12", "c21", "c22", "load", "row",
                    "col", "tail", "test", "ntest", "total", "top"]

# the engine (swap_chain.cuh): the chain warp's cycles in each part of a
# swap and of a segment; clk[5 + k] / clk[9 + k] are swap_adjacent's cycles
# / swaps for (p, q) index k, clk[16] the time inside moves
ENGINE_EDITS = [
    (r"  long long steps = 0, cap = 0;\n",
     "  long long steps = 0, cap = 0;\n  long long clk[24] = {};\n"
     "  __device__ long long tick(int i, long long t) {\n"
     "    long long n = clock64(); clk[i] += n - t; return n; }\n"),
    (r"    drain\(\);\n    bool cont = false;\n",
     "    const long long t0_ = clock64(); long long t_ = t0_; clk[17] += 1;\n"
     "    drain();\n    t_ = tick(0, t_);\n    bool cont = false;\n"),
    (r"      if \(cont\) bar_sync\(kBarNear \+ \(\(posted - 1\) & 1\)\);\n",
     "      t_ = clock64();\n      if (cont) bar_sync(kBarNear + ((posted - 1) & 1));\n"
     "      t_ = tick(1, t_);\n"),
    (r"        \+\+freed;\n      \}\n      const int slot = posted & 1;",
     "        ++freed;\n      }\n      t_ = tick(2, t_);\n      const int slot = posted & 1;"),
    (r"      __syncwarp\(\);\n      int amin = hi, nsw = 0, why;",
     "      __syncwarp();\n      t_ = tick(3, t_); clk[18] += 1;\n      int amin = hi, nsw = 0, why;"),
    (r"        const bool accept = (swap_adjacent\w*)\(D, p, q, Qs, Dh\);",
     "        { double s_ = 0; for (int i_ = 0; i_ < 16; ++i_) s_ += D[i_];\n"
     "          if (s_ == 1234.5) clk[23] += 1; }\n"
     "        t_ = tick(4, t_);\n"
     "        const bool accept = SWAP_FN(D, p, q, Qs, Dh);\n"
     "        if (Qs[0] + Dh[0] == 1234.5) clk[23] += 1;\n"
     "        { const int k_ = (p - 1) * 2 + (q - 1); t_ = tick(5 + k_, t_); clk[9 + k_] += 1; }"),
    (r"        __syncwarp\(\);\n        if \(!accept\) \{ why = kRejected; break; \}",
     "        __syncwarp();\n        t_ = tick(13, t_);\n        if (!accept) { why = kRejected; break; }"),
    (r"      if \(why != kLimit\) return why;\n",
     "      t_ = tick(14, t_);\n"
     "      if (why != kLimit) { clk[16] += clock64() - t0_; return why; }\n"),
]
ENGINE_KERNEL_EDITS = [
    (r'#include "swap_chain.cuh"', '#include "swap_chain_clk.cuh"'),
    (r"double thresh, int\* __restrict__ stat\) \{",
     "double thresh, int* __restrict__ stat, long long* ctr) {\n"
     "  const long long tstart_ = clock64();"),
    (r"    ch\.drain\(\);\n    ch\.stop\(\);\n",
     "    ch.drain();\n    ch.stop();\n"
     "    if (lane == 0) { for (int i_ = 0; i_ < 24; ++i_) ctr[i_] = ch.clk[i_];\n"
     "      ctr[19] = clock64() - tstart_; }\n"),
    (r'extern "C" int aed_deflate\w*\(', 'extern "C" int aed_deflate_clk('),
    (r"double thresh, void\* stat, void\* stream\)",
     "double thresh, void* stat, void* ctr, void* stream)"),
    (r"static_cast<int\*>\(stat\)\);", "static_cast<int*>(stat), static_cast<long long*>(ctr));"),
]


def clock_build(name: str, path: Path):
    """Instrument one B4 version: a one-thread aed_deflate .cu file, or a
    directory holding an engine version (swap_chain.cuh and one
    aed_deflate*.cu).  Returns (ctypes function, is_engine)."""
    import re
    out = kernels.BUILD_DIR / "clock" / name
    out.mkdir(parents=True, exist_ok=True)
    engine = path.is_dir()
    # a version's own common.cuh (an older one keeps the one-thread swap)
    # goes beside it; else kernels/csrc's is found on the include path
    common = (path if engine else path.parent) / "common.cuh"
    if common.exists():
        (out / "common.cuh").write_text(common.read_text())
    if engine:
        eng = (path / "swap_chain.cuh").read_text()
        swap_fn = re.search(r"const bool accept = (swap_adjacent\w*)\(", eng).group(1)
        eng = _patch(eng, ENGINE_EDITS).replace("SWAP_FN", swap_fn)
        (out / "swap_chain_clk.cuh").write_text(eng)
        src = _patch(next(path.glob("aed_deflate*.cu")).read_text(), ENGINE_KERNEL_EDITS)
    else:
        src = _patch(path.read_text(), ONE_THREAD_EDITS)
    (out / "aed_deflate_clk.cu").write_text(src)
    so = out / "clk.so"
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                        "-I", str(kernels.CSRC), "-o", str(so), str(out / "aed_deflate_clk.cu")],
                       capture_output=True, text=True)
    print(f"--- build {name} ({path}): rc {r.returncode}\n"
          + "\n".join(ln for ln in r.stderr.splitlines() if "stack frame" in ln
                      or "registers" in ln), flush=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented {path}:\n{r.stderr[-3000:]}")
    fn = ctypes.CDLL(str(so)).aed_deflate_clk
    fn.argtypes = kernels._SIGNATURES["aed_deflate"][:7] + [_P] * (2 if engine else 3)
    fn.restype = ctypes.c_int
    return fn, engine


def ab_clock(specs) -> bool:
    """clock NAME=PATH ...: the cycle split of each B4 version (PATH a
    one-thread aed_deflate .cu, or a directory with an engine version;
    the repo's own engine runs as "cur") on WA=322 at w=322 and w=60
    (chip_smoke's inputs) and on the real Schur form of a random 322 x 322
    matrix (scipy), whose swaps are mostly (2, 2)."""
    import scipy.linalg
    from chip_smoke import _deflate_case
    dev = torch.device("cuda:0")
    fns = {name: clock_build(name, Path(p)) for name, p in
           [("cur", str(kernels.CSRC))] + [s.split("=", 1) for s in specs]}
    A = np.random.default_rng(2).standard_normal((322, 322))
    Ts, Zs = scipy.linalg.schur(A, output="real")
    cases = [("w=322", *_deflate_case(322, 322, 6, dev), 322),
             ("w=60", *_deflate_case(322, 60, 5, dev), 60),
             ("dense Schur 322", torch.from_numpy(Ts).to(dev), torch.from_numpy(Zs).to(dev),
              322)]
    for label, T, V, w in cases:
        WA = T.shape[0]
        for name, (fn, engine) in fns.items():
            ctr = torch.zeros(24, dtype=torch.int64, device=dev)
            extra = [ctr.data_ptr()] + ([] if engine else
                                        [torch.zeros(1, dtype=torch.float64,
                                                     device=dev).data_ptr()])

            def run(fn=fn, extra=extra):
                Tp, Vp, kbot, fail = run_deflate(
                    lambda *a: fn(*a[:7], *extra, a[7]), T, V, w)
                return kbot, fail
            kbot, fail = run()
            ms = cuda_ms(run, 2)
            c = ctr.cpu().tolist()
            if not engine:
                c = dict(zip(ONE_THREAD_NAMES, c[:16]))
                nsw = sum(c[f"n{k}"] for k in ("11", "12", "21", "22"))
                parts = {"4x4 load": c["load"], "swap_adjacent": sum(
                    c[f"c{k}"] for k in ("11", "12", "21", "22")), "row pass": c["row"],
                    "column pass": c["col"], "write-back and barrier": c["tail"],
                    "loop-top barrier": c["top"], "test steps": c["test"]}
                pq = [(k, c[f"n{k}"], c[f"c{k}"]) for k in ("11", "12", "21", "22")]
                total, extra_info = c["total"], f"{c['ntest']} test steps"
            else:
                nsw = sum(c[9:13])
                parts = {"4x4 and decision": c[4], "swap_adjacent": sum(c[5:9]),
                         "in-block updates and hook": c[13], "drain": c[0],
                         "near-rows wait": c[1], "ring-slot wait": c[2], "block load": c[3],
                         "write-back and post": c[14], "outside moves": c[19] - c[16]}
                pq = [(k, c[9 + i], c[5 + i]) for i, k in enumerate(("11", "12", "21", "22"))]
                total, extra_info = c[19], f"{c[17]} moves, {c[18]} segments"
            print(f"{label} {name}: kbot {int(kbot)} fail {int(fail)}, {ms:.2f} ms, {nsw} "
                  f"swaps, {ms / nsw * 1e3:.3f} us a swap, {extra_info}, "
                  f"{total / (ms * 1e6):.3f} GHz; swaps and swap_adjacent cycles by (p,q): "
                  + ", ".join(f"{k} {n} x {cy / max(n, 1):.0f}" for k, n, cy in pq)
                  + "; cycles a swap: " + ", ".join(f"{k} {v / nsw:.0f}" for k, v in
                                                    parts.items())
                  + f"; total {total / nsw:.0f}", flush=True)
    return True


MODES = {"francis": ab_francis, "gemv": ab_gemv, "deflate": ab_deflate,
         "bubble": ab_bubble, "mainpath": ab_mainpath, "clock": ab_clock}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "_mainpath_one":
        mainpath_one(sys.argv[2])
        return 0
    if len(sys.argv) < 2 or sys.argv[1] not in MODES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ok = MODES[sys.argv[1]](sys.argv[2:])
    print("all checks passed" if ok else "a check FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
