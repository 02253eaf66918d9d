#!/usr/bin/env python3
"""A/B of hand-written kernel versions on one CUDA card, in turns.

    python3 chip_ab.py francis NAME=path/to/francis_NAME.cu [...]
    python3 chip_ab.py gemv NAME=path/to/hess_gemv_NAME.cu [...]
    python3 chip_ab.py deflate NAME=path/to/aed_deflate_NAME.cu [...]
    python3 chip_ab.py bubble NAME=path/to/reorder_bubble_NAME.cu [...]
    python3 chip_ab.py hops NAME=path/to/train_hops_NAME.cu [...]
    python3 chip_ab.py recondense NAME=path/to/recondense_NAME.cu [...]
    python3 chip_ab.py mainpath [--n N] ROOT [ROOT ...]
    python3 chip_ab.py clock [deflate|hops|recondense|qz|qzsweep] [--skip-cur] [NAME=PATH ...]
    python3 chip_ab.py qzinf
    python3 chip_ab.py bitwise [--n N] [--device cpu|cuda] ROOT [ROOT ...]
    python3 chip_ab.py ht [--n N] ROOT [ROOT ...]
    python3 chip_ab.py qz ROOT [ROOT ...]
    python3 chip_ab.py qzsweep ROOT [ROOT ...]

Each extra source is another version of a kernel in ``kernels/csrc/``
(``francis.cu`` B2, ``hess_gemv.cu`` B1, ``aed_deflate.cu`` B4,
``reorder_bubble.cu`` the window bubble, ``train_hops.cu`` B3,
``recondense.cu`` B5) whose C entry point is renamed to ``ENTRY_NAME``
(for example the parent commit's file, exported under another symbol);
it is compiled beside the repo's kernels, with its own directory and
then ``kernels/csrc`` on the include path, and the repo's own version
runs as ``cur``.  A B1 version whose entry point takes a ``scratch`` argument
(the earlier two-pass transposed mode) gets a scratch buffer of
ceil(rows / 128) * cols doubles.

francis: every version on the windows of ``CASES`` (info 0, Schur form
error 0, block eigenvalues within 1e-10 |H| of the plain twin run on the
CPU, residual and orthogonality < 500 u), then the w=322 window of
``chip_smoke.py`` timed by CUDA events in turns first, NAME, NAME, first
against the first extra version.

gemv: the A x mode of every version against ``torch.mv`` at the panel
matvec's 4000 x 4000 and A[1152:, 1152:], a DM rank's 4000 x 2000 shard,
the panel arrays' 4000 x j views (ld 288) and T[:j, :j], checked against
``M @ x`` and bit-for-bit across two launches, then timed by CUDA events
over 50 calls back to back in turns kernel, library, library, kernel and
under ``torch.profiler`` (device time); then the transposed mode against
``M.T @ x`` at V[:, :j] (4000 rows, ld 288) and T[:j, :j], checked the
same way, then timed as a CUDA graph of 100 calls back to back (device
time with the launch gaps of a graph) and under ``torch.profiler`` (kernel
time alone).

deflate: every version on ``chip_smoke.DEFLATE_CASES`` against the plain
twin run on the CPU (kbot and fail equal, T and V within 1e-10 relative,
similarity residual < 500 u), then WA=322 at w=322 and w=60 timed in
turns, with the microseconds a swap.

bubble: every version on ``chip_smoke.BUBBLE_CASES`` against the plain
twin run on the CPU (dst, nfail, swaps and the selection equal, T and Q
within 1e-10), then the G=2, W=160 batch timed in turns, with the
microseconds a swap of its longest window.

hops: every version on ``chip_smoke.HOP_CASES`` (B = 3, 25, 65, 132 with
the zero plants a sweep gives at the introductions, and B = 25 without
them) against the plain twin on the card (``chip_smoke.hop_errors``'
tolerances, the similarity and orthogonality of
``chip_smoke.hop_contract``, the parked train unchanged), bit for bit
against ``cur``, and the plain twin on the card against the CPU; then the
B=25, G=5 hop with the plants timed in turns, as a sweep launches it
(without the parked train).  A version that refuses B > 64 (as the
kernel did before it took any B) is reported there, not failed.

recondense: every version through ``chip_smoke.recondense_checks``
(WA=40, 322 and 802), then WA=322 and WA=802 timed in turns.

mainpath: each ROOT (a checkout holding its own ``starneig_tpu_torch``,
such as this repo and an unpacked parent commit) in a process of its
own, in the order given: size N (default 4000; A from default_rng(0))
through hessenberg, schur, select(Re > 0) and reorder_schur, timed, then
schur and reorder_schur again under torch.profiler; prints one JSON line
a root with the phase times, residual, orthogonality, the AED rounds'
(w, kbot, trains) and each kernel's device total and launches.

clock: where a version spends its cycles (B4 a swap, B3 a chase step,
B5 a reduction step, G2 a chase step and a block of steps, G3 a chase
step), from clock64 counters that literal edits put into a copy of the
source under ``kernels/_build/clock`` (an edit list for each design: the
kernels as they ship, and the one-block B3/B5/G3 and one-thread B4 before
them); the shipped kernels carry no counters.  ``clock qz`` runs G2's
chase warp on ``chip_smoke.py``'s w=162 and w=322 windows and prints its
serial chain (the cycles of a step's reflectors, updates and rotation)
beside the block-level waits.  ``clock qzsweep`` runs G3 on the hop of
``qzsweep`` (the middle hop of a B=12 train at n=200): for the one-block
design thread 0's cycles a step by phase, for the current one each
chase warp's (a bulge's) reflectors, updates, record and barriers, the
largest of each over the chase warps (their sum: the chain a step) and
the update warps' waits, updates and barriers.

qzinf: why G2 (``qz_window.cu``) and its plain twin may end an
infinite-eigenvalue chase at different steps.  On ``chip_smoke.py``'s w=84
window with 8 T-diagonal zeros it runs the shipped kernel, two copies of it
under ``kernels/_build/qzinf`` that print every stop test of the chase
(|T[jc+1, jc+1]|, |T[jc, jc+1]| and the threshold) built once as shipped
and once with ``-fmad=false`` (no fused multiply-adds), and the plain twin
with the same record; prints each version's exact-zero and tiny
(<= 1e-12 max|beta|) beta counts and the first stop test where each
kernel's record departs from the plain twin's.

bitwise: each ROOT's ``api.sep.schur`` of the Hessenberg form of a size-N
(default 200; A from default_rng(0)) matrix on the given device (default
the card) in a process of its own; prints the SHA-256 of the bytes of S,
Q and the eigenvalues of each, and fails unless every ROOT gives the same
bits.  With ``--device cpu`` it needs no card.

qz: each ROOT's G2 on ``chip_smoke.py``'s w=162 window and G4 on its
WA=162 window (the n=2000 path's shapes) in a process of its own, in the
order given (parent, change, change, parent): three runs of each by CUDA
events, G2's contract (info, residual and orthogonality in u), G4's
(kbot, fail, steps), and the SHA-256 of each output.

qzsweep: each ROOT's G3 in a process of its own, in the order given
(parent, change, change, parent), on the middle hop of a B=12 train across
a random n=200 pencil as the driver's sweep cuts it (made here, by the
plain twin on the CPU, and handed to each worker): three runs of 20
launches by CUDA events, the error against the plain twin and the
SHA-256 of the output; then the GEP n=2000 chain's QZ phase timed, and
under ``torch.profiler`` G3's device total and launches, the sweeps' time
(CUDA events around each ``_qz_sweep``) and their device idle share.

ht: each ROOT's G1 (the blocked HT reduction) at size N (default 2000) on
a regular pencil in a process of its own: three runs and the generation
alone by CUDA events, the first four blocks' kernels under
``torch.profiler``, and the SHA-256 of the output (equal digests: the
same bits).

Prints the card's name and power limit first; exits nonzero if a check
fails.  Needs a CUDA card and nvcc (bitwise on the CPU needs neither).
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
# the harness (this checkout's chip_smoke, which imports nothing of the
# package at import time) measures every ROOT alike
from chip_smoke import (BUBBLE_CASES, DEFLATE_CASES, DEFLATE_S, DEFLATE_TH,  # noqa: E402
                        HTWIN_S, HTWIN_WA, INF_CASES, U, block_eigs, bubble_check,
                        cuda_ms, deflate_check, device_ms, hessenberg_np,
                        recondense_gep_contract, tally, timed)

if sys.argv[1:2] == ["_one"]:   # a per-ROOT worker: that checkout's package
    sys.path.insert(0, str(Path(sys.argv[3]).resolve()))

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


def call_gemv(fn, scratch, M, x, trans=True):
    u = M.new_empty(M.shape[1] if trans else M.shape[0])
    args = [M.data_ptr(), M.stride(0), M.shape[0], M.shape[1], x.data_ptr(),
            u.data_ptr(), int(trans)]
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


def gemv_ax_shapes(dev):
    """B1's A x shapes of the panel loop and the DM shard, with their x:
    A (4000 x 4000), a rank's shard A[:, :2000] (contiguous), the trailing
    block A[1152:, 1152:], the tall-thin 4000 x j views of an (n, 288)
    panel array (Y[:, :j], V[:, :j], U[:, :j]) and T[:j, :j] (ld 288)."""
    g = torch.Generator().manual_seed(2)
    A = torch.randn(4000, 4000, generator=g, dtype=torch.float64).to(dev)
    V = torch.randn(4000, 288, generator=g, dtype=torch.float64).to(dev)
    T = torch.randn(288, 288, generator=g, dtype=torch.float64).to(dev)
    x = torch.randn(4000, generator=g, dtype=torch.float64).to(dev)
    return ([("A 4000x4000", A, x), ("shard 4000x2000", A[:, :2000].contiguous(),
                                     x[:2000].contiguous()),
             ("A[1152:, 1152:]", A[1152:, 1152:], x[1152:])]
            + [(f"V[:, :{j}]", V[:, :j], x[:j].contiguous()) for j in (1, 32, 144, 288)]
            + [(f"T[:{j}, :{j}]", T[:j, :j], x[:j].contiguous()) for j in (32, 144, 288)])


def ab_gemv(specs) -> bool:
    fns = build("hess_gemv", specs)
    dev = torch.device("cuda:0")
    ok = True
    # A x against M @ x (torch.mv, cuBLAS): checked and bit for bit across
    # two launches, then CUDA events over 50 calls back to back in turns
    # kernel, library, library, kernel, and profiler device time of 200
    for sname, M, x in gemv_ax_shapes(dev):
        want = M @ x
        scale = float((M.abs() @ x.abs()).max())
        lib = lambda M=M, x=x: torch.mv(M, x)       # noqa: E731
        cells = []
        for name, (fn, scr) in fns.items():
            kern = lambda fn=fn, scr=scr, M=M, x=x: call_gemv(fn, scr, M, x, False)  # noqa: E731
            u1, u2 = kern(), kern()
            good = (torch.equal(u1, u2)
                    and float((u1 - want).abs().max()) <= 1e-12 * scale)
            ok &= good
            t = [cuda_ms(f, 50) for f in (kern, lib, lib, kern)]
            d = ["n/a" if v is None else f"{v * 1e3:.2f}"
                 for v in (device_ms(f, 200) for f in (kern, lib))]
            cells.append(f"{name} {t[0] * 1e3:.2f}/{t[3] * 1e3:.2f} (device "
                         f"{d[0]}), torch.mv {t[1] * 1e3:.2f}/{t[2] * 1e3:.2f} "
                         f"(device {d[1]}){'' if good else ' FAIL'}")
        r, c = M.shape
        bms = 8 * (r * c + r + c) / 3.35e12 * 1e6
        print(f"{sname} A x (ld {M.stride(0)}), us a call, bound {bms:.2f} (bytes): "
              + " | ".join(cells), flush=True)
    g = torch.Generator().manual_seed(1)
    V = torch.randn(4000, 288, generator=g, dtype=torch.float64).to(dev)
    T = torch.randn(288, 288, generator=g, dtype=torch.float64).to(dev)
    a = torch.randn(4000, generator=g, dtype=torch.float64).to(dev)
    shapes = ([(f"V[:, :{j}]", V[:, :j], a) for j in (1, 32, 144, 288)]
              + [(f"T[:{j}, :{j}]", T[:j, :j], a[:j].contiguous()) for j in (32, 144, 288)])
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


def run_hops(fn, W, sh, gidx, lr, ir, s0, B, HOP):
    """The wrapper ops/gpu_schur.py:train_hops around another version;
    returns (W, Qw), or None if the version refuses the launch."""
    from starneig_tpu_torch.ops.gpu_schur import _ints
    out = W.contiguous().clone()
    Qw = torch.empty_like(out)
    rc = fn(out.data_ptr(), Qw.data_ptr(), sh.data_ptr(), W.shape[0], B, W.shape[1], HOP,
            _ints(gidx), _ints(lr), _ints(ir), _ints(s0), kernels.stream_ptr(W))
    if rc != 0:
        return None
    return out, Qw


def ab_hops(specs) -> bool:
    """hops NAME=PATH ...: every B3 version against the plain twin on the
    card at chip_smoke.HOP_CASES (W and Qw within chip_smoke.hop_errors'
    tolerances, the parked train equal, similarity < 1e-13 and
    orthogonality < 1e-12 by chip_smoke.hop_contract), and bit for bit
    against the repo's version; then the (25, 5) hop with the zero plants
    and without its parked train (chip_smoke.hop_launched) timed in turns.  A version that refuses B > 64 (the parent) is
    reported, not failed, there."""
    from chip_smoke import (HOP_CASES, _hop_case, hop_contract, hop_errors, hop_launched,
                            torch_equal_parked)
    from starneig_tpu_torch.ops.schur import _train_hop
    fns = build("train_hops", specs)
    dev = torch.device("cuda:0")
    ok, timed_case = True, None
    for B, G, subdiag in HOP_CASES:
        case = _hop_case(B, G, 11 + B, dev, subdiag)
        W, sh, gidx, lr, ir, s0, B_, HOP = case
        label = f"B={B} G={G}" + (" nonzero subdiagonals" if subdiag else "")
        Wp, Qp = _train_hop(W, sh[gidx], lr, ir, s0, B_, HOP)
        outs = {}
        for name, (fn, _s) in fns.items():
            got = run_hops(fn, *case)
            if got is None:
                good = B > 64 and name != "cur"
                ok &= good
                print(f"{name} {label}: launch refused{'' if good else ' FAIL'}", flush=True)
                continue
            torch.cuda.synchronize()
            outs[name] = got
            ew, eq, tw, tq = hop_errors(case, *got, Wp, Qp)
            parked = torch_equal_parked(W, got[0], lr, ir)
            same = name == "cur" or ("cur" in outs and all(
                torch.equal(a, b) for a, b in zip(got, outs["cur"])))
            sim, orth = hop_contract(W, *got)
            good = (bool((ew <= tw).all()) and bool((eq <= tq).all()) and parked
                    and sim < 1e-13 and orth < 1e-12)
            ok &= good
            print(f"{name} {label}: max err by window (error/tolerance) W "
                  + ", ".join(f"{e:.1e}/{t:.1e}" for e, t in zip(ew.tolist(), tw.tolist()))
                  + "; Qw " + ", ".join(f"{e:.1e}/{t:.1e}" for e, t in
                                        zip(eq.tolist(), tq.tolist()))
                  + f"; similarity {sim:.2e}, orthogonality {orth:.2e}; parked train equal "
                  f"{parked}; bit for bit equal to cur {same}: {'ok' if good else 'FAIL'}",
                  flush=True)
        Wc, Qc = _train_hop(W.cpu(), sh[gidx].cpu(), lr, ir, s0, B_, HOP)
        print(f"plain twin {label}, card against CPU: W "
              f"{float((Wp.cpu() - Wc).abs().max()):.2e}, Qw "
              f"{float((Qp.cpu() - Qc).abs().max()):.2e}", flush=True)
        if (B, G, subdiag) == (25, 5, False):
            timed_case = hop_launched(case)
    t = turns(fns, "B3 hop B=25, 4 trains",
              lambda f: cuda_ms(lambda: run_hops(f, *timed_case), 20))
    for name, ms in t.items():
        print(f"  {name}: {min(ms) / timed_case[-1] * 1e3:.3f} us a step", flush=True)
    return ok


def run_recondense(fn, T, V, kbot, s):
    T, V = T.contiguous().clone(), V.contiguous().clone()
    beta = T.new_zeros(1)
    kernels.check(fn(T.data_ptr(), V.data_ptr(), T.shape[0], int(kbot), float(s),
                     beta.data_ptr(), kernels.stream_ptr(T)), "recondense")
    return T, V, beta[0]


def ab_recondense(specs) -> bool:
    """recondense NAME=PATH ...: every B5 version on chip_smoke's inputs
    (chip_smoke.recondense_checks: the WA=40 input at kbot 10, 1, 0 within
    1e-12 of the plain twin and at kbot 25 to the contract; the B2-solved
    window at WA=322, kbot near 300, within 1e-10 |T| and to the contract;
    at WA=802, kbot near 780, to the contract), then WA=322 and WA=802
    timed in turns."""
    from chip_smoke import recondense_checks
    fns = build("recondense", specs)
    dev = torch.device("cuda:0")
    ok, timed = True, {}
    for name, (fn, _s) in fns.items():
        try:
            _err, cases = recondense_checks(
                dev, lambda T, V, s, kbot, fn=fn: run_recondense(fn, T, V, kbot, s),
                log=lambda *a: print(name, *a, flush=True))
            timed = cases
        except AssertionError as exc:
            ok = False
            print(f"{name}: FAIL ({exc})", flush=True)
    for label, (T, V, kb) in timed.items():
        turns(fns, f"B5 {label} kbot={kb}",
              lambda f: cuda_ms(lambda: run_recondense(f, T, V, kb, 0.3), 5))
    return ok


def run_per_root(mode: str, roots, *args) -> list:
    """Each ROOT's worker for mode (``PER_ROOT[mode]``) in a process of its
    own, in the order given, with that checkout's package first on the
    path; prints and returns the line the worker tags with mode.upper(),
    or None for a worker that failed (its rc and output tails printed)."""
    tag = mode.upper() + " "
    out = []
    for root in roots:
        r = subprocess.run([sys.executable, __file__, "_one", mode, root, *map(str, args)],
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith(tag)]
        if r.returncode != 0 or not lines:
            print(f"{root}: rc {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}",
                  flush=True)
            out.append(None)
            continue
        print(lines[-1], flush=True)
        out.append(lines[-1])
    return out


def mainpath_one(root: str, n: int) -> None:
    """In a fresh process: the size-n path of the package under root
    (hessenberg, schur, select, reorder_schur) timed, then schur and
    reorder_schur again under torch.profiler: each kernel's device total
    and launches, the AED rounds' (w, kbot, trains) where the package logs
    them, residual and orthogonality.  Prints one JSON line."""
    import json
    import time
    from torch.profiler import ProfilerActivity, profile
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.convert import from_numpy
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    kernels.lib()
    A = from_numpy(np.random.default_rng(0).standard_normal((n, n)), "cuda")
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    H, Q = sep.hessenberg(A)
    sync()
    t1 = time.perf_counter()
    stats = {}
    S, Q2, *_rest, info = sep.schur(H, Q, stats=stats)
    sync()
    t2 = time.perf_counter()
    sel = sep.select(S, lambda lam: lam.real > 0)
    sync()
    t3 = time.perf_counter()
    S2, Q3, m, rinfo = sep.reorder_schur(S, Q2, sel)
    sync()
    t4 = time.perf_counter()
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    def gates(S_, Q_):
        res = float(torch.linalg.norm(Q_ @ S_ @ Q_.T - A) / torch.linalg.norm(A)) / U
        return res, float(torch.linalg.norm(Q_ @ Q_.T - eye)) / n ** 0.5 / U
    res, orth = gates(S, Q2)
    rres, rorth = gates(S2, Q3)
    from starneig_tpu_torch.testing.hooks import schur_form_error
    out = dict(root=root, n=n, info=int(info), rinfo=int(rinfo),
               hessenberg_ms=(t1 - t0) * 1e3, schur_ms=(t2 - t1) * 1e3,
               reorder_ms=(t4 - t3) * 1e3, residual_u=res, orthogonality_u=orth,
               schur_form_error=schur_form_error(S), reorder_residual_u=rres,
               reorder_orthogonality_u=rorth, rounds=stats.get("rounds"),
               geometry={k: stats.get(k) for k in ("WA", "NS", "B", "WC", "TMAX")},
               aed_log=stats.get("aed_log"), kernels={})
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


def ab_mainpath(args) -> bool:
    """[--n N] ROOT ...: each ROOT (a checkout with its own
    starneig_tpu_torch) in its own process, in the order given (parent,
    change, change, parent)."""
    n = 4000
    if args[:1] == ["--n"]:
        n, args = int(args[1]), args[2:]
    return None not in run_per_root("mainpath", args, n)


def bitwise_one(root: str, n: int, device: str) -> None:
    """In a fresh process: the SHA-256 of sep.schur's outputs (S, Q, the
    eigenvalues) for the size-n input, with the package under root."""
    import hashlib
    import json
    from starneig_tpu_torch.api import sep
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    A = np.random.default_rng(0).standard_normal((n, n))
    H, Q = sep.hessenberg(A, device=device)
    stats = {}
    outs = sep.schur(H, Q, stats=stats, device=device)
    h = hashlib.sha256()
    for t in outs[:4]:
        h.update(t.contiguous().cpu().numpy().tobytes())
    print("BITWISE " + json.dumps(dict(root=root, n=n, device=device, info=int(outs[4]),
                                       rounds=stats.get("rounds"), sha256=h.hexdigest())),
          flush=True)


def ab_bitwise(args) -> bool:
    """[--n N] [--device cpu|cuda] ROOT ...: every ROOT's sep.schur gives
    the same bits."""
    n, device = 200, "cuda"
    while args[:1] in (["--n"], ["--device"]):
        if args[0] == "--n":
            n = int(args[1])
        else:
            device = args[1]
        args = args[2:]
    lines = run_per_root("bitwise", args, n, device)
    if None in lines:
        return False
    digests = [ln.split('"sha256": ')[1] for ln in lines]
    same = len(set(digests)) == 1
    print(f"bitwise {device} n={n}: {'identical' if same else 'DIFFERENT'}", flush=True)
    return same


def ht_one(root: str, n: int) -> None:
    """In a fresh process: G1 (``gpu_gep.ht_cascade``) of the package under
    root on a regular n-pencil (A Gaussian, B the upper triangle of one,
    seed n, Q = Z = I), three times by CUDA events, then the generation of
    every block alone, then the first four blocks' generation under
    torch.profiler (each kernel's device total and launches), and the
    SHA-256 of the reduction's output.  Prints one JSON line."""
    import hashlib
    import json
    from torch.profiler import ProfilerActivity, profile
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.ops.hess_triangular import NB, _rot_offset, blocks
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((n, n)), device="cuda")
    B = torch.triu(torch.as_tensor(rng.standard_normal((n, n)), device="cuda"))
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    kernels.lib()
    ms = []
    for _ in range(3):
        out, t = timed(lambda: gpu_gep.ht_cascade(A, B, eye, eye))
        ms.append(t)

    def generate(nblk):
        Ag, Bg = A.clone(), B.clone()
        rot = A.new_zeros((_rot_offset(n, n - 2), 4))
        for J0, J1 in blocks(n, NB)[:nblk]:
            gpu_gep.ht_generate(Ag, Bg, rot, J0, J1)
    _, gen_ms = timed(lambda: generate(None))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        generate(4)
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
            kern[name] = [e.self_device_time_total / 1e3, e.count]
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    steps = (n - 2) * (n - 1) // 2
    print("HT " + json.dumps(dict(root=root, n=n, ms=ms, us_a_step=min(ms) / steps * 1e3,
                                  generation_ms=gen_ms, first4_blocks=kern,
                                  sha256=h.hexdigest())), flush=True)


def ab_ht(args) -> bool:
    """[--n N] ROOT ...: each ROOT's G1 in its own process, in the order
    given (parent, change, change, parent); the outputs' digests printed
    beside the times."""
    n = 2000
    if args[:1] == ["--n"]:
        n, args = int(args[1]), args[2:]
    return None not in run_per_root("ht", args, n)


def qz_one(root: str) -> None:
    """In a fresh process: G2 (``gpu_gep.qz_window``) of the package under
    root on chip_smoke's w=162 window and G4 (``gpu_gep.aed_deflate_gep``)
    on its WA=162 window, each three times by CUDA events after a warm-up
    run, with the contract or the counts and the SHA-256 of the output.
    Prints one JSON line."""
    import hashlib
    import json
    from chip_smoke import ht_window_np
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.testing import hooks
    from starneig_tpu_torch.testing.generators import planted_schur_pair
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    dev = torch.device("cuda:0")

    def digest(out):
        h = hashlib.sha256()
        for x in out:
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()
    w = 162
    Hn, Tn = ht_window_np(w, w)
    H, T = (torch.as_tensor(x, device=dev) for x in (Hn, Tn))
    eye = torch.eye(w, dtype=torch.float64, device=dev)
    th, tt = U / 2 * np.linalg.norm(Hn), U / 2 * np.linalg.norm(Tn)
    g2 = gpu_gep.qz_window(H, T, eye, eye, w, th, tt)
    g2_ms = [timed(lambda: gpu_gep.qz_window(H, T, eye, eye, w, th, tt))[1] for _ in range(3)]
    ra, rb = hooks.residual_gep(Hn, Tn, *g2[:4])
    worst = max(ra, rb, hooks.orthogonality(g2[2]), hooks.orthogonality(g2[3]))
    WA = 162
    x = [torch.as_tensor(a, device=dev) for a in planted_schur_pair(WA, WA - 2, WA + 1)]
    thresh = U / 2 * float(torch.linalg.norm(x[0]))
    g4 = gpu_gep.aed_deflate_gep(*x, 1.5e-13, WA - 2, thresh)
    g4_ms = [timed(lambda: gpu_gep.aed_deflate_gep(*x, 1.5e-13, WA - 2, thresh))[1]
             for _ in range(3)]
    print("QZ " + json.dumps(dict(
        root=root, g2_ms=g2_ms, g2_info=int(g2[4]), g2_worst_u=worst,
        g2_sha256=digest(g2[:4]), g4_ms=g4_ms, g4_kbot_fail_steps=[int(v) for v in g4[4:]],
        g4_sha256=digest(g4[:4]))), flush=True)


def ab_qz(args) -> bool:
    """ROOT ...: each ROOT's G2 and G4 in its own process, in the order
    given (parent, change, change, parent)."""
    return None not in run_per_root("qz", args)


QZSWEEP_N, QZSWEEP_B = 200, 12


def qzsweep_inputs(path: Path):
    """chip_ab qzsweep's hop: the middle hop (every bulge active) of one
    B=12 train across a random n=200 pencil, as the driver's sweep cuts it
    (testing.generators.qz_train_hops, the plain twin on the CPU), saved to
    path for the per-ROOT workers."""
    from starneig_tpu_torch.testing.generators import qz_train_hops
    hops, sh = qz_train_hops(QZSWEEP_N, QZSWEEP_B, 13)
    Sw, Tw, l_rel, ihi_rel, s0 = hops[len(hops) // 2]
    torch.save(dict(Sw=Sw, Tw=Tw, sh=sh, l_rel=l_rel, ihi_rel=ihi_rel, s0=s0), path)


def qzsweep_one(root: str, path: str) -> None:
    """In a fresh process: G3 (``gpu_gep.qz_sweep``) of the package under
    root on the saved hop, three runs of 20 launches by CUDA events after a
    warm-up, its error against the plain twin on the CPU and the SHA-256 of
    its output; then the GEP n=2000 chain's QZ phase (known_spectrum_pencil(
    2000, 0.3, 0.1, seed 0), api.gep.hessenberg_triangular then api.gep.schur)
    timed, and again under torch.profiler: G3's device total and launches,
    the sweeps' time by CUDA events around each _qz_sweep call, and the
    device idle share of the sweeps (1 - G3's device time / their time).
    Prints one JSON line."""
    import hashlib
    import json
    from chip_smoke import profiled_kernels
    from starneig_tpu_torch.api import gep
    from starneig_tpu_torch.ops import gpu_gep, qz_driver
    from starneig_tpu_torch.testing.generators import known_spectrum_pencil
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    dev = torch.device("cuda:0")
    d = torch.load(path)
    B, HOP = QZSWEEP_B, 3 * QZSWEEP_B
    args = (d["Sw"].to(dev), d["Tw"].to(dev), d["sh"].to(dev), d["l_rel"], d["ihi_rel"],
            d["s0"], B, HOP)
    out = gpu_gep.qz_sweep(*args)
    ms = [cuda_ms(lambda: gpu_gep.qz_sweep(*args), 20) for _ in range(3)]
    want = qz_driver._qz_train_hop(d["Sw"], d["Tw"], d["sh"], d["l_rel"], d["ihi_rel"],
                                   d["s0"], B, HOP)
    err = max(float((g.cpu() - w).abs().max()) / float(w.abs().max())
              for g, w in zip(out, want))
    h = hashlib.sha256()
    for x in out:
        h.update(x.contiguous().cpu().numpy().tobytes())
    A_np, B_np, _al, _be = known_spectrum_pencil(2000, complex_ratio=0.3, inf_ratio=0.1,
                                                 seed=0)
    A, Bm = (torch.as_tensor(x, device=dev) for x in (A_np, B_np))
    H, T, Q, Z = gep.hessenberg_triangular(A, Bm)
    stats = {}
    res, qz_ms = timed(lambda: gep.schur(H, T, Q, Z, stats=stats))
    sweep_ms = [0.0]
    orig = qz_driver._qz_sweep

    def timed_sweep(*a, **kw):
        sweep_ms[0] += timed(lambda: orig(*a, **kw))[1]
    qz_driver._qz_sweep = timed_sweep
    try:
        _, prof, prof_ms = profiled_kernels(lambda: gep.schur(H, T, Q, Z))
    finally:
        qz_driver._qz_sweep = orig
    g3 = [v for k, v in prof.items() if "qz_sweep_kernel" in k]
    g3_ms, g3_n = sum(v[0] for v in g3), sum(v[1] for v in g3)
    print("QZSWEEP " + json.dumps(dict(
        root=root, hop_ms=ms, us_a_step=min(ms) / HOP * 1e3, hop_rel_err=err,
        sha256=h.hexdigest(), n2000=dict(
            info=int(res[7]), rounds=stats["rounds"], qz_ms=qz_ms, qz_ms_profiled=prof_ms,
            g3_device_ms=g3_ms, g3_launches=g3_n, sweeps_ms=sweep_ms[0],
            sweep_idle_share=1.0 - g3_ms / sweep_ms[0] if sweep_ms[0] else None))),
        flush=True)


def ab_qzsweep(args) -> bool:
    """ROOT ...: each ROOT's G3 hop and n=2000 QZ phase in its own process,
    in the order given (parent, change, change, parent)."""
    path = kernels.BUILD_DIR / "qzsweep_hop.pt"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    qzsweep_inputs(path)
    return None not in run_per_root("qzsweep", args, path)


def _digest(out) -> str:
    import hashlib
    h = hashlib.sha256()
    for x in out:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def gep_qz_profile(dev, keys):
    """The GEP n=2000 chain's QZ phase (known_spectrum_pencil(2000, 0.3,
    0.1, seed 0) after api.gep.hessenberg_triangular) and the n=512
    infinite-rich one (tests/test_qz_driver.py's pencil) timed by CUDA
    events, then each again under torch.profiler: {label: (device ms,
    launches)} of the kernels whose names hold each key, info and rounds."""
    from chip_smoke import profiled_kernels
    from starneig_tpu_torch.api import gep
    from starneig_tpu_torch.testing.generators import known_spectrum_pencil
    A_np, B_np, _al, _be = known_spectrum_pencil(2000, complex_ratio=0.3, inf_ratio=0.1,
                                                 seed=0)
    A, Bm = (torch.as_tensor(x, device=dev) for x in (A_np, B_np))
    H, T, Q, Z = gep.hessenberg_triangular(A, Bm)
    n = 512
    rng = np.random.default_rng(21)
    H0 = np.triu(rng.standard_normal((n, n)), -1)
    T0 = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    for j in rng.choice(np.arange(1, n - 1), size=n // 10, replace=False):
        T0[j, j] = 0.0
    H0, T0 = (torch.as_tensor(x, device=dev) for x in (H0, T0))
    res = {}
    for name, fn in (("n2000", lambda st: gep.schur(H, T, Q, Z, stats=st)),
                     ("n512_inf", lambda st: gep.schur(H0, T0, stats=st))):
        stats = {}
        out, qz_ms = timed(lambda: fn(stats))
        _, prof, prof_ms = profiled_kernels(lambda: fn({}))
        dev_tot = {}
        for label, key in keys.items():
            hits = [v for k, v in prof.items() if any(kk in k for kk in key)]
            dev_tot[label] = (sum(v[0] for v in hits), sum(v[1] for v in hits))
        res[name] = dict(info=int(out[7]), rounds=stats["rounds"],
                         inf_rounds=stats["inf_rounds"], qz_ms=qz_ms,
                         qz_ms_profiled=prof_ms, device=dev_tot)
    return res


def htwin_one(root: str) -> None:
    """In a fresh process: G1's window mode (``gpu_gep.ht_recondense``) of
    the package under root on chip_smoke's planted windows at WA = 84, 162
    and 322 (kbot = WA - 4, s = 0.37): three runs of 5 launches by CUDA
    events after a warm-up, the recondense contract, the SHA-256 of the
    output, and at kbot = 10 the error against _aed_recondense_gep on the
    CPU; then gep_qz_profile: the n=2000 and n=512 QZ phases with the
    window mode's and G5's device totals and launches.  Prints one JSON
    line, then fails where a window misses the smoke's gates (similarity
    below 1e-13, the structure exact, the spike tail below 1e-14 WA, beta
    within 1e-13, 1e-12 at kbot = 10) or a QZ phase's info is not 0."""
    import json
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.ops.qz_driver import _aed_recondense_gep
    from starneig_tpu_torch.testing.generators import planted_schur_pair
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    dev = torch.device("cuda:0")
    kernels.lib()
    out = {}
    for WA in HTWIN_WA:
        npx = planted_schur_pair(WA, WA, WA)
        x = [torch.as_tensor(a, device=dev) for a in npx]
        kbot = WA - 4
        got = gpu_gep.ht_recondense(*x, HTWIN_S, kbot)
        ms = [cuda_ms(lambda: gpu_gep.ht_recondense(*x, HTWIN_S, kbot), 5) for _ in range(3)]
        g10 = gpu_gep.ht_recondense(*x, HTWIN_S, 10)
        w10 = _aed_recondense_gep(*(a.cpu() for a in x), HTWIN_S, 10)
        err10 = max(float((g.cpu() - w).abs().max()) / float(w.abs().max())
                    for g, w in zip(g10[:4], w10[:4]))
        steps = (kbot - 1) * kbot // 2
        out[f"WA={WA}"] = dict(kbot=kbot, ms=ms, us_a_pair=min(ms) / steps * 1e3,
                               contract=recondense_gep_contract(*npx, HTWIN_S, kbot, got),
                               err_kbot10=err10, sha256=_digest(got))
    qz = gep_qz_profile(dev, {"G1 window": ("ht_window_kernel", "ht_win_"),
                              "G5": ("inf_chase_kernel",)})
    print("HTWIN " + json.dumps(dict(root=root, windows=out, qz=qz)), flush=True)
    bad = [k for k, w in out.items()
           if not (w["contract"][0] < 1e-13 and w["contract"][1] == 0.0
                   and w["contract"][2] < 1e-14 and w["contract"][3] <= 1e-13
                   and w["err_kbot10"] <= 1e-12)]
    bad += [k for k, r in qz.items() if r["info"] != 0]
    if bad:
        raise SystemExit(f"htwin: {root} misses the gates at {bad}")


def ab_htwin(args) -> bool:
    """ROOT ...: each ROOT's G1 window mode and the QZ phases in its own
    process, in the order given (parent, change, change, parent)."""
    return None not in run_per_root("htwin", args)


def infchase_one(root: str) -> None:
    """In a fresh process: G5 (``gpu_gep.inf_chase``) of the package under
    root on chip_smoke.INF_CASES: three runs of 20 launches by CUDA events
    after a warm-up, the error against _inf_chase_kernel on the CPU, the
    exact zero and structure, and the SHA-256 of the output.  Prints one
    JSON line, then fails where a window misses the smoke's gates (1e-12
    max|M|, the zero and the structure exact)."""
    import json
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.ops.qz_driver import _inf_chase_kernel
    from starneig_tpu_torch.testing import hooks
    from starneig_tpu_torch.testing.generators import inf_push_window
    assert Path(kernels.__file__).is_relative_to(Path(root).resolve()), kernels.__file__
    dev = torch.device("cuda:0")
    kernels.lib()
    out = []
    for Wb, jrel, mrel, lrel in INF_CASES:
        H, T = (torch.as_tensor(x, device=dev) for x in inf_push_window(Wb, Wb + jrel, jrel, lrel))
        got = gpu_gep.inf_chase(H, T, jrel, mrel, lrel)
        ms = [cuda_ms(lambda: gpu_gep.inf_chase(H, T, jrel, mrel, lrel), 20) for _ in range(3)]
        want = _inf_chase_kernel(H.cpu(), T.cpu(), jrel, mrel, lrel)
        err = max(float((g.cpu() - w).abs().max()) / float(w.abs().max())
                  for g, w in zip(got, want))
        Tk = got[1].cpu()
        exact = (float(Tk[mrel - 1, mrel - 1]) == 0.0
                 and hooks.triangular_structure_error(Tk) == 0.0
                 and hooks.hessenberg_structure_error(got[0]) == 0.0)
        steps = max(mrel - 1 - jrel, 0)
        out.append(dict(case=[Wb, jrel, mrel, lrel], ms=ms, steps=steps,
                        us_a_step=min(ms) / steps * 1e3 if steps else None, err=err,
                        exact=exact, sha256=_digest(got)))
    print("INFCHASE " + json.dumps(dict(root=root, cases=out)), flush=True)
    bad = [c["case"] for c in out if not (c["err"] <= 1e-12 and c["exact"])]
    if bad:
        raise SystemExit(f"infchase: {root} misses the gates at {bad}")


def ab_infchase(args) -> bool:
    """ROOT ...: each ROOT's G5 in its own process, in the order given
    (parent, change, change, parent)."""
    return None not in run_per_root("infchase", args)


# clock: where a kernel version spends its cycles.  The counters go into
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


def clock_deflate(specs) -> bool:
    """clock [deflate] NAME=PATH ...: the cycle split of each B4 version (PATH a
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


def _lit(text: str, edits) -> str:
    """_patch with literal strings."""
    import re
    return _patch(text, [(re.escape(a), b) for a, b in edits])


_TK = ("#define TK(i) { const long long n_ = clock64(); clk_[i] += n_ - tc_; "
       "tc_ = n_; }\n")

# B3 in its one-block design (the kernel before this PR's redesign):
# thread 0's cycles a step in the loop-top barrier, the reflectors, the
# barrier after them, the left update, its barrier, the plants, their
# barrier, and the right update of W and of Qw (split into two loops here)
HOPS_ONE_BLOCK_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + _TK),
    ("const double* __restrict__ shifts, HopParams prm) {\n",
     "const double* __restrict__ shifts, HopParams prm,\n"
     "                  long long* __restrict__ ctr) {\n"
     "  long long clk_[12] = {}; long long tc_ = clock64(); const long long t0_ = tc_;\n"),
    ("(e % (WC + 1) == 0) ? 1.0 : 0.0;\n", "(e % (WC + 1) == 0) ? 1.0 : 0.0;\n  TK(9)\n"),
    ("    const int s = s0 + t;\n    __syncthreads();\n",
     "    const int s = s0 + t;\n    __syncthreads();\n    TK(0)\n"),
    ("      s_use3[b] = use3;\n    }\n    __syncthreads();\n",
     "      s_use3[b] = use3;\n    }\n    TK(1)\n    __syncthreads();\n    TK(2)\n"),
    ("      p[2 * WC] = r2 - (tau * v2) * sum;\n    }\n    __syncthreads();\n",
     "      p[2 * WC] = r2 - (tau * v2) * sum;\n    }\n    TK(3)\n    __syncthreads();\n    TK(4)\n"),
    ("      if (s_use3[b]) W[(kc + 2) * WC + kc - 1] = 0.0;\n    }\n    __syncthreads();\n",
     "      if (s_use3[b]) W[(kc + 2) * WC + kc - 1] = 0.0;\n    }\n    TK(5)\n"
     "    __syncthreads();\n    TK(6)\n"),
    ("    for (int e = tid; e < 2 * WC * B; e += nt) {\n"
     "      const int half = e / (WC * B), rem = e % (WC * B);\n",
     "    for (int half = 0; half < 2; ++half) {\n"
     "    for (int e = tid; e < WC * B; e += nt) {\n      const int rem = e;\n"),
    ("      p[2] -= ts * v2;\n    }\n",
     "      p[2] -= ts * v2;\n    }\n    if (half == 0) TK(7) else TK(8)\n    }\n"),
    ("    }\n  }\n}\n\n}  // namespace",
     "    }\n  }\n  if (tid == 0) {\n    clk_[10] = clock64() - t0_; clk_[11] = HOP;\n"
     "    for (int i_ = 0; i_ < 12; ++i_) ctr[g * 32 + i_] = clk_[i_];\n  }\n}\n\n}  // namespace"),
    ('extern "C" int train_hops(', 'extern "C" int train_hops_clk('),
    ("void* stream) {", "void* ctr, void* stream) {"),
    ("static_cast<const double*>(shifts), prm);",
     "static_cast<const double*>(shifts), prm, static_cast<long long*>(ctr));"),
]
HOPS_ONE_BLOCK_NAMES = ["loop-top barrier", "reflectors", "barrier", "left update", "barrier ",
                        "plants", "barrier  ", "W right update", "Qw right update"]

# B5 in its one-block design: thread 0's cycles a step in the dlarfg (the
# column copy and block_householder with its barriers), the column pass, its
# barrier, the row pass, its barrier, and the plants with their barrier
RECONDENSE_ONE_BLOCK_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + _TK),
    ("int lo, int m, int c0) {\n",
     "int lo, int m, int c0, long long* clk_) {\n  long long tc_ = clock64();\n"),
    ("    for (int i = 0; i < m; ++i) col[(size_t)i * WA] -= tau * (v[i] * w);\n  }\n"
     "  __syncthreads();\n",
     "    for (int i = 0; i < m; ++i) col[(size_t)i * WA] -= tau * (v[i] * w);\n  }\n"
     "  TK(1)\n  __syncthreads();\n  TK(2)\n"),
    ("    for (int j = lane; j < m; j += 32) row[j] -= tau * (y * v[j]);\n  }\n"
     "  __syncthreads();\n}",
     "    for (int j = lane; j < m; j += 32) row[j] -= tau * (y * v[j]);\n  }\n"
     "  TK(3)\n  __syncthreads();\n  TK(4)\n}"),
    ("int kbot, double s, double* __restrict__ beta_out) {\n",
     "int kbot, double s, double* __restrict__ beta_out,\n"
     "                  long long* __restrict__ ctr) {\n"
     "  long long clk_[8] = {}; long long tc_ = clock64(); const long long t0_ = tc_;\n"),
    ("  apply_both(T, V, WA, s_v, tau, 0, kbot, 0);\n",
     "  apply_both(T, V, WA, s_v, tau, 0, kbot, 0, clk_);\n"),
    ("    const int lo = j + 1, m = kbot - lo;\n",
     "    tc_ = clock64();\n    const int lo = j + 1, m = kbot - lo;\n"),
    ("    block_householder(s_v, m, s_red, tau, b);\n",
     "    block_householder(s_v, m, s_red, tau, b);\n    TK(0)\n"),
    ("    if (tau != 0.0) apply_both(T, V, WA, s_v, tau, lo, m, lo);\n",
     "    if (tau != 0.0) apply_both(T, V, WA, s_v, tau, lo, m, lo, clk_);\n"
     "    tc_ = clock64();\n"),
    ("      T[(size_t)(lo + i) * WA + j] = i == 0 ? b : 0.0;\n    __syncthreads();\n  }\n}",
     "      T[(size_t)(lo + i) * WA + j] = i == 0 ? b : 0.0;\n    __syncthreads();\n"
     "    TK(5)\n    clk_[6] += 1;\n  }\n"
     "  if (tid == 0) {\n    clk_[7] = clock64() - t0_;\n"
     "    for (int i_ = 0; i_ < 8; ++i_) ctr[i_] = clk_[i_];\n  }\n}"),
    ('extern "C" int recondense(', 'extern "C" int recondense_clk('),
    ("void* beta, void* stream) {", "void* beta, void* ctr, void* stream) {"),
    ("static_cast<double*>(beta));",
     "static_cast<double*>(beta), static_cast<long long*>(ctr));"),
]
RECONDENSE_ONE_BLOCK_NAMES = ["dlarfg", "column pass", "barrier", "row pass", "barrier ",
                              "plants and barrier"]


# the counters of the current designs, inserted by the edits below: the
# entry point takes a counter pointer before its stream, and the counting
# thread's SN_CLK(i) adds the cycles since its last mark to slot i; slot 30
# counts steps where the kernel does, slot 31 is the total
CLK_MACROS = """
#define SN_CLK_PARAM , void* sn_ctr
#define SN_CLK_KPARAM , long long* __restrict__ sn_ctr
#define SN_CLK_ARG , static_cast<long long*>(sn_ctr)
#define SN_CLK_FWD , sn_ctr
#define SN_CLK_DECL long long sn_clk_[32] = {}; long long sn_tc_ = clock64(); \\
  const long long sn_t0_ = sn_tc_;
#define SN_CLK(i) { const long long n_ = clock64(); sn_clk_[i] += n_ - sn_tc_; sn_tc_ = n_; }
#define SN_CLK_ADD(i, v) sn_clk_[i] += (v);
#define SN_CLK_OUT(base, lo, hi) { sn_clk_[31] = clock64() - sn_t0_; \\
  for (int i_ = (lo); i_ < (hi); ++i_) sn_ctr[(base) + i_] = sn_clk_[i_]; }
"""

# B3 as it ships (the chase group and the Qw group): each group's first
# thread, a step: the ring-slot wait, the reflectors, the left update, the
# plants and W's right update with a group barrier after each; Qw's wait for
# a slot, its right update and its barrier
HOPS_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + CLK_MACROS),
    ("int* s_posted, const int* s_freed) {", "int* s_posted, const int* s_freed SN_CLK_KPARAM) {"),
    ("ihi_rel = prm.ihi_rel[g], s0 = prm.s0[g];\n",
     "ihi_rel = prm.ihi_rel[g], s0 = prm.s0[g];\n  SN_CLK_DECL\n"),
    ("// the slot is free\n", "// the slot is free\n    SN_CLK(0)\n"),
    ("    __threadfence_block();\n    group_sync(kBarChase);\n",
     "    __threadfence_block();\n    SN_CLK(1)\n    group_sync(kBarChase);\n    SN_CLK(2)\n"),
    ("ref, warp, lane);\n    group_sync(kBarChase);\n",
     "ref, warp, lane);\n    SN_CLK(3)\n    group_sync(kBarChase);\n    SN_CLK(4)\n"),
    ("kc - 1] = 0.0;\n    }\n    group_sync(kBarChase);\n",
     "kc - 1] = 0.0;\n    }\n    SN_CLK(5)\n    group_sync(kBarChase);\n    SN_CLK(6)\n"),
    ("                             warp, lane);\n    group_sync(kBarChase);\n  }\n",
     "                             warp, lane);\n    SN_CLK(7)\n    group_sync(kBarChase);\n"
     "    SN_CLK(8)\n  }\n  if (tid == 0) {\n    SN_CLK_OUT(g * 32, 0, 10)\n"
     "    SN_CLK_OUT(g * 32, 31, 32)\n  }\n"),
    ("HopParams prm) {", "HopParams prm SN_CLK_KPARAM) {"),
    ("&s_posted, &s_freed);", "&s_posted, &s_freed SN_CLK_FWD);"),
    ("&s_posted, &s_freed);", "&s_posted, &s_freed SN_CLK_FWD);"),
    ("lane = tq & 31;\n", "lane = tq & 31;\n    SN_CLK_DECL\n"),
    ("      wait_until(&s_posted, t + 1);\n", "      wait_until(&s_posted, t + 1);\n      SN_CLK(10)\n"),
    ("      group_sync(kBarUpd);", "      SN_CLK(11)\n      group_sync(kBarUpd);"),
    ("the slot is read\n", "the slot is read\n      SN_CLK(12)\n"),
    ("(&s_freed) = t + 1;\n      }\n    }\n",
     "(&s_freed) = t + 1;\n      }\n    }\n    if (tq == 0) { SN_CLK_OUT(g * 32, 10, 20) }\n"),
    ('extern "C" int train_hops(', 'extern "C" int train_hops_clk('),
    ("const int* s0,\n                          void* stream)",
     "const int* s0\n                          SN_CLK_PARAM, void* stream)"),
    ("static_cast<const double*>(shifts), prm);",
     "static_cast<const double*>(shifts), prm SN_CLK_ARG);"),
]
HOPS_NAMES = ["ring-slot wait", "reflectors", "barrier", "left update", "barrier ", "plants",
              "barrier  ", "W right update", "barrier   ", "", "Qw: wait for a slot",
              "Qw: right update", "Qw: barrier"]

# B5 as it ships (a cluster of blocks): block 0's first thread, a step: the
# gather and the dlarfg, the partial v^T T, a cluster barrier, the sum and
# the left update, the right update, the plants and the publication, a
# cluster barrier
RECONDENSE_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + CLK_MACROS),
    ("int slab_smem) {", "int slab_smem SN_CLK_KPARAM) {"),
    ("xb[i] = s * rowV(0)[i];\n", "xb[i] = s * rowV(0)[i];\n  SN_CLK_DECL\n"),
    ("beta_out[0] = beta;\n", "beta_out[0] = beta;\n    SN_CLK(0)\n"),
    ("        p_pub[c] = w;\n      }\n      cluster.sync();\n",
     "        p_pub[c] = w;\n      }\n      SN_CLK(1)\n      cluster.sync();\n      SN_CLK(2)\n"),
    ("      __syncthreads();\n      // right update",
     "      __syncthreads();\n      SN_CLK(3)\n      // right update"),
    ("row[i] -= tau * (y * s_v[i]);\n      }\n",
     "row[i] -= tau * (y * s_v[i]);\n      }\n      SN_CLK(4)\n"),
    ("rowT(r)[j + 1];\n    cluster.sync();\n",
     "rowT(r)[j + 1];\n    SN_CLK(5)\n    cluster.sync();\n    SN_CLK(6)\n    SN_CLK_ADD(30, 1)\n"),
    ("      V[(size_t)r_lo * WA + e] = sV[e];\n    }\n  }\n",
     "      V[(size_t)r_lo * WA + e] = sV[e];\n    }\n  }\n"
     "  if (q == 0 && tid == 0) { SN_CLK_OUT(0, 0, 32) }\n"),
    ('extern "C" int recondense(', 'extern "C" int recondense_clk('),
    ("void* beta, void* stream)", "void* beta SN_CLK_PARAM, void* stream)"),
    ("slab ? 1 : 0);", "slab ? 1 : 0 SN_CLK_ARG);"),
]
RECONDENSE_NAMES = ["gather and dlarfg", "partial v^T T", "cluster barrier",
                    "sum and left update", "right update", "plants and publish",
                    "cluster barrier "]


def clock_build_src(name: str, entry: str, path: Path, edits, one_block_edits,
                    one_block_mark):
    """Instrument one version of a kernel source by literal edits in a copy:
    the one-block design (the source holds one_block_mark) by
    one_block_edits, the current design by edits.  Returns (the ctypes
    function, which takes the entry's arguments plus a counter pointer
    before the stream, is_one_block)."""
    out = kernels.BUILD_DIR / "clock" / name
    out.mkdir(parents=True, exist_ok=True)
    text = path.read_text()
    one_block = one_block_mark in text
    text = _lit(text, one_block_edits if one_block else edits)
    for hdr in path.parent.glob("*.cuh"):     # a version's own headers beside it
        (out / hdr.name).write_text(hdr.read_text())
    src = out / f"{entry}_clk.cu"
    src.write_text(text)
    so = out / "clk.so"
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                        "-shared", "-I", str(out), "-I", str(kernels.CSRC), "-o", str(so),
                        str(src)], capture_output=True, text=True)
    print(f"--- build {name} ({path}): rc {r.returncode}\n"
          + "\n".join(ln for ln in r.stderr.splitlines() if "stack frame" in ln
                      or "registers" in ln or "error" in ln), flush=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented {path}:\n{r.stderr[-3000:]}")
    fn = getattr(ctypes.CDLL(str(so)), f"{entry}_clk")
    sig = kernels._SIGNATURES[entry]
    fn.argtypes = sig[:-1] + [_P, _P]
    fn.restype = ctypes.c_int
    return fn, one_block


def _clock_versions(entry, specs):
    """[(name, path)]: the repo's version as "cur" (unless --skip-cur),
    then each NAME=PATH."""
    cur = [] if "--skip-cur" in specs else [("cur", str(kernels.CSRC / f"{entry}.cu"))]
    return cur + [tuple(s.split("=", 1)) for s in specs if s != "--skip-cur"]


def clock_hops(specs) -> bool:
    """clock hops [NAME=PATH ...]: where each B3 version spends a chase
    step's cycles, on chip_smoke's hop cases at B=25 (the n=4000 path's B,
    TMAX) and, for a version that takes it, B=65.  Block g's counters are
    train g's; train 2 runs all HOP steps with every bulge active, as a hop
    inside a sweep does."""
    from chip_smoke import _hop_case
    from starneig_tpu_torch.ops.gpu_schur import _ints
    dev = torch.device("cuda:0")
    fns = {name: clock_build_src(name, "train_hops", Path(p), HOPS_EDITS,
                                 HOPS_ONE_BLOCK_EDITS, "kMaxB")
           for name, p in _clock_versions("train_hops", specs)}
    for B, G in ((25, 5), (65, 5)):
        W, sh, gidx, lr, ir, s0, B_, HOP = _hop_case(B, G, 11 + B, dev)
        for name, (fn, one_block) in fns.items():
            if one_block and B > 64:
                continue
            ctr = torch.zeros(G * 32, dtype=torch.int64, device=dev)

            def run(fn=fn, ctr=ctr):
                out = W.contiguous().clone()
                Qw = torch.empty_like(out)
                kernels.check(fn(out.data_ptr(), Qw.data_ptr(), sh.data_ptr(), G, B_,
                                 W.shape[1], HOP, _ints(gidx), _ints(lr), _ints(ir),
                                 _ints(s0), ctr.data_ptr(), kernels.stream_ptr(W)),
                              "train_hops_clk")
            run()
            ms = cuda_ms(run, 5)
            c = ctr.view(G, -1).cpu().tolist()
            names = HOPS_ONE_BLOCK_NAMES if one_block else HOPS_NAMES
            for g in range(G):
                row = c[g]
                steps = HOP
                total = row[10] if one_block else row[31]
                print(f"hops B={B} G={G} {name} train {g} (l_rel {lr[g]}, ihi_rel {ir[g]}, "
                      f"s0 {s0[g]}): {ms:.3f} ms a hop, {total / steps:.0f} cycles a step "
                      f"({total / (ms * 1e6):.3f} GHz); cycles a step: "
                      + ", ".join(f"{k.strip()} {row[i] / steps:.0f}" for i, k in
                                  enumerate(names) if k), flush=True)
    return True


def clock_recondense(specs) -> bool:
    """clock recondense [NAME=PATH ...]: where each B5 version spends a
    reduction step's cycles, on chip_smoke's B2-solved window at WA=322
    (kbot near 300) and at WA=802 (the n=10,000 geometry, kbot near 780)."""
    from chip_smoke import recondense_window
    dev = torch.device("cuda:0")
    fns = {name: clock_build_src(name, "recondense", Path(p), RECONDENSE_EDITS,
                                 RECONDENSE_ONE_BLOCK_EDITS, "int lo, int m, int c0) {")
           for name, p in _clock_versions("recondense", specs)}
    for WA, near in ((322, 300), (802, 780)):
        Sw, Zw, kb = recondense_window(WA, near, dev)
        for name, (fn, one_block) in fns.items():
            ctr = torch.zeros(64, dtype=torch.int64, device=dev)

            def run(fn=fn, ctr=ctr):
                T, V = Sw.clone(), Zw.clone()
                beta = T.new_zeros(1)
                kernels.check(fn(T.data_ptr(), V.data_ptr(), WA, kb, 0.3, beta.data_ptr(),
                                 ctr.data_ptr(), kernels.stream_ptr(T)), "recondense_clk")
            run()
            ms = cuda_ms(run, 3)
            c = ctr.cpu().tolist()
            names = RECONDENSE_ONE_BLOCK_NAMES if one_block else RECONDENSE_NAMES
            steps = max(c[6] if one_block else c[30], 1)
            total = c[7] if one_block else c[31]
            print(f"recondense WA={WA} kbot={kb} {name}: {ms:.3f} ms, {steps} steps, "
                  f"{total / steps:.0f} cycles a step ({total / (ms * 1e6):.3f} GHz); "
                  "cycles a step: " + ", ".join(f"{k.strip()} {c[i] / steps:.0f}" for i, k in
                                                 enumerate(names) if k), flush=True)
    return True


# G2 as it ships (the chase warp and the update warps): lane 0 of the chase
# warp, summed over the sweeps: between blocks, the window load and the
# ring-slot wait, then a step's left reflector, left update, shuffles with
# the right reflector and the rotation, and stores with the next column's
# shuffle, then a block's write-back, its wait for the near columns and its
# near slide; the step count
QZ_CLK_MACROS = """
#define QZ_CLK_DECL long long qc_[16] = {}; long long qt_ = clock64();
#define QZ_CLK(i) { const long long n_ = clock64(); qc_[i] += n_ - qt_; qt_ = n_; }
#define QZ_CLK_OUT if ((threadIdx.x & 31) == 0) for (int i_ = 0; i_ < 16; ++i_) \\
  atomicAdd(reinterpret_cast<unsigned long long*>(ctr) + i_, (unsigned long long)qc_[i_]);
"""
QZ_EDITS = [
    ('#include "gep_common.cuh"\n', '#include "gep_common.cuh"\n' + QZ_CLK_MACROS),
    ("double (*ring)[kBlockSteps][kRec]) {\n  const int lane = threadIdx.x & 31;\n  const int wp = W.wp;\n"
     "  double(*sH)",
     "double (*ring)[kBlockSteps][kRec], long long* ctr) {\n  const int lane = threadIdx.x & 31;\n"
     "  const int wp = W.wp;\n  QZ_CLK_DECL\n  double(*sH)"),
    ("    double(*rec)[kRec] = ring[b & 1];\n", "    double(*rec)[kRec] = ring[b & 1];\n    QZ_CLK(0)\n"),
    ("    if (b >= 2) bar_sync(kBarFree + (b & 1));\n    __syncwarp();\n",
     "    if (b >= 2) bar_sync(kBarFree + (b & 1));\n    __syncwarp();\n    QZ_CLK(1)\n"),
    ("      chase_reflector(x0, x1, use3 ? x2 : 0.0, v1, v2, tau, beta);\n",
     "      chase_reflector(x0, x1, use3 ? x2 : 0.0, v1, v2, tau, beta);\n"
     "      if (v1 + tau == 1234.5) qc_[14] += 1;\n      QZ_CLK(2)\n"),
    ("      // rows k+1, k+2 of columns k..k+2 from the lanes that updated them\n",
     "      QZ_CLK(3)\n      // rows k+1, k+2 of columns k..k+2 from the lanes that updated them\n"),
    ("      const double sn = -sr;\n",
     "      const double sn = -sr;\n      if (sn + cr == 1234.5) qc_[14] += 1;\n      QZ_CLK(4)\n"),
    ("      x2 = __shfl_sync(0xffffffffu, e0, 2);\n      __syncwarp();\n",
     "      x2 = __shfl_sync(0xffffffffu, e0, 2);\n      __syncwarp();\n      QZ_CLK(5)\n"
     "      qc_[15] += 1;\n"),
    ("    bar_arrive(kBarReady + (b & 1));  // the update warps take block b\n",
     "    bar_arrive(kBarReady + (b & 1));  // the update warps take block b\n    QZ_CLK(6)\n"),
    ("    if (b >= 1) bar_sync(kBarNear + ((b - 1) & 1));\n",
     "    if (b >= 1) bar_sync(kBarNear + ((b - 1) & 1));\n    QZ_CLK(7)\n"),
    ("      slide_col(W.T + (size_t)k0 * wp + c, wp, k0, k1, rec);\n    }\n    __syncwarp();\n",
     "      slide_col(W.T + (size_t)k0 * wp + c, wp, k0, k1, rec);\n    }\n    __syncwarp();\n"
     "    QZ_CLK(8)\n"),
    ("  }\n}\n\n// ---------------------------------------------------------------------------\n"
     "// one sweep over [l, i]: the update warps",
     "  }\n  QZ_CLK_OUT\n}\n\n// ---------------------------------------------------------------------------\n"
     "// one sweep over [l, i]: the update warps"),
    ("int* __restrict__ info) {", "int* __restrict__ info, long long* ctr) {"),
    ("chase_warp(W, l, i, sh + 12, s_win, s_ring);", "chase_warp(W, l, i, sh + 12, s_win, s_ring, ctr);"),
    ('extern "C" int qz_window(', 'extern "C" int qz_window_clk('),
    ("void* info,\n                         void* stream)", "void* info, void* ctr, void* stream)"),
    ("static_cast<int*>(info));", "static_cast<int*>(info), static_cast<long long*>(ctr));"),
]
QZ_NAMES = ["between blocks", "window load, ring wait", "left reflector", "left update",
            "right reflector, rotation", "stores, next column", "write-back",
            "near-column wait", "near slide"]


def clock_qz(specs) -> bool:
    """clock qz [NAME=PATH ...]: where each G2 version's chase warp spends
    its cycles, on chip_smoke's w=162 and w=322 windows: cycles a chase
    step in each of its parts (the serial chain) and a block's."""
    from chip_smoke import ht_window_np
    dev = torch.device("cuda:0")
    fns = {name: clock_build_src(name, "qz_window", Path(p), QZ_EDITS, QZ_EDITS,
                                 "\0no one-block design")
           for name, p in _clock_versions("qz_window", specs)}
    for w in (162, 322):
        Hn, Tn = ht_window_np(w, w)
        th, tt = U / 2 * np.linalg.norm(Hn), U / 2 * np.linalg.norm(Tn)
        WP = w + 3
        for name, (fn, _one_block) in fns.items():
            ctr = torch.zeros(16, dtype=torch.int64, device=dev)

            def run(fn=fn, ctr=ctr):
                Hp = torch.zeros(WP, WP, dtype=torch.float64, device=dev)
                Tp = torch.zeros_like(Hp)
                Hp[:w, :w], Tp[:w, :w] = torch.as_tensor(Hn), torch.as_tensor(Tn)
                Qp = torch.zeros(w, WP, dtype=torch.float64, device=dev)
                Qp[:, :w] = torch.eye(w, dtype=torch.float64)
                Zp = Qp.clone()
                info = torch.zeros(2, dtype=torch.int32, device=dev)
                ctr.zero_()
                kernels.check(fn(Hp.data_ptr(), Tp.data_ptr(), Qp.data_ptr(), Zp.data_ptr(),
                                 w, w, th, tt, info.data_ptr(), ctr.data_ptr(),
                                 kernels.stream_ptr(Hp)), "qz_window_clk")
                return info
            info = run()
            ms = cuda_ms(run, 3)
            c = ctr.cpu().tolist()
            steps = max(c[15], 1)
            total = sum(c[:9])
            chain = sum(c[2:6])
            print(f"qz w={w} {name}: info {info.cpu().tolist()}, {ms:.3f} ms (with the "
                  f"counters), {steps} chase steps, chase warp {total / (ms * 1e6):.3f} "
                  f"GHz-equivalent; a step's chain {chain / steps:.0f} cycles ("
                  + ", ".join(f"{k} {c[i] / steps:.0f}" for i, k in enumerate(QZ_NAMES)
                              if 2 <= i <= 5)
                  + "); a step's share of the block parts: "
                  + ", ".join(f"{k} {c[i] / steps:.0f}" for i, k in enumerate(QZ_NAMES)
                              if i < 2 or i > 5), flush=True)
    return True


# G3 in its one-block design (the kernel before its redesign): thread 0's
# cycles a step in the loop-top barriers and the bulge list, the left
# reflectors, a barrier, the left update (S, T and Qw), a barrier, the
# plants and right reflectors, a barrier, the right update (S, T and Zw), a
# barrier, the plants and rotations, a barrier, the rotations' update and
# the barrier after it; the window load, the write-back, the active steps
QZSWEEP_ONE_BLOCK_EDITS = [
    ('#include "gep_common.cuh"\n', '#include "gep_common.cuh"\n' + _TK),
    ("int l_rel, int ihi_rel, int s0) {",
     "int l_rel, int ihi_rel, int s0, long long* __restrict__ ctr) {\n"
     "  long long clk_[32] = {}; long long tc_ = clock64(); const long long t0_ = tc_;"),
    ("  __syncthreads();\n\n  for (int t = 0; t < HOP; ++t) {",
     "  __syncthreads();\n  TK(13)\n  for (int t = 0; t < HOP; ++t) {"),
    ("    if (na == 0) continue;\n", "    if (na == 0) continue;\n    TK(0)\n"),
    ("    __syncthreads();\n    // rows k..k+2 of S and T at column e % WC",
     "    TK(1)\n    __syncthreads();\n    TK(2)\n    // rows k..k+2 of S and T at column e % WC"),
    ("    __syncthreads();\n    // ---- bulge-column plants",
     "    TK(3)\n    __syncthreads();\n    TK(4)\n    // ---- bulge-column plants"),
    ("    __syncthreads();\n    for (int e = tid; e < 3 * na * WC; e += nt) {\n"
     "      const int part = e / (na * WC), f = e % (na * WC);\n"
     "      const Bulge& g = bl[f / WC];\n      if (!g.use3) continue;",
     "    TK(5)\n    __syncthreads();\n    TK(6)\n"
     "    for (int e = tid; e < 3 * na * WC; e += nt) {\n"
     "      const int part = e / (na * WC), f = e % (na * WC);\n"
     "      const Bulge& g = bl[f / WC];\n      if (!g.use3) continue;"),
    ("    __syncthreads();\n    // ---- plants of T's row k+2",
     "    TK(7)\n    __syncthreads();\n    TK(8)\n    // ---- plants of T's row k+2"),
    ("    __syncthreads();\n    for (int e = tid; e < 3 * na * WC; e += nt) {\n"
     "      const int part = e / (na * WC), f = e % (na * WC);\n"
     "      const Bulge& g = bl[f / WC];\n      double* M = part == 0 ? S : (part == 1 ? T : Zw);",
     "    TK(9)\n    __syncthreads();\n    TK(10)\n"
     "    for (int e = tid; e < 3 * na * WC; e += nt) {\n"
     "      const int part = e / (na * WC), f = e % (na * WC);\n"
     "      const Bulge& g = bl[f / WC];\n      double* M = part == 0 ? S : (part == 1 ? T : Zw);"),
    ("    __syncthreads();\n  }\n  for (int e = tid; e < n2; e += nt) {",
     "    TK(11)\n    __syncthreads();\n    TK(12)\n    clk_[30] += 1;\n  }\n"
     "  for (int e = tid; e < n2; e += nt) {"),
    ("    Zg[e] = Zw[e];\n  }\n}",
     "    Zg[e] = Zw[e];\n  }\n  TK(14)\n  if (tid == 0) {\n    clk_[31] = clock64() - t0_;\n"
     "    for (int i_ = 0; i_ < 32; ++i_) ctr[i_] = clk_[i_];\n  }\n}"),
    ('extern "C" int qz_sweep(', 'extern "C" int qz_sweep_clk('),
    ("int s0,\n                        void* stream) {",
     "int s0,\n                        void* sn_ctr, void* stream) {"),
    ("      l_rel, ihi_rel, s0);", "      l_rel, ihi_rel, s0, static_cast<long long*>(sn_ctr));"),
]
QZSWEEP_ONE_BLOCK_NAMES = {0: "loop top", 1: "left reflectors", 2: "barrier", 3: "left update",
                           4: "barrier ", 5: "plants, right reflectors", 6: "barrier  ",
                           7: "right update", 8: "barrier   ", 9: "plants, rotations",
                           10: "barrier    ", 11: "rotation update", 12: "barrier     "}
# the counters of QZSWEEP_EDITS: lane 0 of each warp adds to its row of a
# shared array (a register array indexed at the end would live in local
# memory, whose misses in the small L1 beside 200 KB of shared memory cost
# more than the parts they time)
QZS_CLK_MACROS = """
#define SN_CLK_PARAM , void* sn_ctr
#define SN_CLK_KPARAM , long long* __restrict__ sn_ctr
#define SN_CLK_ARG , static_cast<long long*>(sn_ctr)
#define SN_CLK_FWD , sn_ctr
__shared__ long long sn_sh_[32 * 32];
#define SN_CLK_DECL long long sn_tc_ = clock64(); const long long sn_t0_ = sn_tc_; \\
  long long* sn_clk_ = sn_sh_ + (threadIdx.x >> 5) * 32;
#define SN_CLK(i) { const long long n_ = clock64(); \\
  if ((threadIdx.x & 31) == 0) sn_clk_[i] += n_ - sn_tc_; sn_tc_ = n_; }
#define SN_CLK_ADD(i, v) if ((threadIdx.x & 31) == 0) sn_clk_[i] += (v);
#define SN_CLK_OUT(base, lo, hi) { sn_clk_[31] = clock64() - sn_t0_; \\
  for (int i_ = (lo); i_ < (hi); ++i_) sn_ctr[(base) + i_] = sn_clk_[i_]; }
"""
# G3 as it ships (a chase warp a bulge, the update group): lane 0 of each
# warp, summed over the hop.  A chase warp: the wait for a free ring slot,
# the left reflector (with its input), the left update, the right
# reflector and the rotation, the record with its hand-over, the phase-L
# barrier, the right update, the phase-R barrier; slot 30 its active
# steps.  An update warp: the wait for a step's records, the Qw and Zw
# updates, the group barrier.
QZSWEEP_EDITS = [
    ('#include "gep_common.cuh"\n', '#include "gep_common.cuh"\n' + QZS_CLK_MACROS),
    ("  __syncthreads();\n  // the full ranges where",
     "  for (int i_ = tid; i_ < 32 * 32; i_ += blockDim.x) sn_sh_[i_] = 0;\n"
     "  __syncthreads();\n  // the full ranges where"),
    ("const double* sh) {", "const double* sh SN_CLK_KPARAM) {"),
    ("nall = nchase + kUpdWarps * 32;\n", "nall = nchase + kUpdWarps * 32;\n  SN_CLK_DECL\n"),
    ("  // the update group read the slot\n", "  // the update group read the slot\n    SN_CLK(0)\n"),
    ("      householder(x, use3 ? 7u : 3u, 3, v, tau, beta);\n",
     "      householder(x, use3 ? 7u : 3u, 3, v, tau, beta);\n"
     "      if (tau == 1234.5) sn_clk_[29] += 1;\n      SN_CLK(1)\n"),
    ("      __syncwarp();\n      // the right reflector", "      SN_CLK(2)\n      __syncwarp();\n"
     "      // the right reflector"),
    ("      givens(r1[1], r1[0], c2, s2, rr);\n",
     "      givens(r1[1], r1[0], c2, s2, rr);\n      if (c2 + s2 == 1234.5) sn_clk_[29] += 1;\n"
     "      SN_CLK(3)\n"),
    ("    bar_arrive(kBarReady + slot, nall);  // the update group takes the step\n"
     "    bar_sync(kBarChase, nchase);\n",
     "    bar_arrive(kBarReady + slot, nall);  // the update group takes the step\n"
     "    SN_CLK(4)\n    bar_sync(kBarChase, nchase);\n    SN_CLK(5)\n"),
    ("    bar_sync(kBarChase, nchase);\n  }\n}\n",
     "    SN_CLK(6)\n    bar_sync(kBarChase, nchase);\n    SN_CLK(7)\n"
     "    SN_CLK_ADD(30, active ? 1 : 0)\n  }\n"
     "  if (lane == 0) { SN_CLK_OUT(b * 32, 0, 32) }\n}\n"),
    ("const int* ring_k) {", "const int* ring_k SN_CLK_KPARAM) {"),
    ("  int qlo = h.full", "  SN_CLK_DECL\n  int qlo = h.full"),
    ("    bar_sync(kBarReady + slot, nall);  // the chase's records of step t\n",
     "    bar_sync(kBarReady + slot, nall);  // the chase's records of step t\n    SN_CLK(10)\n"),
    ("    bar_sync(kBarUpd, kUpdWarps * 32);  // the rows are done\n",
     "    SN_CLK(11)\n    bar_sync(kBarUpd, kUpdWarps * 32);  // the rows are done\n    SN_CLK(12)\n"),
    ("  // the slot is read\n  }\n}\n",
     "  // the slot is read\n  }\n  if (lane == 0) { SN_CLK_OUT((h.B + uw) * 32, 0, 32) }\n}\n"),
    ("int l_rel, int ihi_rel, int s0) {", "int l_rel, int ihi_rel, int s0 SN_CLK_KPARAM) {"),
    ("chase(h, S, T, ring, ring_k, shifts);", "chase(h, S, T, ring, ring_k, shifts SN_CLK_FWD);"),
    ("update(h, Qw, Zw, ring, ring_k);", "update(h, Qw, Zw, ring, ring_k SN_CLK_FWD);"),
    ('extern "C" int qz_sweep(', 'extern "C" int qz_sweep_clk('),
    ("int s0,\n                        void* stream) {",
     "int s0 SN_CLK_PARAM,\n                        void* stream) {"),
    ("      l_rel, ihi_rel, s0);", "      l_rel, ihi_rel, s0 SN_CLK_ARG);"),
    # the counters' 8 KB leave room for B <= 12 only
    ("(int)smem_bytes(kMaxB, 6 * kMaxB + 4)", "(int)smem_bytes(12, 76)"),
]
QZSWEEP_NAMES = {0: "slot wait", 1: "left reflector", 2: "left update",
                 3: "right reflector, rotation", 4: "record", 5: "barrier L",
                 6: "right update", 7: "barrier R"}
QZSWEEP_UPD_NAMES = {10: "wait for records", 11: "Qw, Zw updates", 12: "barrier"}


def clock_qzsweep_report(name, ms, c, B, upd_warps=4):
    """Print the current G3 design's counters (QZSWEEP_EDITS): cycles a
    step of the whole hop, of three chase warps by part, the largest of
    each part over the chase warps (the sum of the busy ones: the chain a
    step), and the update warps'."""
    HOP = 3 * B
    total = c[31]
    print(f"qzsweep B={B} {name}: {ms:.4f} ms a hop, {total / HOP:.0f} cycles a step "
          f"({total / (ms * 1e6):.3f} GHz)", flush=True)
    for b in sorted({0, B // 2, B - 1}):
        row = c[b * 32:b * 32 + 32]
        print(f"  chase warp {b} ({row[30]} active steps), cycles a step: "
              + ", ".join(f"{k} {row[i] / HOP:.0f}" for i, k in QZSWEEP_NAMES.items()),
              flush=True)
    top = {i: max(c[b * 32 + i] for b in range(B)) / HOP for i in QZSWEEP_NAMES}
    busy = [i for i, k in QZSWEEP_NAMES.items() if "barrier" not in k and "wait" not in k]
    print("  largest over the chase warps, cycles a step: "
          + ", ".join(f"{k} {top[i]:.0f}" for i, k in QZSWEEP_NAMES.items())
          + f"; chain (their busy parts) {sum(top[i] for i in busy):.0f}", flush=True)
    for uw in range(upd_warps):
        row = c[(B + uw) * 32:(B + uw) * 32 + 32]
        print(f"  update warp {uw}, cycles a step: "
              + ", ".join(f"{k} {row[i] / HOP:.0f}" for i, k in QZSWEEP_UPD_NAMES.items()),
              flush=True)


def clock_qzsweep(specs) -> bool:
    """clock qzsweep [NAME=PATH ...]: where each G3 version spends a chase
    step's cycles, on chip_ab qzsweep's hop (the middle hop of a B=12
    train at n=200, every bulge active): cycles a step in each part, the
    window load and write-back."""
    dev = torch.device("cuda:0")
    path = kernels.BUILD_DIR / "qzsweep_hop.pt"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    qzsweep_inputs(path)
    d = torch.load(path)
    B, HOP = QZSWEEP_B, 3 * QZSWEEP_B
    fns = {name: clock_build_src(name, "qz_sweep", Path(p), QZSWEEP_EDITS,
                                 QZSWEEP_ONE_BLOCK_EDITS, "__shared__ Bulge bl[kMaxB];")
           for name, p in _clock_versions("qz_sweep", specs)}
    Sw, Tw, sh = (d[k].to(dev) for k in ("Sw", "Tw", "sh"))
    WC = Sw.shape[0]
    for name, (fn, one_block) in fns.items():
        ctr = torch.zeros(1024, dtype=torch.int64, device=dev)

        def run(fn=fn, ctr=ctr):
            S, T = Sw.clone(), Tw.clone()
            Qw, Zw = torch.empty_like(S), torch.empty_like(S)
            ctr.zero_()
            kernels.check(fn(S.data_ptr(), T.data_ptr(), Qw.data_ptr(), Zw.data_ptr(),
                             sh.data_ptr(), WC, B, HOP, d["l_rel"], d["ihi_rel"], d["s0"],
                             ctr.data_ptr(), kernels.stream_ptr(S)), "qz_sweep_clk")
        run()
        ms = cuda_ms(run, 5)
        c = ctr.cpu().tolist()
        if one_block:
            steps = max(c[30], 1)
            print(f"qzsweep B={B} {name} (one block): {ms:.4f} ms a hop, {steps} active "
                  f"steps, {c[31] / steps:.0f} cycles a step ({c[31] / (ms * 1e6):.3f} GHz); "
                  "cycles a step: " + ", ".join(f"{k.strip()} {c[i] / steps:.0f}" for i, k in
                                                 QZSWEEP_ONE_BLOCK_NAMES.items())
                  + f"; window load {c[13]}, write-back {c[14]} cycles", flush=True)
        else:
            clock_qzsweep_report(name, ms, c, B)
    return True


# thread 0's counters of a one-block design (G1's window mode and G5 before
# their redesigns): the cycles between marks, summed over the run; slot 31
# the whole kernel
P_CLK_MACROS = """
__shared__ long long sn_sh_[32];
__shared__ long long sn_last_, sn_t0_;
#define P_CLK_INIT if (threadIdx.x == 0) { for (int i_ = 0; i_ < 32; ++i_) sn_sh_[i_] = 0; \\
  sn_last_ = sn_t0_ = clock64(); }
#define P_CLK(i) if (threadIdx.x == 0) { const long long n_ = clock64(); \\
  sn_sh_[i] += n_ - sn_last_; sn_last_ = n_; }
#define P_CLK_OUT if (threadIdx.x == 0) { sn_sh_[31] = clock64() - sn_t0_; \\
  for (int i_ = 0; i_ < 32; ++i_) sn_ctr[i_] = sn_sh_[i_]; }
"""
# G1's window mode before this design (ht_cascade.cu's ht_window_kernel):
# thread 0's cycles a rotation pair: the left rotation, the barrier, its
# share of the row updates (S, T, Q), the barrier, the right rotation, the
# barrier, its share of the column updates (T, S, Z), the barrier
HTWIN_ONE_BLOCK_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + P_CLK_MACROS),
    ("  rot_cols(Q, n, i, 0, n, c, s, -1);\n  __syncthreads();\n",
     "  rot_cols(Q, n, i, 0, n, c, s, -1);\n  P_CLK(2)\n  __syncthreads();\n  P_CLK(3)\n"),
    ("    sh[3] = sr;\n  }\n  __syncthreads();\n",
     "    sh[3] = sr;\n  }\n  P_CLK(4)\n  __syncthreads();\n  P_CLK(5)\n"),
    ("  rot_cols(Z, n, i, 0, n, cr, msr, -1);\n  __syncthreads();\n}\n",
     "  rot_cols(Z, n, i, 0, n, cr, msr, -1);\n  P_CLK(6)\n  __syncthreads();\n  P_CLK(7)\n}\n"),
    ("int kbot, double spike, double* __restrict__ beta) {\n  extern __shared__ double sp[];\n"
     "  __shared__ double sh[4];\n",
     "int kbot, double spike, double* __restrict__ beta, long long* __restrict__ sn_ctr) {\n"
     "  extern __shared__ double sp[];\n  __shared__ double sh[4];\n  P_CLK_INIT\n"),
    ("    __syncthreads();\n    pair_step(S, T, Q, Z, W, i, -1, sh);\n",
     "    P_CLK(0)\n    __syncthreads();\n    P_CLK(1)\n    pair_step(S, T, Q, Z, W, i, -1, sh);\n"),
    ("      __syncthreads();\n      pair_step(S, T, Q, Z, W, i, j, sh);\n",
     "      P_CLK(0)\n      __syncthreads();\n      P_CLK(1)\n      pair_step(S, T, Q, Z, W, i, j, sh);\n"),
    ("    if (r > c) T[(size_t)r * W + c] = 0.0;\n  }\n}\n",
     "    if (r > c) T[(size_t)r * W + c] = 0.0;\n  }\n  P_CLK_OUT\n}\n"),
    ('extern "C" int ht_recondense(void* S, void* T, void* Q, void* Z, int W, int kbot,\n'
     '                             double s, void* beta, void* stream) {',
     'extern "C" int ht_recondense_clk(void* S, void* T, void* Q, void* Z, int W, int kbot,\n'
     '                             double s, void* beta, void* sn_ctr, void* stream) {'),
    ("      static_cast<double*>(Z), W, kbot, s, static_cast<double*>(beta));",
     "      static_cast<double*>(Z), W, kbot, s, static_cast<double*>(beta),\n"
     "      static_cast<long long*>(sn_ctr));"),
]
HTWIN_ONE_BLOCK_NAMES = {0: "left rotation", 1: "barrier", 2: "row updates", 3: "barrier ",
                         4: "right rotation", 5: "barrier  ", 6: "column updates",
                         7: "barrier   "}
# G1's window mode as it ships (ht_recondense.cu's chain kernel): lane 0 of
# each warp, summed over the cascades.  Phases A (the left rotations, the
# block), B (the left pass), then C (warp 0, the right chain: 9 forming a
# rotation, 10 the row updates and the publication) beside D (the other
# warps: the right
# pass behind the chain, its waits included), each phase ended by a block
# barrier; 11 T's load, 12 its barrier, 13 the write-back
HTWIN_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + QZS_CLK_MACROS),
    ("int v_shared, int t_shared) {", "int v_shared, int t_shared SN_CLK_KPARAM) {"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  if (kbot <= 1) {",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  for (int i_ = tid; i_ < 32 * 32; i_ += blockDim.x) sn_sh_[i_] = 0;\n"
     "  __syncthreads();\n  SN_CLK_DECL\n  if (kbot <= 1) {"),
    ("  __syncthreads();\n  for (int m = 0; m <= kbot - 2; ++m) {",
     "  SN_CLK(11)\n  __syncthreads();\n  SN_CLK(12)\n  for (int m = 0; m <= kbot - 2; ++m) {"),
    ("    __syncthreads();\n    // -- B:", "    SN_CLK(0)\n    __syncthreads();\n    SN_CLK(1)\n"
     "    // -- B:"),
    ("    __syncthreads();\n    if (warp == 0) {\n      // -- C:",
     "    SN_CLK(2)\n    __syncthreads();\n    SN_CLK(3)\n    if (warp == 0) {\n      // -- C:"),
    ("        __syncwarp();   // every lane has read the pair before row k is written\n",
     "        __syncwarp();   // every lane has read the pair before row k is written\n"
     "        SN_CLK(9)\n"),
    ("        __syncwarp();\n        ok -= k + 1;\n      }\n",
     "        __syncwarp();\n        ok -= k + 1;\n        SN_CLK(10)\n      }\n"),
    ("    __syncthreads();\n  }\n  // T's leading block back",
     "    SN_CLK(4)\n    __syncthreads();\n    SN_CLK(5)\n  }\n  // T's leading block back"),
    ("    Tg[(size_t)r * W + c] = r <= c ? Tp[poff(c) + r] : 0.0;\n  }\n}\n",
     "    Tg[(size_t)r * W + c] = r <= c ? Tp[poff(c) + r] : 0.0;\n  }\n  SN_CLK(13)\n"
     "  if (lane == 0) { SN_CLK_OUT(warp * 32, 0, 32) }\n}\n"),
    ("double* beta, size_t budget) {", "double* beta, size_t budget SN_CLK_PARAM) {"),
    ("t_shared ? 1 : 0);", "t_shared ? 1 : 0 SN_CLK_ARG);"),
    ('extern "C" int ht_recondense(', 'extern "C" int ht_recondense_clk('),
    ("int smem_cap, void* stream) {", "int smem_cap SN_CLK_PARAM, void* stream) {"),
    ("kSmemMax - 1024 - tiles);", "kSmemMax - 1024 - tiles SN_CLK_FWD);"),
]
HTWIN_NAMES = {0: "A left rotations", 1: "barrier A", 2: "B left pass", 3: "barrier B",
               9: "C forming", 10: "C updates", 4: "C/D tail", 5: "barrier C/D"}


def clock_htwin(specs) -> bool:
    """clock htwin [NAME=PATH ...]: where G1's window mode spends its cycles
    on chip_ab htwin's windows (WA = 84 and 162, kbot = WA - 4): for the
    one-block design (a NAME=PATH to the parent's ht_cascade.cu) thread
    0's cycles a pair by part; for the current chain kernel warp 0's
    cycles a pair by phase (its phases A and C: the serial chain), the
    largest of the bulk phases over the other warps and their waits, and
    the replay's share of the call (CUDA events less the chain's cycles)."""
    from starneig_tpu_torch.testing.generators import planted_schur_pair
    dev = torch.device("cuda:0")
    fns = {name: clock_build_src(name, "ht_recondense", Path(p), HTWIN_EDITS,
                                 HTWIN_ONE_BLOCK_EDITS, "ht_window_kernel")
           for name, p in _clock_versions("ht_recondense", specs)}
    hz = None
    for WA in HTWIN_WA[:2]:
        kbot = WA - 4
        x = [torch.as_tensor(a, device=dev) for a in planted_schur_pair(WA, WA, WA)]
        pairs = kbot * (kbot - 1) // 2
        for name, (fn, one_block) in fns.items():
            ctr = torch.zeros(1024, dtype=torch.int64, device=dev)
            if one_block:
                fn.argtypes = [_P] * 4 + [_I, _I, _D, _P, _P, _P]

            def run(fn=fn, ctr=ctr, one_block=one_block):
                S, T, Q, Z = (a.clone() for a in x)
                beta = S.new_zeros(1)
                ctr.zero_()
                st = kernels.stream_ptr(S)
                if one_block:
                    code = fn(S.data_ptr(), T.data_ptr(), Q.data_ptr(), Z.data_ptr(), WA,
                              kbot, HTWIN_S, beta.data_ptr(), ctr.data_ptr(), st)
                else:
                    tsc = S.new_empty(kbot * (kbot + 3) // 2 + 5 * kbot)
                    lg = S.new_empty(2 * kbot * (kbot - 1))
                    code = fn(S.data_ptr(), T.data_ptr(), Q.data_ptr(), Z.data_ptr(),
                              tsc.data_ptr(), lg.data_ptr(), WA, kbot, HTWIN_S,
                              beta.data_ptr(), 0, ctr.data_ptr(), st)
                kernels.check(code, "ht_recondense_clk")
            run()
            ms = cuda_ms(run, 3)
            c = ctr.cpu().tolist()
            if one_block:
                hz = c[31] / (ms * 1e6)
                print(f"htwin WA={WA} kbot={kbot} {name} (one block): {ms:.3f} ms, "
                      f"{c[31] / pairs:.0f} cycles a pair ({hz:.3f} GHz); cycles a pair: "
                      + ", ".join(f"{k.strip()} {c[i] / pairs:.0f}"
                                  for i, k in HTWIN_ONE_BLOCK_NAMES.items()), flush=True)
                continue
            w0 = c[:32]
            chain = w0[0] + w0[9] + w0[10]
            print(f"htwin WA={WA} kbot={kbot} {name}: {ms:.3f} ms a call, the chain kernel "
                  f"{w0[31]} cycles ({w0[31] / pairs:.0f} a pair); warp 0, cycles a pair: "
                  + ", ".join(f"{k} {w0[i] / pairs:.0f}" for i, k in HTWIN_NAMES.items())
                  + f"; T's load {w0[11]}, its barrier {w0[12]}, write-back {w0[13]} cycles; "
                  f"the serial chain (A + C) {chain / pairs:.0f} cycles a pair", flush=True)
            top = {i: max(c[w * 32 + i] for w in range(1, 16)) / pairs for i in (1, 2, 4, 5)}
            print("  the other warps, largest, cycles a pair: "
                  + ", ".join(f"{({4: 'D right pass with its waits'}).get(i, HTWIN_NAMES[i])} "
                              f"{v:.0f}" for i, v in top.items()), flush=True)
    return True


# G5 before this design (one block, thread 0 forming both rotations):
# thread 0's cycles a step by part
INF_ONE_BLOCK_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + P_CLK_MACROS),
    ("int jrel, int mrel, int lrel) {\n  extern __shared__ double smem[];\n",
     "int jrel, int mrel, int lrel, long long* __restrict__ sn_ctr) {\n"
     "  extern __shared__ double smem[];\n  P_CLK_INIT\n"),
    ("      s_rot[2] = r;\n    }\n    __syncthreads();\n",
     "      s_rot[2] = r;\n    }\n    P_CLK(0)\n    __syncthreads();\n    P_CLK(1)\n"),
    ("    __syncthreads();\n    const int im1 = i - 1 > 0 ? i - 1 : 0;",
     "    P_CLK(2)\n    __syncthreads();\n    P_CLK(3)\n    const int im1 = i - 1 > 0 ? i - 1 : 0;"),
    ("    __syncthreads();\n    if (s_skip) continue;",
     "    P_CLK(4)\n    __syncthreads();\n    P_CLK(5)\n    if (s_skip) continue;"),
    ("        *b = nb;  // at i = 0, a == b: nb wins, as in the twin\n      }\n    }\n"
     "    __syncthreads();\n",
     "        *b = nb;  // at i = 0, a == b: nb wins, as in the twin\n      }\n    }\n"
     "    P_CLK(6)\n    __syncthreads();\n    P_CLK(7)\n"),
    ("    T[e] = sT[r * ld + c];\n  }\n}\n", "    T[e] = sT[r * ld + c];\n  }\n  P_CLK_OUT\n}\n"),
    ('extern "C" int inf_chase(void* H, void* T, void* Q, void* Z, int Wb, int jrel,\n'
     '                         int mrel, int lrel, void* stream) {',
     'extern "C" int inf_chase_clk(void* H, void* T, void* Q, void* Z, int Wb, int jrel,\n'
     '                         int mrel, int lrel, void* sn_ctr, void* stream) {'),
    ("      static_cast<double*>(Z), Wb, jrel, mrel, lrel);",
     "      static_cast<double*>(Z), Wb, jrel, mrel, lrel, static_cast<long long*>(sn_ctr));"),
]
INF_ONE_BLOCK_NAMES = {0: "left rotation", 1: "barrier", 2: "row updates", 3: "barrier ",
                       4: "plants, reflection", 5: "barrier  ", 6: "column updates",
                       7: "barrier   "}
# G5 as it ships: the chase warp's lane 0, a step: the row updates with
# T's plants, the hand-over, the two rotations formed (this step's
# reflection and the next step's left rotation: the chain), the near rows'
# column updates with H's plants and the step's record, the step's end
INF_EDITS = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + QZS_CLK_MACROS),
    ("int jrel, int mrel, int lrel) {\n  extern __shared__ double smem[];",
     "int jrel, int mrel, int lrel SN_CLK_KPARAM) {\n  extern __shared__ double smem[];"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  for (int i_ = tid; i_ < 32 * 32; i_ += blockDim.x) sn_sh_[i_] = 0;\n"),
    ("  if (warp == 0) {\n", "  if (warp == 0) {\n    SN_CLK_DECL\n"),
    ("      __syncwarp();\n      // the next step's left rotation",
     "      SN_CLK(0)\n      __syncwarp();\n      SN_CLK(1)\n      // the next step's left rotation"),
    ("      if (i1 <= last) givens_rs(sT[i1 * ld + i1 + 1], sT[(i1 + 1) * ld + i1 + 1], cn, sn, rn);\n",
     "      if (i1 <= last) givens_rs(sT[i1 * ld + i1 + 1], sT[(i1 + 1) * ld + i1 + 1], cn, sn, rn);\n"
     "      if (cn + sn + cr + sr == 1234.5) sn_clk_[29] += 1;\n      SN_CLK(2)\n"),
    ("      rl = rn;\n      __syncwarp();\n    }\n  } else if (warp <= kUpd) {",
     "      rl = rn;\n      SN_CLK(3)\n      __syncwarp();\n      SN_CLK(4)\n    }\n"
     "    if (lane == 0) { SN_CLK_OUT(0, 0, 32) }\n  } else if (warp <= kUpd) {"),
    ('extern "C" int inf_chase(', 'extern "C" int inf_chase_clk('),
    ("int mrel, int lrel, void* stream) {", "int mrel, int lrel SN_CLK_PARAM, void* stream) {"),
    ("static_cast<double*>(ZT), Wb, jrel, mrel, lrel);",
     "static_cast<double*>(ZT), Wb, jrel, mrel, lrel SN_CLK_ARG);"),
]
INF_NAMES = {0: "row updates, T's plants", 1: "hand-over", 2: "two rotations formed",
             3: "near column updates, H's plants, record", 4: "step's end"}


def clock_infchase(specs) -> bool:
    """clock infchase [NAME=PATH ...]: where G5 spends a step's cycles on
    the n=2000 push's window (Wb = 96, jrel = 1, 94 steps): thread 0's by
    part for the one-block design (a NAME=PATH to the parent's
    inf_chase.cu), the chase warp's for the current one, whose chain is
    the rotations formed."""
    from starneig_tpu_torch.testing.generators import inf_push_window
    dev = torch.device("cuda:0")
    Wb, jrel, mrel, lrel = INF_CASES[0]
    H0, T0 = (torch.as_tensor(a, device=dev) for a in inf_push_window(Wb, Wb + jrel, jrel, lrel))
    steps = mrel - 1 - jrel
    for name, p in _clock_versions("inf_chase", specs):
        fn, one_block = clock_build_src(name, "inf_chase", Path(p), INF_EDITS,
                                        INF_ONE_BLOCK_EDITS, "s_rot[3]")
        ctr = torch.zeros(1024, dtype=torch.int64, device=dev)
        if one_block:     # the one-block design chased H and T in place
            fn.argtypes = [_P] * 4 + [_I] * 4 + [_P, _P]

        def run(fn=fn, ctr=ctr, one_block=one_block):
            H, T = H0.clone(), T0.clone()
            Q, Z = torch.empty_like(H), torch.empty_like(H)
            ctr.zero_()
            io = (H.data_ptr(), T.data_ptr()) if one_block else \
                (H0.data_ptr(), T0.data_ptr(), H.data_ptr(), T.data_ptr())
            kernels.check(fn(*io, Q.data_ptr(), Z.data_ptr(), Wb, jrel, mrel, lrel,
                             ctr.data_ptr(), kernels.stream_ptr(H)), "inf_chase_clk")
        run()
        ms = cuda_ms(run, 20)
        c = ctr.cpu().tolist()
        names = INF_ONE_BLOCK_NAMES if one_block else INF_NAMES
        print(f"infchase Wb={Wb} {name}{' (one block)' if one_block else ''}: {ms:.4f} ms, "
              f"{c[31] / steps:.0f} cycles a step of {steps} ({c[31] / (ms * 1e6):.3f} GHz "
              "over the call); cycles a step: "
              + ", ".join(f"{k.strip()} {c[i] / steps:.0f}" for i, k in names.items()),
              flush=True)
    return True


def ab_clock(args) -> bool:
    """clock [deflate|hops|recondense|qz|qzsweep|htwin|infchase] [--skip-cur] [NAME=PATH ...]"""
    kind = args[0] if args and "=" not in args[0] else "deflate"
    rest = args[1:] if args and "=" not in args[0] else args
    return {"deflate": clock_deflate, "hops": clock_hops,
            "recondense": clock_recondense, "qz": clock_qz,
            "qzsweep": clock_qzsweep, "htwin": clock_htwin,
            "infchase": clock_infchase}[kind](rest)


# G2's infinite-eigenvalue decisions, printed in a copy: T-diagonal
# entries near the detection threshold that are not exact zeros (QZFIND),
# each chase (QZCALL) and each stop test of a chase (QZINF)
QZINF_EDITS = [
    ('#include "gep_common.cuh"\n', '#include <cstdio>\n#include "gep_common.cuh"\n'),
    ("      if (fabs(T[idx * wp + idx]) <= tsmall) atomicMin(&s_jinf, idx);\n",
     "      if (fabs(T[idx * wp + idx]) <= tsmall) atomicMin(&s_jinf, idx);\n"
     "    for (int idx = l + tid; idx <= i; idx += blockDim.x) {\n"
     "      const double t_ = fabs(T[idx * wp + idx]);\n"
     "      if (t_ != 0.0 && t_ <= 1e3 * tsmall)\n"
     "        printf(\"QZFIND %d %d %d %d %.17g %.17g %d\\n\", total, l, i, idx, t_, tsmall,\n"
     "               (int)(t_ <= tsmall));\n"
     "    }\n"),
    ("      if (tid == 0) T[jinf * wp + jinf] = 0.0;\n",
     "      if (tid == 0) {\n"
     "        printf(\"QZCALL %d %d %d %d\\n\", total, jinf, l, i);\n"
     "        T[jinf * wp + jinf] = 0.0;\n"
     "      }\n"),
    ("          if (!tsig) T[(jc + 1) * wp + jc + 1] = 0.0;\n",
     "          printf(\"QZINF %d %d %d %d %.17g %.17g %.17g %d\\n\", total, jinf, jc, i,\n"
     "                 fabs(T[(jc + 1) * wp + jc + 1]), fabs(T[jc * wp + jc + 1]),\n"
     "                 dmax(thresh_t, ulp * fabs(T[jc * wp + jc + 1])), (int)tsig);\n"
     "          if (!tsig) T[(jc + 1) * wp + jc + 1] = 0.0;\n"),
    ('extern "C" int qz_window(', 'extern "C" int qz_window_log('),
]


def qzinf_build():
    """{name: ctypes function}: G2 with the stop tests printed, as shipped
    ("log") and without fused multiply-adds ("nofma")."""
    out = kernels.BUILD_DIR / "qzinf"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "qz_window_log.cu"
    src.write_text(_lit((kernels.CSRC / "qz_window.cu").read_text(), QZINF_EDITS))
    jobs = {}
    for name, extra in (("log", []), ("nofma", ["-fmad=false"])):
        so = out / f"{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *extra, "-shared",
               "-I", str(kernels.CSRC), "-o", str(so), str(src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({name}):\n{err[-3000:]}")
        fn = ctypes.CDLL(str(so)).qz_window_log
        fn.argtypes = kernels._SIGNATURES["qz_window"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def qzinf_run(fn, H, T, w, th, tt):
    """G2 through fn on the window; returns (S, Tt, Q, Z, info, the
    kernel's printed records).  Device printf goes to the process's
    stdout, so file descriptor 1 points at a file during the call."""
    import os
    import tempfile
    dev = torch.device("cuda:0")
    WP = w + 3
    Hp = torch.zeros(WP, WP, dtype=torch.float64, device=dev)
    Tp = torch.zeros_like(Hp)
    Hp[:w, :w], Tp[:w, :w] = H, T
    Qp = torch.zeros(w, WP, dtype=torch.float64, device=dev)
    Qp[:, :w] = torch.eye(w, dtype=torch.float64)
    Zp = Qp.clone()
    info = torch.zeros(2, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile(mode="w+", dir=kernels.BUILD_DIR) as f:
        os.dup2(f.fileno(), 1)
        try:
            kernels.check(fn(Hp.data_ptr(), Tp.data_ptr(), Qp.data_ptr(), Zp.data_ptr(),
                             w, w, th, tt, info.data_ptr(),
                             torch.cuda.current_stream().cuda_stream), "qz_window_log")
            torch.cuda.synchronize()
            ctypes.CDLL(None).fflush(None)     # the C stdio buffer, into the file
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        recs = sorted((tuple(ln.split()) for ln in f if ln.startswith("QZ")), key=qzinf_order)
    return (Hp[:w, :w].cpu(), Tp[:w, :w].cpu(), Qp[:, :w].cpu(), Zp[:, :w].cpu(),
            int(info[0]), recs)


QZINF_KINDS = ("QZFIND", "QZCALL", "QZINF")


def qzinf_order(rec):
    """Records in the order the plain twin makes them: by iteration, then
    detection, chase, stop tests, each by its row (the kernel's threads
    print a detection pass in any order)."""
    return (int(rec[1]), QZINF_KINDS.index(rec[0]), int(rec[4 if rec[0] == "QZFIND" else 3]))


def qzinf_plain(H, T, w, th, tt):
    """The plain twin with its decisions recorded in the kernel's format
    (a wrapper of ops/qz.py:_find_inf, a logged copy of _process_inf)."""
    from starneig_tpu_torch.ops import primitives as prim
    from starneig_tpu_torch.ops import qz
    recs = []
    total = [-1]        # the machine's iteration: one detection pass each
    find_inf = qz._find_inf

    def find_logged(Hp, Tp, w_, l, i, thresh_h, thresh_t):
        total[0] += 1
        td = torch.diagonal(Tp[:w_, :w_]).abs()
        tsmall = max(float(qz.ULP * td.max()), thresh_t)
        for idx in range(l, i + 1):
            t_ = float(td[idx])
            if t_ != 0.0 and t_ <= 1e3 * tsmall:
                recs.append(("QZFIND", str(total[0]), str(l), str(i), str(idx), f"{t_:.17g}",
                             f"{tsmall:.17g}", str(int(t_ <= tsmall))))
        return find_inf(Hp, Tp, w_, l, i, thresh_h, thresh_t)

    def process_inf(Hp, Tp, Qp, Zp, j, l, i, thresh_t):
        recs.append(("QZCALL", str(total[0]), str(j), str(l), str(i)))
        Tp[j, j] = 0.0
        for jc in range(j, i):
            c, s, _ = prim.givens(Hp[jc, jc], Hp[jc + 1, jc])
            qz.rot_rows(Hp, jc + 1, c, s)
            Hp[jc + 1, jc] = 0.0
            if jc == j and jc > l and jc >= 1:
                Hp[jc + 1, jc - 1] = 0.0
            qz.rot_rows(Tp, jc + 1, c, s)
            qz.rot_cols(Qp, jc + 1, c, s)
            a, b = float(Tp[jc + 1, jc + 1].abs()), float(Tp[jc, jc + 1].abs())
            thr = max(thresh_t, qz.ULP * b)
            recs.append(("QZINF",) + tuple(str(x) for x in (total[0], j, jc, i))
                        + tuple(f"{x:.17g}" for x in (a, b, thr)) + (str(int(a > thr)),))
            if a > thr:
                return i
            Tp[jc + 1, jc + 1] = 0.0
        c, s, _ = prim.givens(Hp[i, i], Hp[i, i - 1])
        qz.rot_cols(Hp, i, c, -s)
        Hp[i, i - 1] = 0.0
        qz.rot_cols(Tp, i, c, -s)
        Tp[i, i - 1] = 0.0
        qz.rot_cols(Zp, i, c, -s)
        return i - 1

    orig = qz._process_inf
    qz._process_inf, qz._find_inf = process_inf, find_logged
    try:
        eye = torch.eye(w, dtype=torch.float64)
        out = qz._small_qz_plain(torch.as_tensor(H), torch.as_tensor(T), eye, eye, w, th, tt)
    finally:
        qz._process_inf, qz._find_inf = orig, find_inf
    return (*out[:4], int(out[4]), recs)


def ab_qzinf(_args) -> bool:
    """qzinf"""
    from chip_smoke import ht_window_np
    from starneig_tpu_torch.ops import gpu_gep
    w, ninf = 84, 8
    Hn, Tn = ht_window_np(w, w + ninf, ninf)
    th, tt = U / 2 * np.linalg.norm(Hn), U / 2 * np.linalg.norm(Tn)
    H, T = torch.as_tensor(Hn), torch.as_tensor(Tn)
    dev = torch.device("cuda:0")
    kernels.build()
    fns = qzinf_build()
    eye = torch.eye(w, dtype=torch.float64, device=dev)
    cur = gpu_gep.qz_window(H.to(dev), T.to(dev), eye, eye, w, th, tt)
    runs = {"cur": (*(x.cpu() for x in cur[:4]), int(cur[4]), None),
            "plain": qzinf_plain(Hn, Tn, w, th, tt)}
    for name, fn in fns.items():
        runs[name] = qzinf_run(fn, H.to(dev), T.to(dev), w, th, tt)
    ok = True
    for name, (S, Tt, Q, Z, info, recs) in runs.items():
        d = torch.diagonal(Tt).abs()
        exact, tiny = int((d == 0).sum()), int((d <= 1e-12 * d.max()).sum())
        print(f"{name}: info {info}, betas exactly 0: {exact} at "
              f"{torch.where(d == 0)[0].tolist()}, <= 1e-12 max|beta|: {tiny}; the "
              f"others there {[f'{float(x):.3e}' for x in d[(d != 0) & (d <= 1e-12 * d.max())]]}"
              + ("" if recs is None else f"; records {len(recs)}"), flush=True)
        ok &= info == 0 and tiny >= ninf
    plain = runs["plain"][5]

    def key(rec):        # the record's tag and integers (indices, decisions)
        return tuple(x for x in rec if x.startswith("QZ") or x.lstrip("-").isdigit())
    print("records: QZFIND iteration l i idx |T[idx,idx]| threshold found (a T-diagonal "
          "entry within 1e3 x the threshold, not 0), QZCALL iteration jinf l i (a chase), "
          "QZINF iteration jinf jc i |T[jc+1,jc+1]| |T[jc,jc+1]| threshold stop (its stop "
          "test)", flush=True)
    for name in fns:
        recs = runs[name][5]
        k = next((k for k, (a, b) in enumerate(zip(recs, plain)) if key(a) != key(b)), None)
        if k is None and len(recs) == len(plain):
            print(f"{name}: every record decides as the plain twin's", flush=True)
            continue
        k = min(len(recs), len(plain)) if k is None else k
        print(f"{name}: first departure at record {k}:", flush=True)
        for lo in range(max(0, k - 2), k + 2):
            if lo < len(plain):
                print(f"  plain  {' '.join(plain[lo])}", flush=True)
            if lo < len(recs):
                print(f"  {name:6s} {' '.join(recs[lo])}", flush=True)
    return ok


MODES = {"francis": ab_francis, "gemv": ab_gemv, "deflate": ab_deflate,
         "bubble": ab_bubble, "hops": ab_hops, "recondense": ab_recondense,
         "mainpath": ab_mainpath, "clock": ab_clock, "qzinf": ab_qzinf,
         "bitwise": ab_bitwise, "ht": ab_ht, "qz": ab_qz, "qzsweep": ab_qzsweep,
         "htwin": ab_htwin, "infchase": ab_infchase}
# the per-ROOT workers, by mode: (root, *the mode's arguments as strings)
PER_ROOT = {"mainpath": lambda root, n: mainpath_one(root, int(n)),
            "bitwise": lambda root, n, device: bitwise_one(root, int(n), device),
            "ht": lambda root, n: ht_one(root, int(n)), "qz": qz_one,
            "qzsweep": qzsweep_one, "htwin": htwin_one, "infchase": infchase_one}


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "_one":
        PER_ROOT[sys.argv[2]](sys.argv[3], *sys.argv[4:])
        return 0
    if len(sys.argv) < 2 or sys.argv[1] not in MODES:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "bitwise" and "cpu" in sys.argv[2:]:
        return 0 if ab_bitwise(sys.argv[2:]) else 1
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
