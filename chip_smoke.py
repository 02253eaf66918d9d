#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises; the exit code is then nonzero):

  1. device: requires CUDA; prints torch, CUDA, nvcc and the card's name
     and power limit (nvidia-smi);
  2. build: compiles the hand-written kernels from
     starneig_tpu_torch/kernels/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch twin on the card, at
     small shapes and at the shapes the n=4000 main path gives it, with
     the tolerances stated below; CUDA-event times of both (the plain
     twins' one timed run at the main path's shape comes after their runs
     at the smaller shapes, which serve as the warm-up); each kernel's
     bound (bytes over HBM_BPS or fp64 operations over F64_FLOPS, counted
     from this run's inputs), and under each kernel's detail its serial
     chain from cycle counts of earlier runs (chip_ab.py clock); B1's
     transposed mode beside M.T @ x, in turns, by CUDA events and by
     profiler device time, and checked bit-for-bit across two launches;
     B2's chase steps; B3 at B = 3, 25, 65 and 132 (the n=4000, 10,000 and
     20,000 geometries) with the zero plant a sweep gives at each
     introduction, and at B = 25 without it (the full-range path); B4's and
     the bubble's swaps, microseconds a swap and serial-chain floor (swaps x
     SWAP_CYCLES), on inputs that include rejected swaps mid-segment, frozen
     rows and an insertion limit; B5 at WA=40, 322 and 802;
  4. n=1200 with B=70: api.sep.hessenberg and api.sep.schur with a
     geometry of 70 bulges a train, gated on info, residual,
     orthogonality, the Schur form, the eigenvalues against numpy and B3's
     launches;
  5. main path: a seeded n=200 solve and a seeded n=200 api.sep.reduce
     (Re(lambda) > 0) checked against numpy and the CPU run of the port;
     then n=4000 (A from default_rng(0)) through api.sep.hessenberg,
     api.sep.schur, api.sep.select(Re(lambda) > 0), api.sep.reorder_schur
     and api.sep.eigenvectors of the leading selected block, gated on
     info, S in standardized real Schur form before and after reordering,
     residual and orthogonality < 500 u, the leading eigenvalues, the
     spectrum kept by the reordering, the eigenvector residuals, and the
     launch counts, zeroed before each of the two paths (Hessenberg ->
     Schur; select -> reorder -> eigenvectors) and read after it: every
     kernel of a path launched at least once there.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  ``--out`` also writes all results as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
U = 2.220446049250313e-16          # float64 eps: the unit of the gates
GATE_U = 500.0                     # reference warn gate (BASELINE.md)
MAIN_N = 4000                      # bench.py's size
# eigenvalues moved by the reordering, relative to max |lambda|: a
# backward-stable reordering (residual < 500 u) moves each by at most its
# condition number times 500 u ||A||; random matrices stay far below 1e-8
EIG_MOVE = 1e-8
# eigenvector residual ||A x - lambda x|| / (||A||_F ||x||): the chain's
# backward error (< 500 u) plus the backsolve's rounding (at most n u =
# 8.9e-13 relative at n=4000), with a margin of 100 over the latter
EVEC_BOUND = 1e-10
# B2's reflector chain, per chase step: about 0.6 us (clock64 counters
# on the H100, PERF.md section 6); steps x this is the serial floor
CHAIN_US = 0.6
# B4's and the bubble's chain: cycles of swap_adjacent_warp on the chain
# warp by block sizes (p, q), clock64 counters on the H100 at about 1.99
# GHz (chip_ab.py clock; PERF.md section 6); swaps x these over SM_HZ is
# their floor
SWAP_CYCLES = {(1, 1): 1442, (1, 2): 9750, (2, 1): 10660, (2, 2): 11424}
SM_HZ = 1.98e9
# B3's chain a step and B5's a reduction step, in cycles (clock64 counters
# in instrumented copies of the kernels as shipped, chip_ab.py clock hops /
# recondense, PERF.md section 6): the reflectors' phase of a hop step at B=25 (the shortest over
# the trains), and a recondense step's gather and dlarfg, the partial
# products, the cluster barrier and the sum at WA=322, kbot=300
HOP_STEP_CYCLES = 2725
RECONDENSE_STEP_CYCLES = 6648

REPLACES = {
    "hess_gemv": "starneig_tpu/ops/pallas_hess.py:45",
    "francis": "starneig_tpu/ops/pallas_schur.py:131",
    "train_hops": "starneig_tpu/ops/pallas_schur.py:537",
    "aed_deflate": "starneig_tpu/ops/pallas_schur.py:797",
    "recondense": "starneig_tpu/ops/pallas_schur.py:1109",
    # no Pallas kernel there: the JAX package ran the bubble as an XLA
    # while-loop (_run_bubble_b), which the TPU executed
    "reorder_bubble": "starneig_tpu/ops/reorder.py:156",
}
SOURCES = {k: f"starneig_tpu_torch/kernels/csrc/{k}.cu" for k in REPLACES}
# the card's peaks for bound_ms (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes per second and fp64 operations per second outside the tensor cores
HBM_BPS = 3.35e12
F64_FLOPS = 34e12
# the kernels of Hessenberg -> Schur; the reordering runs reorder_bubble
SCHUR_KERNELS = ("hess_gemv", "francis", "train_hops", "aed_deflate", "recondense")


def _b70_conf():
    from starneig_tpu_torch.config import SchurConf
    return SchurConf(aed_window_size=200, aed_shift_count=160, shifts_per_window=140)


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take to move
    nbytes through HBM and do flops fp64 operations."""
    tb, tf = nbytes / HBM_BPS * 1e3, flops / F64_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


@contextlib.contextmanager
def tally(module, name, count):
    """Wrap module.name for the block: each call adds count(*args) to the
    yielded one-element list.  Counts the work of a plain twin's run."""
    orig = getattr(module, name)
    box = [0]

    def wrapper(*a, **kw):
        box[0] += count(*a, **kw)
        return orig(*a, **kw)
    setattr(module, name, wrapper)
    try:
        yield box
    finally:
        setattr(module, name, orig)


def device_ms(fn, reps: int):
    """Device time of the kernels fn() launches, per call, from
    torch.profiler (a kernel's own time, without the host's launch gaps);
    None if the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def timed(fn):
    """Run fn() once; return (its result, its CUDA-event time in ms)."""
    import torch
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def block_eigs(S, m):
    """Sorted eigenvalues read off the diagonal blocks of S[:m, :m]."""
    import numpy as np
    from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
    er, ei = extract_eigenvalues(S[:m, :m])
    return np.sort_complex(er.cpu().numpy() + 1j * ei.cpu().numpy())


def phase_device():
    import torch
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    log("nvcc:", [ln for ln in out.stdout.splitlines() if "release" in ln][-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    log(f"import triton: {has_triton}; devices: {torch.cuda.device_count()}")
    return smi


def phase_build():
    from starneig_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s")
    return secs


def hessenberg_np(n, seed):
    import numpy as np
    return np.triu(np.random.default_rng(seed).standard_normal((n, n)), -1)


def phase_gemv(dev):
    import torch
    from starneig_tpu_torch.ops.gpu_hess import gemv, gemv_plain
    g = torch.Generator(device="cpu").manual_seed(1)
    n, nb, row0 = 4000, 288, 1152
    A = torch.randn(n, n, generator=g, dtype=torch.float64).to(dev)
    V = torch.randn(n, nb, generator=g, dtype=torch.float64).to(dev)
    T = torch.randn(nb, nb, generator=g, dtype=torch.float64).to(dev)
    xs = {k: torch.randn(k, generator=g, dtype=torch.float64).to(dev)
          for k in (n, n - row0, nb)}
    cases = [("A x", A, xs[n], False),
             ("A[row0:, row0:] x", A[row0:, row0:], xs[n - row0], False),
             ("V^T a", V, xs[n], True),
             ("V[row0:]^T a", V[row0:], xs[n - row0], True),
             ("V y", V, xs[nb], False)]
    # the transposed mode at the panel loop's shapes: V[:, :j] (ld 288) and
    # T[:j, :j]
    for j in (1, 32, 33, 144, 288):
        cases.append((f"V[:, :{j}]^T a", V[:, :j], xs[n], True))
    for j in (32, 144, 288):
        cases.append((f"T[:{j}, :{j}]^T w", T[:j, :j], xs[nb][:j].contiguous(), True))
    err = 0.0
    for name, M, x, tr in cases:
        uk, up = gemv(M, x, tr), gemv_plain(M, x, tr)
        scale = float(gemv_plain(M.abs(), x.abs(), tr).max())
        d = float((uk - up).abs().max())
        same = torch.equal(uk, gemv(M, x, tr)) if tr else True
        log(f"  B1 {name}: max abs err {d:.2e}, relative {d / scale:.2e}"
            + ("; two launches bit-for-bit equal" if tr and same else ""))
        check(d < 1e-12 * scale, f"B1 {name} disagrees: {d}")  # summation order
        check(same, f"B1 {name}: two launches differ")
        err = max(err, d)
    ms = cuda_ms(lambda: gemv(A, xs[n]), 50)
    pms = cuda_ms(lambda: gemv_plain(A, xs[n]), 50)
    lms = cuda_ms(lambda: torch.mv(A, xs[n]), 50)
    bms, by = bound(8 * (n * n + 2 * n), 2 * n * n)
    log(f"  B1 n=4000 A x: kernel {ms:.4f} ms, plain {pms:.4f} ms, torch.mv "
        f"{lms:.4f} ms, bound {bms:.4f} ms ({by})")
    # transposed mode against M.T @ x (cuBLAS), in turns kernel, library,
    # library, kernel: CUDA events over 200 calls back to back (the host's
    # launch rate bounds these small calls), then the device time of 200
    # calls under the profiler
    trans = {}
    for name, M, x in ([(f"V[:, :{j}]", V[:, :j], xs[n]) for j in (1, 32, 144, 288)]
                       + [(f"T[:{j}, :{j}]", T[:j, :j], xs[nb][:j].contiguous())
                          for j in (32, 144, 288)]):
        kern = lambda: gemv(M, x, True)          # noqa: E731
        libr = lambda: torch.mv(M.T, x)           # noqa: E731
        t = [cuda_ms(f, 200) for f in (kern, libr, libr, kern)]
        d = [device_ms(f, 200) for f in (kern, libr, libr, kern)]
        r, c = M.shape
        tb, tby = bound(8 * (r * c + r + c), 2 * r * c)
        trans[name] = dict(kernel_ms=[t[0], t[3]], library_ms=[t[1], t[2]],
                           kernel_device_ms=[d[0], d[3]],
                           library_device_ms=[d[1], d[2]],
                           bound_ms=tb, bound_by=tby)
        fmt = lambda v: "n/a" if v is None else f"{v:.4f}"     # noqa: E731
        log(f"  B1 {name}^T x ({r}x{c}): kernel {t[0]:.4f}/{t[3]:.4f} ms, "
            f"M.T @ x {t[1]:.4f}/{t[2]:.4f} ms; device time kernel "
            f"{fmt(d[0])}/{fmt(d[3])} ms, M.T @ x {fmt(d[1])}/{fmt(d[2])} ms; "
            f"bound {tb:.5f} ms ({tby})")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=by, detail=dict(trans=trans))


def phase_francis(dev):
    import numpy as np
    import torch
    from starneig_tpu_torch.ops import small_schur
    from starneig_tpu_torch.ops.gpu_schur import francis
    from starneig_tpu_torch.ops.small_schur import _small_schur_plain
    from starneig_tpu_torch.testing.hooks import schur_form_error
    err = 0.0
    # (w, active m, seed): a fresh window, an n=200-geometry window with a
    # shorter active block, and the n=4000 main path's window (WA = 322)
    for w, m, seed in ((40, 40, 0), (40, 31, 1), (322, 322, 2)):
        Hn = hessenberg_np(w, seed)
        Hn[m:, :] = 0.0
        Hn[:, m:] = 0.0
        H = torch.from_numpy(Hn).to(dev)
        Z = torch.eye(w, dtype=torch.float64, device=dev)
        th = U / 2 * float(np.linalg.norm(Hn))
        Sk, Zk, ik = francis(H, Z, m, th)
        # the plain twin's chase steps: a sweep over [l, i] runs i - l
        with tally(small_schur, "_sweep", lambda Hp, Zp, l, i, *a: i - l) as steps:
            (Sp, Zp, ip), plain_ms = timed(lambda: _small_schur_plain(H, Z, m, th))
        steps = steps[0]
        check(int(ik) == 0 and int(ip) == 0, f"B2 w={w}: info {int(ik)} {int(ip)}")
        form_k, form_p = schur_form_error(Sk), schur_form_error(Sp)
        Skn, Zkn = Sk.cpu().numpy(), Zk.cpu().numpy()
        nh = np.linalg.norm(Hn)
        res = np.linalg.norm(Zkn @ Skn @ Zkn.T - Hn) / nh / U
        orth = np.linalg.norm(Zkn @ Zkn.T - np.eye(w)) / np.sqrt(w) / U
        d = float(np.abs(block_eigs(Sk, m) - block_eigs(Sp, m)).max())
        elem = float((Sk - Sp).abs().max()) / nh
        log(f"  B2 w={w} m={m}: Schur form error kernel {form_k} plain {form_p}; "
            f"block eigenvalues max abs err {d:.2e} ({d / nh:.2e} |H|); "
            f"kernel residual {res:.1f}u orth {orth:.1f}u; S diff {elem:.2e} |H| "
            f"(the deflation order may differ by roundoff)")
        # both outputs standardized quasi-triangular; the eigenvalues of the
        # two backward-stable solves agree to the eigenvalue condition
        # times u, and random windows stay below 1e-10 |H|
        check(form_k == 0.0 and form_p == 0.0, f"B2 w={w}: S not in Schur form")
        check(d < 1e-10 * nh and res < GATE_U and orth < GATE_U,
              f"B2 w={w} fails")
        err = max(err, d)
    ms = cuda_ms(lambda: francis(H, Z, 322, th), 3)
    # a step's 3-element reflector updates rows k..k+2 right of column k-1,
    # H's rows 0..k+3 and Z's w rows in columns k..k+2: 14 flops an entry
    # triple over 2w + 7 triples
    bms, by = bound(8 * 4 * w * w, steps * 14 * (2 * w + 7))
    floor_ms = steps * CHAIN_US * 1e-3
    log(f"  B2 w=322 window solve: kernel {ms:.1f} ms, plain {plain_ms:.1f} ms; "
        f"{steps} chase steps ({ms / steps * 1e3:.3f} us a step); roofline "
        f"{bms:.4f} ms ({by}); serial floor {floor_ms:.1f} ms (steps x "
        f"{CHAIN_US} us of reflector chain)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, detail=dict(steps=steps, serial_floor_ms=floor_ms))


def _hop_case(B, G, seed, dev, subdiag=False):
    """G windows with trains at different hops, one of them parked.  A
    train that introduces its bulges at l_rel meets W[l_rel, l_rel - 1] = 0,
    as a sweep gives it (a sweep starts at a zero subdiagonal); with
    subdiag that entry keeps its random value, the input on which B3 runs
    its full ranges."""
    import numpy as np
    import torch
    WC, HOP = 6 * B + 4, 3 * B
    rng = np.random.default_rng(seed)
    W = np.stack([hessenberg_np(WC, seed + g) for g in range(G)])
    sh = rng.standard_normal((G, B, 4))
    sh[:, :, 3] = -sh[:, :, 1]
    first = 3 * (B - 1) + 1
    trains = [(first, WC + 40, 0), (1, 0, 0), (first - HOP, WC + 40, HOP),
              (first - HOP, first + HOP // 2, HOP)]
    trains = (trains * G)[:G]
    l_rel, ihi_rel, s0 = (list(t) for t in zip(*trains))
    if not subdiag:
        for g in range(G):
            if s0[g] == 0 and ihi_rel[g] > l_rel[g]:
                W[g, l_rel[g], l_rel[g] - 1] = 0.0
    return (torch.from_numpy(W).to(dev), torch.from_numpy(sh).to(dev),
            list(range(G)), l_rel, ihi_rel, s0, B, HOP)


# B3's inputs (B, G, subdiag): a small case; the n=4000 path's (B, TMAX) =
# (25, 5); n=10,000's B = 65 with TMAX 5; n=20,000's B = 132 with two
# trains; then (25, 5) with nonzero subdiagonals at the introductions, the
# one case of the kernel's full-range path
HOP_CASES = ((3, 4, False), (25, 5, False), (65, 5, False), (132, 2, False), (25, 5, True))


def hop_launched(case):
    """The case as a sweep launches it: without its parked trains, which
    ops/schur.py:_sweep_wave leaves out of the launch (in the kernel a
    parked train runs every step with zero reflectors over full ranges,
    the slowest block of the hop)."""
    W, sh, gidx, lr, ir, s0, B, HOP = case
    keep = [g for g in range(W.shape[0]) if (lr[g], ir[g]) != (1, 0)]
    return (W[keep].contiguous(), sh, [gidx[g] for g in keep], [lr[g] for g in keep],
            [ir[g] for g in keep], [s0[g] for g in keep], B, HOP)


def hop_sensitivity(case, Wp, Qp):
    """How far one ulp of input moves the plain twin's hop, per window:
    (max |dW| / max |W|, max |dQw|) between (Wp, Qp), the twin's result on
    the case, and its result on W with every nonzero entry moved one ulp up
    or down (seeded signs; the zeros stay)."""
    import numpy as np
    import torch
    from starneig_tpu_torch.ops.schur import _train_hop
    W, sh, gidx, lr, ir, s0, B, HOP = case
    sign = torch.from_numpy(np.random.default_rng(5).choice([-1.0, 1.0], W.shape)).to(W.device)
    Wu = torch.where(W == 0, W, torch.nextafter(W, sign * float("inf")))
    Wb, Qb = _train_hop(Wu, sh[gidx], lr, ir, s0, B, HOP)
    return ((Wb - Wp).abs().amax(dim=(1, 2)) / W.abs().amax(dim=(1, 2)),
            (Qb - Qp).abs().amax(dim=(1, 2)))


def hop_errors(case, Wk, Qk, Wp, Qp):
    """B3's result (Wk, Qk) on one of HOP_CASES against the plain twin's
    (Wp, Qp), per window: (max |Wk - Wp| / max |W|, max |Qk - Qp|, and the
    tolerance on each).  The same operations in another summation order
    and with other FMA contractions: 1e-12 at B < 65 (the full-range case
    included).  From B = 65 on, 1e-11, or 4 times the plain twin's own
    hop_sensitivity where that is larger: the introduction of B bulges into
    a random window amplifies a one-ulp change of its input by up to ~1e5
    (W moves by up to 1.2e-11 |W| at B = 65 and 2.3e-11 |W| at B = 132 on
    these cases, with or without the zero plant), and the kernel and the
    twin each round every step of it, up to twice such a change."""
    import torch
    W, B = case[0], case[6]
    ew = (Wk - Wp).abs().amax(dim=(1, 2)) / W.abs().amax(dim=(1, 2))
    eq = (Qk - Qp).abs().amax(dim=(1, 2))
    if B < 65:
        tw = tq = torch.full_like(ew, 1e-12)
    else:
        sw, sq = hop_sensitivity(case, Wp, Qp)
        tw, tq = (torch.clamp(4 * x, min=1e-11) for x in (sw, sq))
    return ew, eq, tw, tq


def hop_contract(W, Wk, Qk):
    """(similarity, orthogonality) of a hop's result, worst over the
    windows: ||Qw^T W Qw - W2||_F / ||W||_F and ||Qw^T Qw - I||_F.  The
    plain twin gives at most 2.2e-15 and 7.9e-14 on HOP_CASES (CPU), so the
    kernel is held to 1e-13 and 1e-12."""
    import numpy as np
    sim = orth = 0.0
    for g in range(W.shape[0]):
        Wn, Wo, Q = (x[g].cpu().numpy() for x in (W, Wk, Qk))
        sim = max(sim, np.linalg.norm(Q.T @ Wn @ Q - Wo) / np.linalg.norm(Wn))
        orth = max(orth, np.linalg.norm(Q.T @ Q - np.eye(len(Q))))
    return sim, orth


def hop_chain_ms(B):
    """B3's serial floor for one hop: HOP = 3B steps, each at least one
    bulge's reflector plus the W updates it waits for (HOP_STEP_CYCLES)."""
    return 3 * B * HOP_STEP_CYCLES / SM_HZ * 1e3


def phase_train_hops(dev):
    from starneig_tpu_torch.ops.gpu_schur import train_hops
    from starneig_tpu_torch.ops.schur import _train_hop
    err, detail, cases = 0.0, {}, {}
    for B, G, subdiag in HOP_CASES:
        case = _hop_case(B, G, 11 + B, dev, subdiag)
        W, sh, gidx, lr, ir, s0, B_, HOP = case
        if not subdiag:
            cases[B] = case
        Wk, Qk = train_hops(W, sh, gidx, lr, ir, s0, B_, HOP)
        Wp, Qp = _train_hop(W, sh[gidx], lr, ir, s0, B_, HOP)
        ew, eq, tw, tq = hop_errors(case, Wk, Qk, Wp, Qp)
        parked = torch_equal_parked(W, Wk, lr, ir)
        sim, orth = hop_contract(W, Wk, Qk)
        label = f"B3 B={B} WC={6 * B + 4} G={G}" + (
            ", nonzero subdiagonals (full ranges)" if subdiag else "")
        log(f"  {label}: max err by window (error/tolerance) W relative to |W| "
            + ", ".join(f"{e:.1e}/{t:.1e}" for e, t in zip(ew.tolist(), tw.tolist()))
            + "; Qw " + ", ".join(f"{e:.1e}/{t:.1e}" for e, t in zip(eq.tolist(), tq.tolist()))
            + f"; similarity {sim:.2e}, orthogonality {orth:.2e}; parked train equal {parked}")
        check(bool((ew <= tw).all()) and bool((eq <= tq).all()) and parked,
              f"{label} disagrees")
        check(sim < 1e-13 and orth < 1e-12, f"{label} breaks the contract")
        err = max(err, float((Wk - Wp).abs().max()), float(eq.max()))
    # timed as a sweep launches the trains: the parked one left out
    for B in (25, 65, 132):
        W, sh, gidx, lr, ir, s0, B_, HOP = hop_launched(cases[B])
        G = W.shape[0]
        ms = cuda_ms(lambda: train_hops(W, sh, gidx, lr, ir, s0, B_, HOP), 20 if B < 100 else 5)
        pms = cuda_ms(lambda: _train_hop(W, sh[gidx], lr, ir, s0, B_, HOP), 2 if B < 100 else 1)
        # active bulge steps: each updates 3 rows and 3 columns of its window
        # and 3 columns of Qw, 14 flops an entry triple
        WC = W.shape[1]
        active = sum(lr[g] <= lr[g] + s0[g] + t - 3 * b <= ir[g] - 2
                     for g in range(G) for t in range(HOP) for b in range(B_))
        bms, by = bound(8 * 3 * G * WC * WC, active * 14 * 3 * WC)
        chain = hop_chain_ms(B)
        log(f"  B3 one hop, B={B} WC={WC} G={G}: kernel {ms:.3f} ms ({ms / HOP * 1e3:.2f} us "
            f"a step), plain {pms:.1f} ms, {active} bulge steps, bound {bms:.4f} ms ({by}), "
            f"serial chain {chain:.4f} ms ({HOP} steps x {HOP_STEP_CYCLES} cycles)")
        detail[f"B={B}"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                serial_chain_ms=chain)
    main = detail["B=25"]
    return dict(max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], detail=detail)


def torch_equal_parked(W, Wk, l_rel, ihi_rel):
    """Every parked train's window (l_rel = 1, ihi_rel = 0) left as it was."""
    import torch
    return all(torch.equal(Wk[g], W[g]) for g in range(W.shape[0])
               if (l_rel[g], ihi_rel[g]) == (1, 0))


def _deflate_case(WA, w, seed, dev, plants=None):
    """A Schur-form window with planted 2x2 blocks; (40, 40, 5, (6, 14, 30))
    is the input of tests/test_pallas_kernels.py:107-115."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    T = np.zeros((WA, WA))
    T[:w, :w] = np.triu(rng.standard_normal((w, w)))
    for p in plants or range(6, w - 2, 8):
        T[p + 1, p] = -abs(rng.standard_normal())
        T[p, p + 1] = abs(rng.standard_normal())
    V = np.eye(WA)
    V[:w, :w], _ = np.linalg.qr(np.eye(w) + 0.05 * rng.standard_normal((w, w)))
    return torch.from_numpy(T).to(dev), torch.from_numpy(V).to(dev)


def _deflate_reject_case(WA, w, seed, gap, dev):
    """A window whose first move is rejected after `gap` accepted swaps:
    the bottom 2x2 block and its exact twin `gap` rows above it (as
    testing/generators.py:planted_windows plants a rejected swap), the 1x1
    blocks between uncoupled from the bottom block's columns, so the block
    reaches its twin unchanged and their Sylvester equation is singular."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    T = np.zeros((WA, WA))
    T[:w, :w] = np.triu(rng.standard_normal((w, w)))
    b, t = w - 2, w - 4 - gap
    for p in range(6, t - 2, 8):
        T[p + 1, p] = -abs(rng.standard_normal())
        T[p, p + 1] = abs(rng.standard_normal())
    for r in (b, t):
        T[r:r + 2, r:r + 2] = [[1.0, 2.0], [-0.5, 1.0]]
    T[t + 2:b, b:b + 2] = 0.0
    T[t:t + 2, b:b + 2] = [[3.0, -1.0], [2.0, 5.0]]
    V = np.eye(WA)
    V[:w, :w], _ = np.linalg.qr(np.eye(w) + 0.05 * rng.standard_normal((w, w)))
    return torch.from_numpy(T).to(dev), torch.from_numpy(V).to(dev)


# B4's inputs: (label, WA, w, make(dev) -> (T, V)).  The planted w=40 case;
# the main path's WA=322 buffer with a 60-row active window (as when the
# segment is short); the full w=322 window, where no spike entry deflates
# and every block moves; two moves rejected mid-segment, the second in the
# move's second segment (40 swaps > the engine's 32 a segment).
DEFLATE_CASES = (
    ("w=40", 40, 40, lambda dev: _deflate_case(40, 40, 5, dev, (6, 14, 30))),
    ("w=60", 322, 60, lambda dev: _deflate_case(322, 60, 5, dev)),
    ("w=322", 322, 322, lambda dev: _deflate_case(322, 322, 6, dev)),
    ("w=322, rejected after 20 swaps", 322, 322,
     lambda dev: _deflate_reject_case(322, 322, 9, 20, dev)),
    ("w=60, rejected after 40 swaps", 322, 60,
     lambda dev: _deflate_reject_case(322, 60, 9, 40, dev)),
)
DEFLATE_S, DEFLATE_TH = 0.8, 1e-13


def similarity_residual(T, V, Tk, Vk):
    """||Us^T T Us - Tk||_F / ||T||_F in units of u, Us = V^T Vk: how far
    (Tk, Vk) is from a similarity of (T, V)."""
    import numpy as np
    Tn, Vn, Tkn, Vkn = (x.cpu().numpy() for x in (T, V, Tk, Vk))
    Us = Vn.T @ Vkn
    return np.linalg.norm(Us.T @ Tn @ Us - Tkn) / np.linalg.norm(Tn) / U


def deflate_check(label, T, V, out, ref):
    """Hold a B4 result out = (T, V, kbot, fail) to the plain twin's ref:
    the same integers, T and V within 1e-10 relative, a similarity residual
    < 500 u.  Returns (max abs err, residual in u)."""
    Tk, Vk, kk, fk = out
    Tp, Vp, kp, fp = ref
    check(int(kk) == int(kp) and int(fk) == int(fp),
          f"B4 {label}: kbot/fail {int(kk)},{int(fk)} vs {int(kp)},{int(fp)}")
    scale = float(T.abs().max())
    dt, dv = float((Tk - Tp).abs().max()), float((Vk - Vp).abs().max())
    res = similarity_residual(T, V, Tk, Vk)
    # the same swap sequence; FMA contraction, summation order and the
    # flushes' accumulated transforms change the rounding only
    check(dt < 1e-10 * scale and dv < 1e-10 and res < GATE_U,
          f"B4 {label} disagrees: T {dt}, V {dv}, residual {res}u")
    return max(dt, dv), res


def phase_deflate(dev):
    from starneig_tpu_torch.ops import schur
    from starneig_tpu_torch.ops.gpu_schur import aed_deflate
    from starneig_tpu_torch.ops.schur import _aed_deflate
    err = 0.0
    s, th = DEFLATE_S, DEFLATE_TH
    plain_ms, nswaps, chain_ms, inputs = {}, {}, {}, {}
    for label, WA, w, make in DEFLATE_CASES:
        T, V = make(dev)
        inputs[label] = (T, V, w)
        out = aed_deflate(T, V, s, w, th)
        # each swap of a p- and a q-block applies an m x m transform (m =
        # p + q) to m rows and m columns of T and m columns of V: at least
        # (2m - 1) flops an entry over m (2 WA + m) entries
        with tally(schur, "swap_adjacent",
                   lambda T4, p, q: (2 * (p + q) - 1) * (p + q) * (2 * WA + p + q)) \
                as flops, tally(schur, "swap_adjacent", lambda *a: 1) as swaps, \
                tally(schur, "swap_adjacent", lambda T4, p, q: SWAP_CYCLES[p, q]) as cyc:
            ref, plain_ms[label] = timed(lambda: _aed_deflate(T, V, s, w, th))
        nswaps[label], chain_ms[label] = swaps[0], cyc[0] / SM_HZ * 1e3
        d, res = deflate_check(label, T, V, out, ref)
        log(f"  B4 WA={WA} {label}: {swaps[0]} swaps; kbot {int(out[2])} fail "
            f"{int(out[3])}, max abs err {d:.2e} (|T| {float(T.abs().max()):.2f}), "
            f"kernel similarity residual {res:.1f}u")
        if label == "w=322":
            w322_flops = flops[0]
        err = max(err, d)
    times = {}
    for label in ("w=322", "w=60"):
        T, V, w = inputs[label]
        times[label] = cuda_ms(lambda: aed_deflate(T, V, s, w, th), 3 if w > 60 else 5)
    ms, ms60 = times["w=322"], times["w=60"]
    bms, by = bound(8 * 4 * 322 * 322, w322_flops)
    log(f"  B4 WA=322 w=322: kernel {ms:.1f} ms ({ms / nswaps['w=322'] * 1e3:.2f} us a "
        f"swap), plain {plain_ms['w=322']:.1f} ms; w=60: kernel {ms60:.2f} ms "
        f"({ms60 / nswaps['w=60'] * 1e3:.2f} us a swap), plain {plain_ms['w=60']:.1f} "
        f"ms; w=322 bound {bms:.4f} ms ({by}); serial chain {chain_ms['w=322']:.1f} ms "
        f"at w=322, {chain_ms['w=60']:.2f} ms at w=60 (swaps x swap_adjacent cycles)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms["w=322"], bound_ms=bms,
                bound_by=by,
                detail=dict(w60_ms=ms60, w60_plain_ms=plain_ms["w=60"], swaps=nswaps,
                            us_a_swap={k: times[k] / nswaps[k] * 1e3 for k in times},
                            serial_chain_ms=chain_ms))


def recondense_contract(T, V0, s, kbot, To, Vo, beta):
    """How far (To, Vo, beta) is from a recondense of (T, V0): similarity
    residual, orthogonality, structure below the subdiagonal of the
    reduced block, and the spike's distance from beta e1."""
    import numpy as np
    Us = V0.T @ Vo
    res = np.linalg.norm(Us.T @ T @ Us - To) / np.linalg.norm(T)
    orth = np.linalg.norm(Us.T @ Us - np.eye(len(T)))
    struct = np.abs(np.tril(To[:kbot, :kbot], -2)).max(initial=0.0)
    spike = Us.T @ np.where(np.arange(len(T)) < kbot, s * V0[0], 0.0)
    sp = max(abs(spike[0] - beta), np.abs(spike[1:kbot]).max(initial=0.0))
    return res, orth, struct, sp


def recondense_window(WA, near, dev):
    """B5's input as an AED round gives it at window size WA: the
    Hessenberg form of a seeded dense matrix, solved by B2, and kbot the
    block boundary at `near` (near + 1 if a 2x2 block straddles it).
    Returns (T, V, kbot)."""
    import numpy as np
    import torch
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.ops.gpu_schur import francis
    Hw, _ = sep.hessenberg(np.random.default_rng(2).standard_normal((WA, WA)),
                           device=dev)
    Sw, Zw, info = francis(Hw, torch.eye(WA, dtype=torch.float64, device=dev),
                           WA, U / 2 * float(torch.linalg.norm(Hw)))
    check(int(info) == 0, f"B5 input WA={WA}: window solve failed")
    return Sw, Zw, near if float(Sw[near, near - 1]) == 0 else near + 1


def recondense_checks(dev, kernel, log=log):
    """Hold kernel(T, V, s, kbot) -> (T, V, beta) (B5 or a version of it) to
    the plain twin and to the contract on B5's inputs; raises on a miss.
    Returns (max abs err, {label: (T, V, kbot)} of the timed windows)."""
    import numpy as np
    import torch
    from starneig_tpu_torch.ops.schur import _aed_recondense
    err = 0.0
    # the input of tests/test_pallas_kernels.py:74
    rng = np.random.default_rng(3)
    T = np.triu(rng.standard_normal((40, 40)))
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    Td, Qd = torch.as_tensor(T, device=dev), torch.as_tensor(Q, device=dev)
    for kbot in (10, 1, 0):
        Tk, Vk, bk = kernel(Td, Qd, 0.37, kbot)
        Tp, Vp, bp = _aed_recondense(Td, Qd, 0.37, kbot)
        dt, dv = float((Tk - Tp).abs().max()), float((Vk - Vp).abs().max())
        db = abs(float(bk) - float(bp))
        log(f"  B5 WA=40 kbot={kbot}: max abs err T {dt:.2e} V {dv:.2e} beta {db:.2e}")
        # the same reflectors in another summation order
        check(dt <= 1e-12 * np.abs(T).max() and dv <= 1e-12 and db <= 1e-12,
              f"B5 kbot={kbot} disagrees")
        err = max(err, dt, dv, db)
    # kbot=25 on this input reduces to a subdiagonal of 3.8e-10 (ROADMAP
    # section C): past it the Hessenberg form is not determined by
    # roundoff-level data, so both sides are held to the contract there
    Tk, Vk, bk = kernel(Td, Qd, 0.37, 25)
    Tp, Vp, bp = _aed_recondense(Td, Qd, 0.37, 25)
    for name, To, Vo, b in (("kernel", Tk, Vk, bk), ("plain", Tp, Vp, bp)):
        res, orth, struct, sp = recondense_contract(
            T, Q, 0.37, 25, To.cpu().numpy(), Vo.cpu().numpy(), float(b))
        log(f"  B5 WA=40 kbot=25 {name}: similarity {res:.2e}, orth {orth:.2e}, "
            f"below-subdiagonal {struct}, spike {sp:.2e}")
        check(res < 1e-14 and orth < 1e-13 and struct == 0.0 and sp < 1e-13,
              f"B5 kbot=25 {name} breaks the contract")
    check(abs(float(bk) - float(bp)) <= 1e-12, "B5 kbot=25: beta differs")
    # the main path's window: the Hessenberg form of a dense matrix, solved
    # by B2 at WA=322 as an AED round does, and kbot at a block boundary
    # near 300 (the n=4000 rounds deflate a few to tens of rows).  Such a
    # window keeps its reduced subdiagonals O(1), and the recondense is
    # determined elementwise (the JAX and torch versions agree to 6e-14
    # |T| on it, against O(|T|) on a random Hessenberg window, whose
    # eigenvalues are exponentially ill-conditioned).  Then n=10,000's
    # WA=802 at kbot near 780, held to the contract: 780 reflectors of
    # length up to 780 add about sqrt(WA) WA u = 5e-13 to the similarity and
    # orthogonality in the Frobenius norm, so 1e-12 and 1e-11 there.
    cases = {}
    for WA, near, lim in ((322, 300, (1e-13, 1e-12, 1e-13)),
                          (802, 780, (1e-12, 1e-11, 1e-12))):
        Sw, Zw, kb = recondense_window(WA, near, dev)
        cases[f"WA={WA}"] = (Sw, Zw, kb)
        Tk, Vk, bk = kernel(Sw, Zw, 0.3, kb)
        Tp, Vp, bp = _aed_recondense(Sw, Zw, 0.3, kb)
        scale = float(Sw.abs().max())
        dt, dv = float((Tk - Tp).abs().max()), float((Vk - Vp).abs().max())
        db = abs(float(bk) - float(bp))
        res, orth, struct, sp = recondense_contract(
            Sw.cpu().numpy(), Zw.cpu().numpy(), 0.3, kb, Tk.cpu().numpy(),
            Vk.cpu().numpy(), float(bk))
        log(f"  B5 WA={WA} kbot={kb}: max abs err T {dt:.2e} (|T| {scale:.2f}), V "
            f"{dv:.2e}, beta {db:.2e}; kernel similarity {res:.2e}, orth {orth:.2e}, "
            f"below-subdiagonal {struct}, spike {sp:.2e}")
        if WA == 322:
            # the same reflectors in another summation order, on a
            # well-determined reduction
            check(dt <= 1e-10 * scale and dv <= 1e-10 and db <= 1e-12,
                  f"B5 WA=322 disagrees: {dt}, {dv}, {db}")
            err = max(err, dt, dv, db)
        check(res < lim[0] and orth < lim[1] and struct == 0.0 and sp < lim[2],
              f"B5 WA={WA} kernel breaks the contract")
    return err, cases


def recondense_flops(WA, kb):
    """A recondense's fp64 operations: each reflector of length L on
    rows/columns lo..kbot, 4 flops an entry over T's rows right of its
    column, T's kbot rows and V's WA rows."""
    return 4 * kb * (2 * WA + kb) + sum(
        4 * (kb - j - 1) * ((WA - j) + kb + WA) for j in range(kb - 1))


def phase_recondense(dev):
    from starneig_tpu_torch.ops.gpu_schur import aed_recondense
    from starneig_tpu_torch.ops.schur import _aed_recondense
    err, cases = recondense_checks(dev, aed_recondense)
    detail = {}
    for label, (Sw, Zw, kb) in cases.items():
        WA = Sw.shape[0]
        ms = cuda_ms(lambda: aed_recondense(Sw, Zw, 0.3, kb), 5)
        _out, plain_ms = timed(lambda: _aed_recondense(Sw, Zw, 0.3, kb))
        bms, by = bound(8 * 4 * WA * WA, recondense_flops(WA, kb))
        chain = kb * RECONDENSE_STEP_CYCLES / SM_HZ * 1e3
        log(f"  B5 {label} kbot={kb}: kernel {ms:.3f} ms ({ms / kb * 1e3:.2f} us a step), "
            f"plain {plain_ms:.1f} ms, bound {bms:.4f} ms ({by}), serial chain "
            f"{chain:.3f} ms ({kb} steps x {RECONDENSE_STEP_CYCLES} cycles)")
        detail[label] = dict(kbot=kb, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             serial_chain_ms=chain)
    main = detail["WA=322"]
    return dict(max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], detail=detail)


# the bubble's inputs (G, W, seed, (dst0s, dst_limits, wlims)): small
# windows with a frozen top row, a frozen bottom row and a capped
# insertion; a batch at the n=4000 reordering's window W=160; and W=160
# windows with frozen rows at both ends and an insertion limit that stops
# a window's chain early.  Window 0 of each rejects a swap
# (testing/generators.py:planted_windows).
BUBBLE_CASES = ((3, 24, 4, ([0, 1, 0], [24, 24, 6], [24, 23, 24])),
                (2, 160, 7, ([0, 1], [160, 160], [160, 159])),
                (3, 160, 8, ([3, 1, 0], [160, 40, 160], [159, 160, 159])))


def bubble_check(label, Tw, out, ref):
    """Hold a bubble window's result out = (T, Q, sel, dst, nfail, nswaps)
    to the plain twin's ref: the same integers and selection, T and Q within
    1e-10 relative.  Returns the max abs err."""
    import numpy as np
    Tk, Qk, selk, dstk, nfk, nsk = out
    Tp, Qp, selp, dstp, nfp, nsp = ref
    check((int(dstk), int(nfk), int(nsk)) == (dstp, nfp, nsp)
          and np.array_equal(selk, selp),
          f"bubble {label}: dst/nfail/swaps/sel {(int(dstk), int(nfk), int(nsk))} "
          f"vs {(dstp, nfp, nsp)}")
    dt, dq = float((Tk - Tp).abs().max()), float((Qk - Qp).abs().max())
    # the same swap sequence; FMA contraction, summation order and the
    # flushes' accumulated transforms change the rounding only
    check(dt <= 1e-10 * float(Tw.abs().max()) and dq <= 1e-10,
          f"bubble {label}: T {dt}, Q {dq}")
    return max(dt, dq)


def phase_bubble(dev):
    import torch
    from starneig_tpu_torch.ops import reorder
    from starneig_tpu_torch.ops.gpu_reorder import window_bubble
    from starneig_tpu_torch.ops.reorder import _window_bubble
    from starneig_tpu_torch.testing.generators import planted_windows
    err = 0.0
    timed_case = {}
    for G, W, seed, lims in BUBBLE_CASES:
        Ts, sels = planted_windows(G, W, seed)
        Td = torch.as_tensor(Ts, device=dev)
        Tk, Qk, selk, dstk, nfk, nsk = window_bubble(Td, sels, *lims)
        plain_ms, chain = 0.0, 0
        for g in range(G):
            with tally(reorder, "swap_adjacent",
                       lambda T4, p, q: SWAP_CYCLES[p, q]) as cyc:
                ref, t = timed(lambda: _window_bubble(Td[g], sels[g], lims[0][g],
                                                      lims[1][g], lims[2][g]))
            plain_ms += t
            chain = max(chain, cyc[0])       # the windows run side by side
            err = max(err, bubble_check(f"W={W} window {g}", Td[g],
                                        (Tk[g], Qk[g], selk[g], dstk[g], nfk[g], nsk[g]),
                                        ref))
        check(nfk[0] >= 1, f"bubble W={W}: the planted swap was not rejected")
        log(f"  bubble G={G} W={W} dst0 {lims[0]} dst_limit {lims[1]} wlim {lims[2]}: "
            f"swaps {nsk.tolist()}, failed {nfk.tolist()}, dst {dstk.tolist()}: equal "
            f"to the plain twin; max abs err {err:.2e}")
        if (G, W) == (2, 160):
            timed_case = dict(Td=Td, sels=sels, lims=lims, nsw=int(nsk.sum()),
                              nmax=int(nsk.max()), plain_ms=plain_ms,
                              chain_ms=chain / SM_HZ * 1e3)
    Td, sels, lims = timed_case["Td"], timed_case["sels"], timed_case["lims"]
    G, W = Td.shape[0], Td.shape[1]
    ms = cuda_ms(lambda: window_bubble(Td, sels, *lims), 3)
    # each swap at least a 2 x 2 rotation of 2 rows and 2 columns of T and
    # 2 columns of Q: 3 flops an entry over 2 (2 W + 2) entries
    bms, by = bound(8 * 3 * G * W * W, timed_case["nsw"] * 6 * (2 * W + 2))
    log(f"  bubble G=2 W=160 ({timed_case['nsw']} swaps, at most {timed_case['nmax']} "
        f"a window): kernel {ms:.2f} ms ({ms / timed_case['nmax'] * 1e3:.2f} us a swap "
        f"of the longest window), plain {timed_case['plain_ms']:.1f} ms, bound "
        f"{bms:.4f} ms ({by}), serial chain {timed_case['chain_ms']:.2f} ms (the "
        f"longest window's swaps x swap_adjacent cycles)")
    return dict(max_abs_err=err, ms=ms, plain_ms=timed_case["plain_ms"], bound_ms=bms,
                bound_by=by, detail=dict(us_a_swap=ms / timed_case["nmax"] * 1e3,
                            serial_chain_ms=timed_case["chain_ms"]))


def solve(A):
    import torch
    from starneig_tpu_torch.api import sep
    sync = torch.cuda.synchronize if A.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    H, Q = sep.hessenberg(A, device=A.device)
    sync()
    t1 = time.perf_counter()
    stats = {}
    S, Q2, er, ei, info = sep.schur(H, Q, stats=stats, device=A.device)
    sync()
    t2 = time.perf_counter()
    return S, Q2, er, ei, int(info), (t1 - t0) * 1e3, (t2 - t1) * 1e3, stats


def gates(A, S, Q):
    import torch
    n = A.shape[0]
    res = float(torch.linalg.norm(Q @ S @ Q.T - A) / torch.linalg.norm(A)) / U
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    orth = float(torch.linalg.norm(Q @ Q.T - eye)) / n ** 0.5 / U
    return res, orth


def positive_real(lam):
    return lam.real > 0


def eigenvector_residual(A, S, X, m):
    """Worst ||A x - lambda x|| / (||A||_F ||x||) over the eigenvectors X of
    the leading m x m block of S (a real column per real eigenvalue, a
    (Re, Im) column pair per complex pair)."""
    import torch
    from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
    er, ei = extract_eigenvalues(S[:m, :m])
    first = ei > 0                       # the pair's (Re, Im) columns start here
    keep = first | (ei == 0)
    c = torch.arange(m, device=A.device)
    partner = torch.where(first, c + 1, c).clamp_max(m - 1)
    AX = A @ X
    Xi = torch.where(first, X[:, partner], 0.0)
    AXi = torch.where(first, AX[:, partner], 0.0)
    Rr = AX - (er * X - ei * Xi)
    Ri = AXi - (er * Xi + ei * X)
    rn = torch.sqrt((Rr * Rr + Ri * Ri).sum(0))
    xn = torch.sqrt((X * X + Xi * Xi).sum(0))
    return float((rn / (torch.linalg.norm(A) * xn))[keep].max())


def phase_reduce(dev):
    """api.sep.reduce at n=200 on the card against the port's CPU run."""
    import numpy as np
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.convert import from_numpy
    from starneig_tpu_torch.testing.hooks import schur_form_error
    A_np = np.random.default_rng(42).standard_normal((200, 200))
    Sg, Qg, _er, _ei, mg, infog = sep.reduce(from_numpy(A_np, dev), positive_real)
    Sc, Qc, _er, _ei, mc, infoc = sep.reduce(from_numpy(A_np), positive_real,
                                             device="cpu")
    na = np.linalg.norm(A_np)
    d = float(np.abs(block_eigs(Sg, mg) - block_eigs(Sc, mc)).max()) / na \
        if mg == mc else np.inf
    lead_ok = bool((block_eigs(Sg, mg).real > 0).all())
    res, orth = gates(from_numpy(A_np, dev), Sg, Qg)
    form = schur_form_error(Sg)
    want = int((np.linalg.eigvals(A_np).real > 0).sum())
    log(f"  reduce n=200: info {int(infog)}/{int(infoc)}, selected rows {mg}/{mc} "
        f"(numpy count {want}), leading eigenvalues vs CPU {d:.2e} |A|, residual "
        f"{res:.1f}u orth {orth:.1f}u, Schur form error {form}")
    # the Schur forms of the two runs differ by roundoff (B2's deflation
    # order); their leading eigenvalues agree to 1e-10 |A|
    check(int(infog) == int(infoc) == 0 and mg == mc == want and d < 1e-10
          and lead_ok and res < GATE_U and orth < GATE_U and form == 0.0,
          "reduce n=200 check fails")
    return dict(selected=mg, eig_vs_cpu=d, residual_u=res, orthogonality_u=orth)


def phase_schur_b70(dev):
    """sep.hessenberg -> sep.schur at n=1,200 with a geometry of B=70 bulges
    a train (WA=202, NS=160, B=70, WC=424, TMAX=2): B3 above the old limit
    of 64 on the main path's own calls."""
    import numpy as np
    import torch
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.convert import from_numpy, to_numpy
    from starneig_tpu_torch.testing.hooks import schur_form_error
    n = 1200
    A_np = np.random.default_rng(1200).standard_normal((n, n))
    A = from_numpy(A_np, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    H, Q = sep.hessenberg(A, device=dev)
    stats = {}
    S, Q2, er, ei, info = sep.schur(H, Q, conf=_b70_conf(), stats=stats, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    res, orth = gates(A, S, Q2)
    form = schur_form_error(S)
    geo = tuple(stats.get(k) for k in ("WA", "NS", "B", "WC", "TMAX"))
    ev = np.sort_complex(to_numpy(er) + 1j * to_numpy(ei))
    d = float(np.abs(ev - np.sort_complex(np.linalg.eigvals(A_np))).max()) / np.linalg.norm(A_np)
    log(f"  n={n} B=70: info {int(info)}, geometry (WA, NS, B, WC, TMAX) {geo}, rounds "
        f"{stats.get('rounds')}, residual {res:.1f}u orth {orth:.1f}u, Schur form error "
        f"{form}, eigenvalues vs numpy {d:.2e} |A|, launches {launches}")
    check(geo == (202, 160, 70, 424, 2), f"n={n}: geometry {geo}")
    check(int(info) == 0 and res < GATE_U and orth < GATE_U and form == 0.0,
          f"n={n} B=70 gates: info {int(info)}, {res}, {orth}, {form}")
    # a backward-stable Schur form (residual < 500 u) moves each eigenvalue
    # by at most its condition number times 500 u ||A||; the eigenvalues of a
    # random matrix stay far below 1e-10 ||A||_F (the n=200 check's bound)
    check(d < 1e-10, f"n={n} B=70: eigenvalues differ from numpy by {d}")
    check(launches["train_hops"] > 0, f"n={n} B=70: B3 was not launched")
    return dict(info=int(info), residual_u=res, orthogonality_u=orth, schur_form_error=form,
                eig_vs_numpy=d, rounds=stats.get("rounds"), launches=launches)


def phase_main(dev):
    import numpy as np
    import torch
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.convert import from_numpy, to_numpy
    from starneig_tpu_torch.errors import Error
    from starneig_tpu_torch.testing.hooks import eigenvalue_error, schur_form_error

    # small input against numpy and against the port's CPU (plain) path
    A_np = np.random.default_rng(0).standard_normal((200, 200))
    Sg, Qg, erg, eig, info_g, *_ = solve(from_numpy(A_np, dev))
    Sc, Qc, erc, eic, info_c, *_ = solve(from_numpy(A_np))
    ref = np.sort_complex(np.linalg.eigvals(A_np))
    eg = np.sort_complex(to_numpy(erg) + 1j * to_numpy(eig))
    ec = np.sort_complex(to_numpy(erc) + 1j * to_numpy(eic))
    na = np.linalg.norm(A_np)
    d_np, d_cpu = np.abs(eg - ref).max() / na, np.abs(eg - ec).max() / na
    res_s, orth_s = gates(from_numpy(A_np, dev), Sg, Qg)
    form_s = schur_form_error(Sg)
    log(f"  n=200: info {info_g}/{info_c}, eig diff vs numpy {d_np:.2e} |A|, "
        f"vs CPU port {d_cpu:.2e} |A|, residual {res_s:.1f}u orth {orth_s:.1f}u, "
        f"Schur form error {form_s}")
    check(info_g == 0 and info_c == 0 and d_np < 1e-10 and d_cpu < 1e-10
          and res_s < GATE_U and orth_s < GATE_U and form_s == 0.0,
          "n=200 check fails")

    n200_reduce = phase_reduce(dev)

    n = MAIN_N
    A = from_numpy(np.random.default_rng(0).standard_normal((n, n)), dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    S, Q2, er, ei, info, hess_ms, schur_ms, stats = solve(A)
    schur_launches = dict(kernels.LAUNCHES)
    res, orth = gates(A, S, Q2)
    finite = bool(torch.isfinite(S).all() and torch.isfinite(Q2).all())
    form = schur_form_error(S)
    log(f"  n={n}: info {info} hessenberg_ms {hess_ms:.1f} schur_ms "
        f"{schur_ms:.1f} residual_u {res:.1f} orthogonality_u {orth:.1f} "
        f"schur_form_error {form} rounds {stats.get('rounds')} "
        f"geometry {stats} launches {schur_launches}")
    check(info == 0, f"n=4000 info {info}")
    check(finite and tuple(S.shape) == (n, n), "n=4000 output not finite")
    check(form == 0.0, f"n=4000: S not in standardized Schur form ({form})")
    check(res < GATE_U and orth < GATE_U, f"n=4000 gates: {res}, {orth}")

    # the same (S, Q) through select -> reorder_schur -> eigenvectors, with
    # the counts read for this path alone
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sel = sep.select(S, positive_real)
    select_ms = (time.perf_counter() - t0) * 1e3
    rstats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S2, Q3, m, rinfo = sep.reorder_schur(S, Q2, sel, stats=rstats)
    torch.cuda.synchronize()
    reorder_ms = (time.perf_counter() - t0) * 1e3
    lead = np.arange(n) < m
    t0 = time.perf_counter()
    X, xinfo = sep.eigenvectors(S2, Q3, lead)
    torch.cuda.synchronize()
    eigenvectors_ms = (time.perf_counter() - t0) * 1e3
    chain_launches = dict(kernels.LAUNCHES)
    launches = {k: schur_launches[k] + chain_launches[k] for k in schur_launches}

    res2, orth2 = gates(A, S2, Q3)
    form2 = schur_form_error(S2)
    before = to_numpy(er) + 1j * to_numpy(ei)
    er2, ei2 = sep.eigenvalues(S2)
    after = to_numpy(er2) + 1j * to_numpy(ei2)
    moved = eigenvalue_error(after, before) * U
    lead_ok = bool((after[:m].real > 0).all())
    evec = eigenvector_residual(A, S2, X, m)
    log(f"  n={n} reorder: info {int(rinfo)} selected {int(sel.sum())} rows, "
        f"leading block {m} rows, reorder_ms {reorder_ms:.1f} (select_ms "
        f"{select_ms:.1f}), stats {rstats}, residual_u {res2:.1f} "
        f"orthogonality_u {orth2:.1f} schur_form_error {form2}, eigenvalues "
        f"moved {moved:.2e} max|lambda|")
    log(f"  n={n} eigenvectors: info {int(xinfo)}, {tuple(X.shape)}, "
        f"eigenvectors_ms {eigenvectors_ms:.1f}, worst residual {evec:.2e}; "
        f"launches {chain_launches}")
    check(rinfo in (Error.SUCCESS, Error.PARTIAL_REORDERING), f"reorder info {rinfo}")
    if rinfo == Error.PARTIAL_REORDERING:
        log(f"  PARTIAL_REORDERING: {rstats.get('failed_swaps')} failed swaps")
    else:
        check(m == int(sel.sum()), f"leading block {m} != {int(sel.sum())}")
    check(form2 == 0.0, f"reordered S not in standardized Schur form ({form2})")
    check(res2 < GATE_U and orth2 < GATE_U, f"reorder gates: {res2}, {orth2}")
    check(lead_ok, "a leading eigenvalue fails the predicate")
    check(moved < EIG_MOVE, f"the reordering moved eigenvalues by {moved}")
    check(xinfo in (Error.SUCCESS, Error.CLOSE_EIGENVALUES), f"eigenvectors info {xinfo}")
    check(tuple(X.shape) == (n, m) and bool(torch.isfinite(X).all()),
          "eigenvectors: wrong shape or not finite")
    check(evec < EVEC_BOUND, f"eigenvector residual {evec}")
    for k in SCHUR_KERNELS:
        check(schur_launches[k] > 0, f"kernel {k} was not launched by Hessenberg -> Schur")
    check(chain_launches["reorder_bubble"] > 0,
          "kernel reorder_bubble was not launched by the reordering")
    return dict(info=info, hessenberg_ms=hess_ms, schur_ms=schur_ms,
                residual_u=res, orthogonality_u=orth, schur_form_error=form,
                stats=stats, schur_launches=schur_launches,
                reorder=dict(info=int(rinfo), selected=int(sel.sum()), lead=m,
                             reorder_ms=reorder_ms, select_ms=select_ms,
                             stats=rstats, residual_u=res2,
                             orthogonality_u=orth2, schur_form_error=form2,
                             eig_moved=moved),
                eigenvectors=dict(info=int(xinfo), eigenvectors_ms=eigenvectors_ms,
                                  worst_residual=evec),
                launches=launches, n200=dict(eig_vs_numpy=d_np,
                                             eig_vs_cpu=d_cpu, residual_u=res_s,
                                             orthogonality_u=orth_s),
                n200_reduce=n200_reduce)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write all results as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import starneig_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    log("== 1. device")
    smi = phase_device()
    log("== 2. build")
    build_s = phase_build()
    log("== 3. kernels against their plain versions")
    results = {"hess_gemv": phase_gemv(dev), "francis": phase_francis(dev),
               "train_hops": phase_train_hops(dev),
               "aed_deflate": phase_deflate(dev),
               "recondense": phase_recondense(dev),
               "reorder_bubble": phase_bubble(dev)}
    log("== 4. n=1200 with B=70")
    b70 = phase_schur_b70(dev)
    log("== 5. main path")
    main_res = phase_main(dev)

    table = [dict(name=k, route="cuda", source=SOURCES[k],
                  replaces=REPLACES[k], launches=main_res["launches"][k],
                  max_abs_err=r["max_abs_err"], ms=r["ms"],
                  plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                  bound_by=r["bound_by"], library_ms=r.get("library_ms"))
             for k, r in results.items()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=smi, build_s=build_s, kernels=results, n1200_b70=b70, main=main_res,
                 torch=torch.__version__, cuda=torch.version.cuda),
            indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
