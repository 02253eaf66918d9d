#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises; the exit code is then nonzero):

  1. device: requires CUDA; prints torch, CUDA, nvcc and the card's name
     and power limit (nvidia-smi);
  2. build: compiles the hand-written kernels from
     starneig_tpu_torch/kernels/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch twin, at small shapes
     and at the shapes the n=4000 main path gives it, with the tolerances
     stated below; CUDA-event times of the kernels, host times of the
     plain twins, which run on CPU copies of the inputs (host loops of
     small torch calls run several times faster there; B1, B3 and B5's
     twins run on the card, their one timed run at the main path's shape
     after their runs at the smaller shapes, which serve as the warm-up);
     each kernel's
     bound (bytes over HBM_BPS or fp64 operations over F64_FLOPS, counted
     from this run's inputs), and under each kernel's detail its serial
     chain from cycle counts of earlier runs (chip_ab.py clock); B1 in
     both modes checked bit-for-bit across two launches, its A x mode on
     the panel matvec (4000 x 4000) and a DM rank's column shard (4000 x
     2000) beside torch.mv in turns by CUDA events, on the panel arrays'
     4000 x j views and T[:j, :j] beside torch.mv, and its transposed
     mode there beside M.T @ x, in turns, by CUDA events and by profiler
     device time;
     B2's chase steps; B3 at B = 3, 25, 65 and 132 (the n=4000, 10,000 and
     20,000 geometries) with the zero plant a sweep gives at each
     introduction, and at B = 25 without it (the full-range path); B4's and
     the bubble's swaps, microseconds a swap and serial-chain floor (swaps x
     SWAP_CYCLES), on inputs that include rejected swaps mid-segment, frozen
     rows and an insertion limit; B5 at WA=40, 322 and 802; the GEP
     kernels against their plain twins (run on CPU copies of the inputs):
     G1 (blocked) at n=192 against the unblocked plain cascade, its
     generation kernel and its sliver kernel against their plain twins on
     the first block of n=2000, and G1 in window mode (the GEP AED
     recondense, a chain and a replay launch, its own launch count) at
     WA=84, 162 and 322 at kbot 0, 1, 2, 3, 10 (elementwise against the
     plain twin), WA-4 and WA (by contract), at WA=802 and 1000 by
     contract, and with its shared memory capped at WA=162 (the layouts of
     a large kbot, bit-equal to the uncapped launch), G2 at w=84 (with and without 8 infinite
     eigenvalues) and 162 by contract against its twin, and at w=322 (the
     n=4000 path's window) by contract alone, microseconds a chase step
     (the kernel's own count), G3 for a whole train at n=512 and on the
     introduction, a middle and the last hop of a train at n=200 and on an
     introduction hop with S[l_rel, l_rel - 1] != 0 (the full ranges),
     microseconds a step and the serial chain of the middle hop, G4 at WA=84, 162 and 322 and on two windows whose first move is
     rejected after 20 and 40 swaps (kbot, fail and steps equal),
     microseconds a swap, G5 (the
     infinite push's window chase) at Wb=96 and 84, with no step and on a
     push's last, short window, G6 (the pencil window
     bubble) on planted windows at W=16 and 128 (2x2 blocks, exact
     T-diagonal zeros, frozen rows, an insertion limit, a rejected swap;
     every integer equal); G1 also at
     the GEP path's n=2000 on a regular pencil (A and B Gaussian, B made
     triangular, seed 2000): the kernel here, its plain twin in a child
     process started at the top of this phase, which runs on the host
     while the later phases use the card (compared in phase 9);
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
     kernel of a path launched at least once there;
  6. GEP path: known_spectrum_pencil(2000, complex_ratio=0.3, inf_ratio=0.1,
     seed=0) through api.gep.hessenberg_triangular and api.gep.schur, gated
     on info, residuals and orthogonality < 500 u and exact structure,
     printing the zero betas and the chordal error against the planted
     spectrum, the rounds, the infinite-push rounds and calls, and the
     launch counts (zeroed before the path, read after it; every GEP kernel
     at least once); the HT phase runs first under torch.profiler (each
     kernel's device total and launches, G1's time, the cold call's time),
     then warm outside it (ht_ms), the QZ phase again under it afterwards
     (each kernel's device total, G2's, G3's, G4's, G1's window mode's
     (below 150 ms) and G5's with their launches, the sweeps' time and
     G3's device idle share of it);
     then api.gep.select (finite, Re(alpha/beta) > 0), api.gep.reorder_schur
     and api.gep.eigenvectors of the leading selected block, gated on info,
     exact structure, 500 u, the leading rows holding exactly the selected
     eigenvalues, the spectrum kept (1e-10 chordal) and the eigenvector
     residuals, the launch counts zeroed before and read after (G6 at
     least once);
  7. GEP n=512 infinite-rich: api.gep.schur on tests/test_qz_driver.py's
     HT pencil with 51 exact T-diagonal zeros, under that test's gates (G5
     launched); then its infinite eigenvalues (|beta| <= 1e-12 max|beta|)
     reordered to the top (all of them leading, as the JAX package leaves
     them) and their eigenvectors, gated on ||B x|| / (||B||_F ||x||);
  8. the CLI: python -m starneig_tpu_torch.cli --experiment full-chain
     --generalized --init known --complex-ratio 0.3 --inf-ratio 0.1
     --n 512 in a child process, exit code 0 and no hook line failed;
  9. G1 at the GEP path's shape: phase 3's n=2000 result against the
     plain cascade of the child process, within 1e-11 max|M|; G1's row in
     the kernel table is this n=2000 run.  (The GEP path's own pencil has
     a singular B, where the cascade is ill-conditioned elementwise: one
     ulp of input moves its result by more than 1e-10 already at n=192,
     tests/test_torch_gep_ht.py::test_ht_one_ulp; the path is held to its
     gates instead.)
 10. DM: the distributed interface in gloo ranks that share the card
     (starneig_tpu_torch.testing.dm.run_ranks; rank 0 owns the window math
     and the eigenvectors).  10a: phase 5's n=4000 input on 2 ranks
     through api.sep_dm.hessenberg (column shards, B1 on every rank),
     schur (column shards), select (Re(lambda) > 0), reorder_schur
     (column shards) and eigenvectors of the leading block, each stage
     timed to a barrier, gated on info, residual and orthogonality < 500
     u and the standardized Schur form before and after reordering, the
     leading block, the spectrum kept, the eigenvector residuals, H and Q
     against phase 5's (DM_HESS_TOL), the ranks' V/T hashes equal, the
     spectrum against phase 5's (1e-10 max|lambda| after matching), the
     rounds within 2 of phase 5's, each rank's Schur shard (NP, NP/2) and
     the launches (zeroed in each rank before the job, read after it:
     rank 0 launched B1-B5 and the bubble, rank 1 B1 alone); prints each
     stage's time, each rank's B1 launches and each rank's collectives
     (calls, bytes, seconds) by stage.  10b: on 4 ranks,
     api.sep_dm.reduce at n=1200 and api.gep_dm.reduce of
     known_spectrum_pencil(512, 0.3, 0.1, seed 0) (finite, Re(alpha/beta)
     > 0) under the gates of phases 5 and 6, with the same launch rule.
 11. tools and examples: phase 5's stages at n=512 with the sanity checks
     on and each stage in a trace span, the trace dumped and parsed; then
     the three examples (python -m starneig_tpu_torch.examples.<name>)
     and python -m starneig_tpu_torch.tools.dryrun 2 (n=512) in child
     processes, all at once.

The smoke prints its total wall seconds.  The line before the last is the kernel table as JSON; the last line is
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
# G2's chain a chase step by window size, in cycles: the chase warp's two
# reflectors, left update, rotation and the next column's shuffle
# (clock64 counters, chip_ab.py clock qz, PERF.md section 6); steps x
# these over SM_HZ is its serial floor
QZ_STEP_CYCLES = {162: 2939, 322: 3072}
# B3's chain a step and B5's a reduction step, in cycles (clock64 counters
# in instrumented copies of the kernels as shipped, chip_ab.py clock hops /
# recondense, PERF.md section 6): the reflectors' phase of a hop step at B=25 (the shortest over
# the trains), and a recondense step's gather and dlarfg, the partial
# products, the cluster barrier and the sum at WA=322, kbot=300
HOP_STEP_CYCLES = 2725
RECONDENSE_STEP_CYCLES = 6648
# G3's chain a step at B=12, in cycles: a chase warp's three dependent
# transforms (the left reflector, then the right reflector and the
# rotation; the largest over the chase warps), clock64 counters
# (chip_ab.py clock qzsweep, PERF.md section 6)
QZSWEEP_STEP_CYCLES = 4142
# G1's window mode's chain a rotation pair (WA=162, kbot=158) and G5's a
# step (Wb=96), in cycles: warp 0's left rotations and right chain (phases
# A and C), and the chase warp's two rotations formed a step (clock64
# counters, chip_ab.py clock htwin / clock infchase, PERF.md section 6)
HTWIN_PAIR_CYCLES = 1201
INF_STEP_CYCLES = 611

REPLACES = {
    "hess_gemv": "starneig_tpu/ops/pallas_hess.py:45",
    "francis": "starneig_tpu/ops/pallas_schur.py:131",
    "train_hops": "starneig_tpu/ops/pallas_schur.py:537",
    "aed_deflate": "starneig_tpu/ops/pallas_schur.py:797",
    "recondense": "starneig_tpu/ops/pallas_schur.py:1109",
    # no Pallas kernel there: the JAX package ran the bubble as an XLA
    # while-loop (_run_bubble_b), which the TPU executed
    "reorder_bubble": "starneig_tpu/ops/reorder.py:156",
    # the GEP path has no Pallas kernel either: G1-G4 replace its serial XLA
    # loops (the HT cascade and its window mode, the AED recondense; the
    # window QZ machine, the QZ train sweep, the GEP spike deflation's moves)
    "ht_cascade": "starneig_tpu/ops/hess_triangular.py:36",
    "ht_recondense": "starneig_tpu/ops/qz_driver.py:166",
    "qz_window": "starneig_tpu/ops/qz.py:215",
    "qz_sweep": "starneig_tpu/ops/qz_driver.py:444",
    "aed_deflate_gep": "starneig_tpu/ops/qz_driver.py:121",
    # the infinite push's window chase (a fori_loop) and the pencil window
    # bubble (a while_loop), both on the GEP chain past the reduction
    "inf_chase": "starneig_tpu/ops/qz_driver.py:329",
    "reorder_bubble_gep": "starneig_tpu/ops/reorder.py:405",
}
SOURCES = {k: f"starneig_tpu_torch/kernels/csrc/{k}.cu" for k in REPLACES}
# the card's peaks for bound_ms (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes per second and fp64 operations per second outside the tensor cores
HBM_BPS = 3.35e12
F64_FLOPS = 34e12
# the kernels of Hessenberg -> Schur; the reordering runs reorder_bubble
SCHUR_KERNELS = ("hess_gemv", "francis", "train_hops", "aed_deflate", "recondense")
# the kernels of the GEP path hessenberg_triangular -> schur, and of the
# chain past it (select -> reorder_schur -> eigenvectors)
GEP_KERNELS = ("ht_cascade", "ht_recondense", "qz_window", "qz_sweep", "aed_deflate_gep",
               "inf_chase")
GEP_CHAIN_KERNELS = ("reorder_bubble_gep",)
GEP_N = 2000                       # the GEP chain's size
SMOKE_DEADLINE_S = 1100.0          # phase 9 waits for the plain cascade until then
GEP_INF_GATE_U = 5000.0            # tests/test_qz_driver.py's gates (n=512 infinite-rich)


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
    # the panel loop's shapes: A x on the panel arrays' 4000 x j views (ld
    # 288) and T[:j, :j], the transposed mode on V[:, :j] and T[:j, :j]
    small_ax = ([(f"V[:, :{j}]", V[:, :j], xs[nb][:j].contiguous()) for j in (1, 32, 144, 288)]
                + [(f"T[:{j}, :{j}]", T[:j, :j], xs[nb][:j].contiguous())
                   for j in (32, 144, 288)])
    small_t = ([(f"V[:, :{j}]", V[:, :j], xs[n]) for j in (1, 32, 144, 288)]
               + [(f"T[:{j}, :{j}]", T[:j, :j], xs[nb][:j].contiguous())
                  for j in (32, 144, 288)])
    cases = [("A x", A, xs[n], False),
             ("A[row0:, row0:] x", A[row0:, row0:], xs[n - row0], False),
             ("V^T a", V, xs[n], True),
             ("V[row0:]^T a", V[row0:], xs[n - row0], True),
             ("V y", V, xs[nb], False)]
    cases += [(f"{name} x", M, x, False) for name, M, x in small_ax]
    cases += [(f"V[:, :{j}]^T a", V[:, :j], xs[n], True) for j in (1, 32, 33, 144, 288)]
    cases += [(f"T[:{j}, :{j}]^T w", T[:j, :j], xs[nb][:j].contiguous(), True)
              for j in (32, 144, 288)]
    err = 0.0
    for name, M, x, tr in cases:
        uk, up = gemv(M, x, tr), gemv_plain(M, x, tr)
        scale = float(gemv_plain(M.abs(), x.abs(), tr).max())
        d = float((uk - up).abs().max())
        same = torch.equal(uk, gemv(M, x, tr))
        log(f"  B1 {name}: max abs err {d:.2e}, relative {d / scale:.2e}"
            + ("; two launches bit-for-bit equal" if same else ""))
        check(d < 1e-12 * scale, f"B1 {name} disagrees: {d}")  # summation order
        check(same, f"B1 {name}: two launches differ")
        err = max(err, d)
    # the panel matvec at n=4000 against torch.mv, in turns kernel, library,
    # library, kernel: CUDA events over 50 calls back to back
    t4 = [cuda_ms(f, 50) for f in (lambda: gemv(A, xs[n]), lambda: torch.mv(A, xs[n]),
                                    lambda: torch.mv(A, xs[n]), lambda: gemv(A, xs[n]))]
    ms, lms = (t4[0] + t4[3]) / 2, (t4[1] + t4[2]) / 2
    pms = cuda_ms(lambda: gemv_plain(A, xs[n]), 50)
    bms, by = bound(8 * (n * n + 2 * n), 2 * n * n)
    log(f"  B1 n=4000 A x: kernel {t4[0]:.4f}/{t4[3]:.4f} ms, torch.mv {t4[1]:.4f}/{t4[2]:.4f} "
        f"ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by})")
    # a rank's column shard of the DM Hessenberg reduction (phase 10a: 2
    # ranks): a row-major n x n/2 tensor, the panel matvec's first-panel view
    w = n // DM_RANKS_A
    Ash = A[:, :w].contiguous()
    xw = xs[n][:w].contiguous()
    uk, up = gemv(Ash, xw), gemv_plain(Ash, xw)
    scale = float(gemv_plain(Ash.abs(), xw.abs()).max())
    dsh = float((uk - up).abs().max())
    check(dsh < 1e-12 * scale, f"B1 shard {n}x{w}: disagrees by {dsh}")
    check(torch.equal(uk, gemv(Ash, xw)), f"B1 shard {n}x{w}: two launches differ")
    err = max(err, dsh)
    sh = [cuda_ms(f, 50) for f in (lambda: gemv(Ash, xw), lambda: torch.mv(Ash, xw),
                                    lambda: torch.mv(Ash, xw), lambda: gemv(Ash, xw))]
    sh_plain = cuda_ms(lambda: gemv_plain(Ash, xw), 50)
    sbms, sby = bound(8 * (n * w + w + n), 2 * n * w)
    log(f"  B1 shard {n}x{w} A x: max abs err {dsh:.2e}; kernel {sh[0]:.4f}/{sh[3]:.4f} ms, "
        f"torch.mv {sh[1]:.4f}/{sh[2]:.4f} ms, plain {sh_plain:.4f} ms, bound "
        f"{sbms:.4f} ms ({sby})")
    # the small shapes of both modes against their torch call (torch.mv, or
    # M.T @ x for the transposed mode: cuBLAS), in turns kernel, library,
    # library, kernel: CUDA events over 200 calls back to back (the host's
    # launch rate bounds these small calls), then the device time of 200
    # calls under the profiler
    small = {}
    for mode, shapes in (("A x", small_ax), ("trans", small_t)):
        tr = mode == "trans"
        for name, M, x in shapes:
            kern = lambda M=M, x=x, tr=tr: gemv(M, x, tr)                         # noqa: E731
            libr = (lambda M=M, x=x: torch.mv(M.T, x)) if tr else \
                (lambda M=M, x=x: torch.mv(M, x))                                  # noqa: E731
            t = [cuda_ms(f, 200) for f in (kern, libr, libr, kern)]
            d = [device_ms(f, 200) for f in (kern, libr, libr, kern)]
            r, c = M.shape
            tb, tby = bound(8 * (r * c + r + c), 2 * r * c)
            small[f"{name}^T x" if tr else f"{name} x"] = dict(
                kernel_ms=[t[0], t[3]], library_ms=[t[1], t[2]],
                kernel_device_ms=[d[0], d[3]], library_device_ms=[d[1], d[2]],
                bound_ms=tb, bound_by=tby)
            fmt = lambda v: "n/a" if v is None else f"{v:.4f}"     # noqa: E731
            lname = "M.T @ x" if tr else "torch.mv"
            log(f"  B1 {name}{'^T' if tr else ''} x ({r}x{c}): kernel {t[0]:.4f}/{t[3]:.4f} "
                f"ms, {lname} {t[1]:.4f}/{t[2]:.4f} ms; device time kernel "
                f"{fmt(d[0])}/{fmt(d[3])} ms, {lname} {fmt(d[1])}/{fmt(d[2])} ms; "
                f"bound {tb:.5f} ms ({tby})")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=by,
                detail=dict(kernel_ms=[t4[0], t4[3]], library_ms=[t4[1], t4[2]], small=small,
                            shard=dict(shape=(n, w), kernel_ms=[sh[0], sh[3]],
                                       library_ms=[sh[1], sh[2]], plain_ms=sh_plain,
                                       bound_ms=sbms, bound_by=sby, max_abs_err=dsh)))


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
            (Sp, Zp, ip), plain_ms = host_ms(lambda: _small_schur_plain(*_cpu(H, Z), m, th))
        steps = steps[0]
        check(int(ik) == 0 and int(ip) == 0, f"B2 w={w}: info {int(ik)} {int(ip)}")
        form_k, form_p = schur_form_error(Sk), schur_form_error(Sp)
        Skn, Zkn = Sk.cpu().numpy(), Zk.cpu().numpy()
        nh = np.linalg.norm(Hn)
        res = np.linalg.norm(Zkn @ Skn @ Zkn.T - Hn) / nh / U
        orth = np.linalg.norm(Zkn @ Zkn.T - np.eye(w)) / np.sqrt(w) / U
        d = float(np.abs(block_eigs(Sk, m) - block_eigs(Sp, m)).max())
        elem = float((Sk.cpu() - Sp).abs().max()) / nh
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
    Tk, Vk = Tk.cpu(), Vk.cpu()
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
            ref, plain_ms[label] = host_ms(lambda: _aed_deflate(*_cpu(T, V), s, w, th))
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
    Tk, Qk = Tk.cpu(), Qk.cpu()
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
                ref, t = host_ms(lambda: _window_bubble(Td[g].cpu(), sels[g], lims[0][g],
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
    return S, Q2, er, ei, int(info), (t1 - t0) * 1e3, (t2 - t1) * 1e3, stats, H, Q


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
    S, Q2, er, ei, info, hess_ms, schur_ms, stats, H, QH = solve(A)
    schur_launches = dict(kernels.LAUNCHES)
    hess = (to_numpy(H), to_numpy(QH))        # phase 10a's reference
    del H, QH
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
                n200_reduce=n200_reduce, spectrum=before, hess=hess)



# ---------------------------------------------------------------------------
# GEP: kernels G1-G4 against their plain twins, then the reduction path
# ---------------------------------------------------------------------------
# The plain twins are host loops of small torch calls; they run on CPU
# copies of the card's inputs, where such loops run several times faster
# than on the card, so that each stays near 20 s.  plain_ms of the GEP rows
# is that CPU time.


def _cpu(*xs):
    return [x.detach().cpu() for x in xs]


def _rel(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-300)


def host_ms(fn):
    """Run fn() once; return (its result, its host wall time in ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def ht_cascade_flops(n):
    """fp64 operations of the HT cascade of an n x n pencil: step (j, i) of
    pass j rotates A's row pair from column j, B's from column i-1, the
    column pairs of A, Q and Z (n rows) and of B (rows 0..i), 6 operations
    an entry pair: 6 (5n - j + 2) a step."""
    return sum(6 * (n - j - 2) * (5 * n - j + 2) for j in range(n - 2))


def ht_window_steps(kbot):
    """Rotation pairs of the GEP recondense: the spike chase, then the
    cascade on the leading kbot block."""
    return max(kbot - 1, 0) + max(kbot - 2, 0) * max(kbot - 1, 0) // 2


def ht_plain_job(conn, A, B, Q, Z):
    """In a child process: the plain cascade on CPU copies of G1's input;
    sends back the result as numpy arrays and its wall time in ms."""
    import torch
    from starneig_tpu_torch.ops.hess_triangular import _ht_reduce
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = _ht_reduce(*(torch.from_numpy(x) for x in (A, B, Q, Z)))
    conn.send(([x.numpy() for x in out], (time.perf_counter() - t0) * 1e3))
    conn.close()


def ht_regular_input(n, dev):
    """G1's input at size n from a regular pencil: A Gaussian, B the upper
    triangle of a Gaussian (nonsingular), Q = Z = I (seed n)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
    B = torch.triu(torch.as_tensor(rng.standard_normal((n, n)), device=dev))
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    return A, B, eye, eye.clone()


def start_ht_plain(dev):
    """Start the plain cascade on a CPU copy of G1's n=GEP_N input in a
    child process; returns (the process, the receiving end of its pipe,
    the input on the card)."""
    inp = ht_regular_input(GEP_N, dev)
    proc, recv = start_child(ht_plain_job, *(x.cpu().numpy() for x in inp))
    log(f"  G1 n={GEP_N}: the plain cascade runs in process {proc.pid} until phase 9")
    return proc, recv, inp


def finish_ht_plain(handle, g1, deadline_s):
    """Phase 9: wait for the child's plain cascade (at most deadline_s) and
    hold phase 3's n=GEP_N kernel result to it within 1e-11 max|M| (the
    same rotations in the same order, other rounding).  G1's kernel-table
    row becomes this run; the n=192 numbers stay under its detail."""
    import torch
    proc, recv, _inp = handle
    check(recv.poll(max(deadline_s, 1.0)), f"G1 n={GEP_N}: the plain cascade did not "
          f"finish within {deadline_s:.0f} s")
    want, plain_ms = recv.recv()
    recv.close()
    proc.join()
    got = g1.pop("out_n2000")
    errs = [_rel(torch.from_numpy(w), g) for g, w in zip(got, want)]
    err = max(errs)
    d = g1["detail"][f"full n={GEP_N}"]
    log(f"  G1 n={GEP_N}: max err {err:.2e} max|M| (A, B, Q, Z: "
        + ", ".join(f"{e:.2e}" for e in errs) + f"); kernel {d['ms']:.1f} ms "
        f"({d['us_a_step']:.3f} us a step of {d['steps']}), plain (CPU, child process) "
        f"{plain_ms:.1f} ms, bound {d['bound_ms']:.2f} ms ({d['bound_by']})")
    check(err <= 1e-11, f"G1 n={GEP_N}: {errs}")
    d.update(errors_a_b_q_z=errs, plain_ms=plain_ms)
    g1.update(max_abs_err=err, ms=d["ms"], plain_ms=plain_ms, bound_ms=d["bound_ms"],
              bound_by=d["bound_by"])


def phase_ht_cascade(dev, inp2000):
    import numpy as np
    import torch
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.ops.hess_triangular import (NB, _ht_generate, _ht_reduce,
                                                        _ht_slivers, _rot_offset, blocks,
                                                        sliver_len)
    # full mode (blocked) at n=192 (tests/test_torch_gep_kernels.py's shape)
    # against the unblocked plain cascade
    n = 192
    A, B, eye, _ = ht_regular_input(n, dev)
    got = gpu_gep.ht_cascade(A, B, eye, eye)
    want, plain_ms = host_ms(lambda: _ht_reduce(*_cpu(A, B, eye, eye)))
    err = max(_rel(w, g) for g, w in zip(got, want))
    check(err <= 1e-11, f"G1 n={n}: {err}")     # the same rotations, other rounding
    ms = cuda_ms(lambda: gpu_gep.ht_cascade(A, B, eye, eye), 3)
    steps = (n - 2) * (n - 1) // 2
    bms, by = bound(8 * 8 * n * n, ht_cascade_flops(n))
    log(f"  G1 n={n}: max err {err:.2e} max|M|; kernel {ms:.2f} ms "
        f"({ms / steps * 1e3:.3f} us a step of {steps}), plain (CPU) {plain_ms:.1f} ms, "
        f"bound {bms:.4f} ms ({by})")
    detail = {}
    detail["full n=192"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                bound_by=by, us_a_step=ms / steps * 1e3)
    # the blocked form's two kernels against their plain twins at the GEP
    # path's n: the generation of its first block (A's and B's rows and the
    # rotation log, within 1e-11 max|M|: the kernel's band takes its last
    # column by dot products where the twin sweeps) and that block's sliver
    # factors from the same log (1e-13: the same rotations in the same order)
    n = GEP_N
    rot0 = inp2000[0].new_zeros((_rot_offset(n, n - 2), 4))
    J0, J1 = blocks(n, NB)[0]
    Ag, Bg, rg = inp2000[0].clone(), inp2000[1].clone(), rot0.clone()
    gpu_gep.ht_generate(Ag, Bg, rg, J0, J1)
    Ac, Bc, rc = _cpu(inp2000[0].clone(), inp2000[1].clone(), rot0)
    _, gen_plain_ms = host_ms(lambda: _ht_generate(Ac, Bc, rc, J0, J1))
    gen_err = max(_rel(Ac, Ag), _rel(Bc, Bg), _rel(rc, rg))
    L = sliver_len(NB)
    Ug = gpu_gep.ht_slivers(rg, n, J0, J1, L)
    Up, sl_plain_ms = host_ms(lambda: _ht_slivers(rg.cpu(), n, J0, J1, L))
    sl_err = float((Ug.cpu() - Up).abs().max())
    log(f"  G1 n={n} block [{J0}, {J1}): generation max err {gen_err:.2e} max|M| (plain "
        f"{gen_plain_ms:.1f} ms), slivers ({Ug.shape[0]} of order {Ug.shape[-1]}) max err "
        f"{sl_err:.2e} (plain {sl_plain_ms:.1f} ms)")
    check(gen_err <= 1e-11 and sl_err <= 1e-13, f"G1 n={n}: generation {gen_err}, "
          f"slivers {sl_err}")
    # full mode at the GEP path's n; its plain twin runs in the child process
    out, ms = timed(lambda: gpu_gep.ht_cascade(*inp2000))
    Ag, Bg, rg = inp2000[0].clone(), inp2000[1].clone(), rot0.clone()
    _, gen_ms = timed(lambda: [gpu_gep.ht_generate(Ag, Bg, rg, J0, J1)
                               for J0, J1 in blocks(n, NB)])
    steps = (n - 2) * (n - 1) // 2
    bms, by = bound(8 * 8 * n * n, ht_cascade_flops(n))
    log(f"  G1 n={n}: kernel {ms:.1f} ms ({ms / steps * 1e3:.3f} us a step of {steps}): "
        f"generation {gen_ms:.1f} ms ({len(blocks(n, NB))} blocks of {NB}), slivers and "
        f"the deferred products {ms - gen_ms:.1f} ms; its plain twin is compared in phase 9")
    detail[f"full n={n}"] = dict(ms=ms, bound_ms=bms, bound_by=by, steps=steps,
                                 us_a_step=ms / steps * 1e3, generation_ms=gen_ms,
                                 far_ms=ms - gen_ms, generation_err=gen_err,
                                 generation_plain_ms=gen_plain_ms, sliver_err=sl_err,
                                 sliver_plain_ms=sl_plain_ms)
    # the n=192 numbers stand until phase 9 replaces them with n=2000's
    d192 = detail["full n=192"]
    return dict(max_abs_err=err, ms=d192["ms"], plain_ms=plain_ms, bound_ms=d192["bound_ms"],
                bound_by=d192["bound_by"], detail=detail, out_n2000=out)


def ht_window_flops(W, kbot):
    """fp64 operations of G1's window mode on a (W, W) window: 6 for each
    entry pair a rotation updates where it can change (the chain's leading
    block: S's rows and columns, T's upper triangle; the replay: Q's and
    Z's rows, the rows below the block and the columns right of it)."""
    pairs = 0
    for m in range(kbot - 1):
        j, lo = m - 1, max(m, 0)
        for k in range(kbot - 1, m, -1):
            pairs += (kbot - lo) + (kbot - k + 1)        # left: S's, T's row pair
            pairs += kbot + (k + 1)                      # right: S's, T's column pair
            pairs += 2 * W + 4 * (W - kbot)              # the replay
    return 6 * pairs


# G1 window mode's cases: the AED windows of n = 512, 2000 and 4000 at kbot
# 0, 1, 2, 3, 10, WA - 4 and WA, elementwise against the plain twin at kbot
# <= 10; the n=10,000 geometry's window (T's block in global memory) and
# WA = 1000 (26 replay vectors a block) by the contract alone; at WA = 162
# the layouts of a large kbot, reached by capping the shared memory
# (HTWIN_CAPS: the bytes for what grows with kbot), bit-equal to the
# uncapped launch
HTWIN_WA = (84, 162, 322)
HTWIN_WIDE = (802, 1000)
HTWIN_KBOTS = ("0", "1", "2", "3", "10", "WA-4", "WA")
HTWIN_S = 0.37
HTWIN_CAPS = {"global": lambda kbot: 8, "vectors": lambda kbot: 40 * kbot}


def recondense_gep_contract(S, T, Q, Z, s, kbot, out):
    """(similarity (relative), structure, spike tail / WA, beta's error
    against sigma |s| ||Q[0, :kbot]||, sigma the sign of the spike's first
    nonzero) of a GEP recondense output (numpy inputs)."""
    import numpy as np
    S2, T2, Q2, Z2 = (x.cpu().numpy() for x in out[:4])
    WA = S.shape[0]
    Ul, Vr = Q.T @ Q2, Z.T @ Z2
    sim = max(np.linalg.norm(Ul.T @ S @ Vr - S2) / np.linalg.norm(S),
              np.linalg.norm(Ul.T @ T @ Vr - T2) / np.linalg.norm(T))
    struct = max(np.abs(np.tril(S2[:kbot, :kbot], -2)).max(initial=0.0),
                 np.abs(np.tril(T2[:kbot, :kbot], -1)).max(initial=0.0))
    x0 = s * Q[0, :kbot]
    nz = np.flatnonzero(x0)
    sigma = np.sign(x0[nz[0]]) if len(nz) else 1.0
    return (sim, struct, float(np.abs(s * Q2[0, 1:kbot]).max(initial=0.0)) / WA,
            abs(float(out[4]) - sigma * np.linalg.norm(x0)))


def phase_ht_recondense(dev):
    """G1's window mode (the GEP AED recondense: a chain and a replay
    launch) against _aed_recondense_gep: HTWIN_WA x HTWIN_KBOTS, within
    1e-12 max|M| at kbot <= 10, every case by the contract (similarity
    below 1e-13, the structure exact, the spike tail below 1e-14 WA,
    beta within 1e-13; kbot = 0 leaves the window unchanged), HTWIN_WIDE
    by the contract, HTWIN_CAPS' layouts at WA = 162 bit-equal to the
    uncapped launch; times at kbot = WA - 4, the kernel-table row WA=162's
    (the n=2000 path's window)."""
    import torch
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.ops.qz_driver import _aed_recondense_gep
    from starneig_tpu_torch.testing.generators import planted_schur_pair
    err, detail = 0.0, {}
    for WA in HTWIN_WA + HTWIN_WIDE:
        npx = planted_schur_pair(WA, WA, WA)
        S, T, Q, Z = (torch.as_tensor(x, device=dev) for x in npx)
        for kb in (HTWIN_KBOTS if WA not in HTWIN_WIDE else ("WA-4",)):
            kbot = {"WA-4": WA - 4, "WA": WA}.get(kb) or int(kb)
            gk = gpu_gep.ht_recondense(S, T, Q, Z, HTWIN_S, kbot)
            sim, struct, spike, berr = recondense_gep_contract(*npx, HTWIN_S, kbot, gk)
            ok = sim < 1e-13 and struct == 0.0 and spike < 1e-14 and berr <= 1e-13
            e = None
            if kbot <= 10:
                gp = _aed_recondense_gep(*_cpu(S, T, Q, Z), HTWIN_S, kbot)
                e = max(_rel(w, g) for g, w in zip(gk[:4], gp[:4]))
                ok = ok and e <= 1e-12 and abs(float(gk[4]) - float(gp[4])) <= 1e-13
                err = max(err, e)
            if kbot == 0:
                ok = ok and float(gk[4]) == 0.0 and all(
                    torch.equal(g, x) for g, x in zip(gk[:4], (S, T, Q, Z)))
            log(f"  G1 window WA={WA} kbot={kbot}: "
                + (f"max err {e:.2e} (1e-12), " if e is not None else "")
                + f"similarity {sim:.1e}, structure {struct}, spike tail {spike:.1e} WA, "
                f"beta err {berr:.1e}")
            check(ok, f"G1 window WA={WA} kbot={kbot}")
            if WA == HTWIN_WA[1] and kb in ("10", "WA-4"):
                for name, cap in HTWIN_CAPS.items():
                    gc = gpu_gep.ht_recondense(S, T, Q, Z, HTWIN_S, kbot, smem_cap=cap(kbot))
                    same = all(torch.equal(a, b) for a, b in zip(gc, gk))
                    log(f"  G1 window WA={WA} kbot={kbot} shared memory capped ({name}, "
                        f"{cap(kbot)} B): bit-equal to the uncapped launch {same}")
                    check(same, f"G1 window WA={WA} kbot={kbot} {name}")
        if WA in HTWIN_WIDE:
            continue
        kbot = WA - 4
        wms = cuda_ms(lambda: gpu_gep.ht_recondense(S, T, Q, Z, HTWIN_S, kbot), 3)
        st = ht_window_steps(kbot)
        wb, wby = bound(8 * 8 * WA * WA, ht_window_flops(WA, kbot))
        pms = None
        if WA <= 162:
            _, pms = host_ms(lambda: _aed_recondense_gep(*_cpu(S, T, Q, Z), HTWIN_S, kbot))
        chain = st * HTWIN_PAIR_CYCLES / SM_HZ * 1e3
        log(f"  G1 window WA={WA} kbot={kbot}: kernel {wms:.3f} ms ({wms / st * 1e3:.3f} us "
            f"a pair of {st}), plain (CPU) "
            + (f"{pms:.1f} ms" if pms is not None else "not run (contract only)")
            + f", bound {wb:.5f} ms ({wby}), serial chain {chain:.2f} ms ({st} pairs x "
            f"{HTWIN_PAIR_CYCLES} cycles)")
        detail[f"WA={WA}"] = dict(kbot=kbot, ms=wms, plain_ms=pms, bound_ms=wb, bound_by=wby,
                                  steps=st, us_a_pair=wms / st * 1e3, chain_ms=chain)
    d = detail[f"WA={HTWIN_WA[1]}"]
    return dict(max_abs_err=err, ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
                bound_by=d["bound_by"], detail=detail)


def ht_window_np(w, seed, ninf=0):
    """A random HT window (H Hessenberg, T triangular + 3 I) with ninf
    non-adjacent exact zeros on T's diagonal."""
    import numpy as np
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((w, w)), -1)
    T = np.triu(rng.standard_normal((w, w))) + 3 * np.eye(w)
    for j in range(5, w - 5, max((w - 10) // max(ninf, 1), 2))[:ninf]:
        T[j, j] = 0.0
    return H, T


def qz_contract(H, T, out):
    """(info, max of residuals and orthogonality in u, structure errors,
    betas with |beta| <= 1e-12 max|beta|) of a window QZ result."""
    import numpy as np
    from starneig_tpu_torch.testing import hooks
    S, Tt, Q, Z, info = out
    ra, rb = hooks.residual_gep(H, T, S, Tt, Q, Z)
    worst = max(ra, rb, hooks.orthogonality(Q), hooks.orthogonality(Z))
    d = np.abs(np.diagonal(Tt.cpu().numpy()))
    return (int(info), worst, hooks.schur_structure_error(S),
            hooks.triangular_structure_error(Tt), int((d <= 1e-12 * d.max()).sum()))


def spectra_chordal(out_a, out_b):
    """Chordal distance between the generalized spectra of two window QZ
    results (greedy matching, hooks.chordal_eigenvalue_error)."""
    from starneig_tpu_torch.ops.eigvals import extract_eigenvalues_gen
    from starneig_tpu_torch.testing import hooks
    ar, ai, bt = (x.cpu() for x in extract_eigenvalues_gen(out_b[0], out_b[1]))
    return hooks.chordal_eigenvalue_error(*extract_eigenvalues_gen(out_a[0], out_a[1]),
                                          (ar + 1j * ai).numpy(), bt.numpy()) * U


def qz_sweep_flops(w, l, i):
    """The flops a QZ sweep over [l, i] of a w-window needs (``_sweep``):
    each step k's transforms on the entries that are not exactly zero, 14
    flops a triple for a 3-reflector and 6 a pair for a 2-reflector or a
    rotation.  Left reflector: H's rows k..k+2 from column k-1 (k from
    l+1; from k at k = l), T's from column k, and Q's w rows; right
    3-reflector (not at the last step k = i-1): rows 0..k+3 of H (up to
    i), 0..k+2 of T and Z's w rows; rotation of columns k, k+1: rows
    0..k+3 of H (up to i), 0..k+1 of T and Z's w rows."""
    f = 0
    for k in range(l, i):
        left = (w - k + (k > l)) + (w - k) + w
        if k <= i - 2:
            h = min(k + 4, i + 1)
            f += 14 * left + 14 * (h + k + 3 + w) + 6 * (h + k + 2 + w)
        else:
            f += 6 * left + 6 * (2 * (k + 2) + w)
    return f


def phase_qz_window(dev):
    import numpy as np
    import torch
    from starneig_tpu_torch.ops import gpu_gep, qz
    from starneig_tpu_torch.ops.qz import _small_qz_plain
    res = {}
    for w, ninf in ((84, 0), (84, 8), (162, 0), (322, 0)):
        Hn, Tn = ht_window_np(w, w + ninf, ninf)
        H, T = (torch.as_tensor(x, device=dev) for x in (Hn, Tn))
        eye = torch.eye(w, dtype=torch.float64, device=dev)
        th, tt = U / 2 * np.linalg.norm(Hn), U / 2 * np.linalg.norm(Tn)
        st = {}
        got = gpu_gep.qz_window(H, T, eye, eye, w, th, tt, stats=st)
        ck = qz_contract(Hn, Tn, got)
        if w == 322:
            # the GEP n=4000 path's AED window: by contract alone; its plain
            # twin (a minute or two of the host) runs in a child process
            # until phase 9 for the bound, which needs its sweeps' positions
            log(f"  G2 w={w}: kernel (info, worst residual/orth u, S, T structure) "
                f"{ck[0]}, {ck[1]:.1f}, {ck[2]}, {ck[3]}; {st['chase_steps']} chase steps")
            check(ck[0] == 0 and ck[1] < GATE_U and ck[2:4] == (0.0, 0.0),
                  f"G2 w={w} fails its contract")
            plain322 = start_child(qz_plain_job, Hn, Tn, th, tt)
            res[(w, ninf)] = (H, T, eye, th, tt, None, st["chase_steps"], None, ck[1], 0.0)
            continue
        with tally(qz, "_sweep", lambda Hp, Tp, Qp, Zp, w_, l, i, its: i - l) as steps, \
                tally(qz, "_sweep", lambda Hp, Tp, Qp, Zp, w_, l, i, its:
                      qz_sweep_flops(w_, l, i)) as flops:
            want, pms = host_ms(lambda: _small_qz_plain(*_cpu(H, T, eye, eye), w, th, tt))
        cp = qz_contract(Hn, Tn, want)
        chordal = spectra_chordal(got, want)
        log(f"  G2 w={w} ({ninf} T-diagonal zeros): kernel (info, worst residual/orth u, "
            f"S, T structure, betas <= 1e-12 max) {ck[0]}, {ck[1]:.1f}, {ck[2]}, {ck[3]}, "
            f"{ck[4]}, {st['chase_steps']} chase steps; plain {cp[0]}, {cp[1]:.1f}, {cp[2]}, "
            f"{cp[3]}, {cp[4]}, {steps[0]} chase steps; spectra within chordal {chordal:.2e}")
        # by contract: the deflation order, and whether an infinite
        # eigenvalue is detected (T-diagonal entries at rounding level
        # against u max|T|; chip_ab.py qzinf), may differ by rounding; the
        # spectra of the two backward-stable results agree to their
        # condition times u, below 1e-10 on these windows
        check(ck[0] == cp[0] == 0 and ck[1] < GATE_U and cp[1] < GATE_U
              and ck[2:4] == (0.0, 0.0) and cp[2:4] == (0.0, 0.0)
              and min(ck[4], cp[4]) >= ninf and chordal < 1e-10,
              f"G2 w={w} ninf={ninf} fails its contract")
        res[(w, ninf)] = (H, T, eye, th, tt, pms, steps[0], flops[0], max(ck[1], cp[1]),
                          chordal)
    detail = {}
    for w in (322, 162):     # 162 last: the kernel table's row
        H, T, eye, th, tt, pms, steps, nflops, worst, chordal = res[(w, 0)]
        ms = cuda_ms(lambda: gpu_gep.qz_window(H, T, eye, eye, w, th, tt), 3)
        # H, T, Q, Z read and written once, and the sweeps' flops; at
        # w=322 the twin's count comes in phase 9 (finish_qz_plain)
        bms, by = bound(8 * 8 * w * w, nflops) if nflops else (None, None)
        chain = steps * QZ_STEP_CYCLES[w] / SM_HZ * 1e3
        log(f"  G2 w={w}: kernel {ms:.2f} ms ({ms / steps * 1e3:.3f} us a step of "
            f"{steps} chase steps ({'the plain twin' if pms else 'the kernel'}'s count)), "
            + (f"bound {bms:.4f} ms ({by}, {nflops} flops)" if bms else
               "bound in phase 9 (the twin's sweeps, in a child process)")
            + f", serial chain {chain:.1f} ms (steps x "
            f"{QZ_STEP_CYCLES[w]} cycles)" + (f", plain (CPU) {pms:.1f} ms" if pms else ""))
        detail[f"w{w}"] = dict(ms=ms, steps=steps, us_a_step=ms / steps * 1e3, bound_ms=bms,
                               serial_chain_ms=chain, worst_u=worst)
    return dict(max_abs_err=max(r[9] for r in res.values()), ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, plain_w322=plain322,
                detail=dict(**detail, w84_plain_ms=res[(84, 0)][5]))


def qz_plain_job(conn, Hn, Tn, th, tt):
    """In a child process: G2's plain twin on a window, its chase steps and
    the flops its sweeps need (qz_sweep_flops over each sweep's [l, i]);
    sends (steps, flops, info, its wall time in ms)."""
    import torch
    from starneig_tpu_torch.ops import qz
    torch.set_num_threads(1)
    w = Hn.shape[0]
    eye = torch.eye(w, dtype=torch.float64)
    t0 = time.perf_counter()
    with tally(qz, "_sweep", lambda Hp, Tp, Qp, Zp, w_, l, i, its: i - l) as steps, \
            tally(qz, "_sweep", lambda Hp, Tp, Qp, Zp, w_, l, i, its:
                  qz_sweep_flops(w_, l, i)) as flops:
        out = qz._small_qz_plain(torch.from_numpy(Hn), torch.from_numpy(Tn), eye, eye, w,
                                 th, tt)
    conn.send((steps[0], flops[0], int(out[4]), (time.perf_counter() - t0) * 1e3))
    conn.close()


def start_child(job, *args):
    """Run job(conn, *args) in a spawned child process; returns (the
    process, the receiving end of its pipe)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=job, daemon=True, args=(send, *args))
    proc.start()
    send.close()
    return proc, recv


def finish_qz_plain(handle, g2, deadline_s):
    """Phase 9: the w=322 twin's sweeps from the child process give G2's
    bound there (bytes of H, T, Q, Z against the flops, as at w=162)."""
    proc, recv = handle
    check(recv.poll(max(deadline_s, 1.0)), "G2 w=322: the plain twin did not finish "
          f"within {deadline_s:.0f} s")
    steps, nflops, info, plain_ms = recv.recv()
    recv.close()
    proc.join()
    w = 322
    bms, by = bound(8 * 8 * w * w, nflops)
    d = g2["detail"][f"w{w}"]
    d.update(bound_ms=bms, bound_by=by, twin_steps=steps, plain_ms=plain_ms)
    log(f"  G2 w={w}: bound {bms:.4f} ms ({by}, {nflops} flops over the plain twin's "
        f"{steps} chase steps; the kernel's {d['steps']}), plain (CPU, child process) "
        f"{plain_ms:.1f} ms, info {info}")
    check(info == 0, f"G2 w={w}: the plain twin's info {info}")


def padded_pencil(n, B, seed, dev):
    """A padded HT pencil (S, T, Q, Z) as the QZ driver holds it, with the
    padding a train's windows need at both ends; returns (P, S, T, Q, Z)."""
    import numpy as np
    import torch
    P = 6 * B + 6
    NP = n + 2 * P
    rng = np.random.default_rng(seed)
    S = np.zeros((NP, NP))
    T = np.zeros((NP, NP))
    S[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n)), -1)
    T[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    Q = np.zeros((n, NP))
    Q[:, P:P + n] = np.eye(n)
    return P, *(torch.as_tensor(x.copy(), device=dev) for x in (S, T, Q, Q))


def qz_hop_flops(WC, B, HOP, l_rel, ihi_rel, s0, full=False):
    """The flops one G3 hop needs: every active bulge step's transforms on
    the entries that can change (the kernel's ranges, qz_sweep.cu), 14
    flops a triple for a 3-reflector and 6 a pair for a 2-reflector or a
    rotation: the left reflector on S's rows k..k+2 from column k-1, T's
    from column k and Qw's rows [min k, max k + 2] of the steps so far; the
    right 3-reflector (not at the last position) and the rotation on S's
    rows 0..k+3, T's 0..k+2 and Zw's rows [min k, max k + 2]; full: every
    range at window width."""
    f = 0
    qlo, qhi = (0, WC) if full else (WC, 0)
    for t in range(HOP):
        ks = [l_rel + s0 + t - 3 * b for b in range(B)
              if l_rel <= l_rel + s0 + t - 3 * b <= ihi_rel - 2]
        if not ks:
            continue
        if not full:
            qlo, qhi = min(qlo, min(ks)), max(qhi, max(ks) + 3)
        for k in ks:
            use3 = k <= ihi_rel - 3
            left = 3 * WC if full else (WC - max(k - 1, 0)) + (WC - k) + qhi - qlo
            rows = 3 * WC if full else min(k + 4, WC) + k + 3 + qhi - qlo
            f += (14 if use3 else 6) * left + (14 if use3 else 0) * rows + 6 * rows
    return f


def phase_qz_sweep(dev):
    import numpy as np
    import torch
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.ops.qz_driver import _qz_sweep, _qz_train_hop
    from starneig_tpu_torch.testing.generators import qz_train_hops
    n, B = 512, 12
    WC, HOP = 6 * B + 4, 3 * B
    P, S, T, Q, Z = padded_pencil(n, B, 512, dev)
    sh_np = np.random.default_rng(513).standard_normal((B, 4))
    sh_np[:, 3] = -sh_np[:, 1]
    sh = torch.as_tensor(sh_np, device=dev)
    cpu = _cpu(S, T, Q, Z)
    torch.cuda.synchronize()
    _, train_ms = timed(lambda: _qz_sweep(S, T, Q, Z, P, P + n, sh, B))
    _, plain_train_ms = host_ms(lambda: _qz_sweep(*cpu, P, P + n, sh.cpu(), B))
    err = max(_rel(w, g) for g, w in zip((S, T, Q, Z), cpu))
    log(f"  G3 one train n={n} B={B}: max err {err:.2e} relative; the sweep with the "
        f"kernel {train_ms:.1f} ms, plain (CPU) {plain_train_ms:.1f} ms")
    check(err <= 1e-11, f"G3 train n={n}: {err}")   # the same steps, other rounding
    # hops of a train as the sweep cuts them (n=200, the plain twin on the
    # CPU): the introduction hop, a middle hop (every bulge active), the last
    # hop, and an introduction hop with S[l_rel, l_rel - 1] != 0 (the full
    # ranges); each against the plain twin on CPU copies
    hops, hsh = qz_train_hops(200, B, 13)
    cases = {"intro": hops[0], "middle": hops[len(hops) // 2], "last": hops[-1]}
    Sw, Tw, *rest = hops[0]
    Sw = Sw.clone()
    Sw[rest[0], rest[0] - 1] = 0.7
    cases["subdiag"] = (Sw, Tw, *rest)
    herr, pms = 0.0, None
    for label, (Sw, Tw, lr, ir, s0) in cases.items():
        gk = gpu_gep.qz_sweep(Sw.to(dev), Tw.to(dev), hsh.to(dev), lr, ir, s0, B, HOP)
        gp, t_ = host_ms(lambda: _qz_train_hop(Sw, Tw, hsh, lr, ir, s0, B, HOP))
        e = max(_rel(w, g) for g, w in zip(gk, gp))
        log(f"  G3 {label} hop (l_rel {lr}, ihi_rel {ir}, s0 {s0}): max err {e:.2e}")
        check(e <= 1e-12, f"G3 {label} hop: {e}")
        herr = max(herr, e)
        pms = t_ if label == "middle" else pms
    Sw, Tw, lr, ir, s0 = (x.to(dev) if torch.is_tensor(x) else x for x in cases["middle"])
    hshd = hsh.to(dev)
    ms = cuda_ms(lambda: gpu_gep.qz_sweep(Sw, Tw, hshd, lr, ir, s0, B, HOP), 20)
    active = sum(lr <= lr + s0 + t - 3 * b <= ir - 2 for t in range(HOP) for b in range(B))
    # S, T read and S, T, Qw, Zw written once; the flops on the entries that
    # can change
    nflops = qz_hop_flops(WC, B, HOP, lr, ir, s0)
    bms, by = bound(8 * 6 * WC * WC, nflops)
    chain = HOP * QZSWEEP_STEP_CYCLES / SM_HZ * 1e3
    log(f"  G3 middle hop B={B} WC={WC}: kernel {ms:.4f} ms ({ms / HOP * 1e3:.2f} us a step), "
        f"plain (CPU) {pms:.1f} ms, {active} bulge steps, bound {bms:.5f} ms ({by}, "
        f"{nflops} flops), serial chain {chain:.4f} ms ({HOP} steps x "
        f"{QZSWEEP_STEP_CYCLES} cycles)")
    return dict(max_abs_err=max(err, herr), ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                detail=dict(train_ms=train_ms, plain_train_ms=plain_train_ms,
                            us_a_step=ms / HOP * 1e3, serial_chain_ms=chain))


# G4's inputs (label, WA, make() -> (S, T, Q, Z), spike s, active w): the
# n=2000 path's WA=162 and the n=4000 path's WA=322 windows with some bottom
# blocks deflating and the others moving up (thresh is u/2 ||S||_F, which
# grows with WA), and two windows whose first move is rejected after 20 and
# 40 accepted swaps (the second in the engine's second segment of a move)
def _g4_cases():
    from starneig_tpu_torch.testing.generators import planted_schur_pair, planted_spike_reject
    return (("WA=84", 84, lambda: planted_schur_pair(84, 82, 85), 1e-13, 82),
            ("WA=162", 162, lambda: planted_schur_pair(162, 160, 163), 1.5e-13, 160),
            ("WA=322", 322, lambda: planted_schur_pair(322, 320, 323), 2.7e-13, 320),
            ("WA=84, rejected after 20 swaps", 84, lambda: planted_spike_reject(84, 20, 104),
             1.0, 84),
            ("WA=162, rejected after 40 swaps", 162,
             lambda: planted_spike_reject(162, 40, 202), 1.0, 162))


def phase_aed_deflate_gep(dev):
    import torch
    from starneig_tpu_torch.ops import gpu_gep, qz_driver
    from starneig_tpu_torch.ops.qz_driver import _aed_deflate_gep
    err, runs = 0.0, {}
    for label, WA, make, s_, w in _g4_cases():
        x = [torch.as_tensor(a, device=dev) for a in make()]
        thresh = U / 2 * float(torch.linalg.norm(x[0]))
        gk = gpu_gep.aed_deflate_gep(*x, s_, w, thresh)
        # a swap of a p- and a q-block (d = p + q) applies d x d transforms
        # to d-vectors, (2d - 1) d flops each: S's and T's rows a..a+d-1
        # from column a (WA - a vectors) and their columns a..a+d-1 down to
        # row a+d-1 (a + d), Q's and Z's WA rows
        with tally(qz_driver, "swap_adjacent_gep", lambda *a: 1) as swaps, \
                tally(qz_driver, "swap_adjacent_gep", lambda A4, B4, p, q: (
                    2 * (p + q) - 1) * (p + q) * (4 * WA + 2 * (p + q))) as flops:
            gp, pms = host_ms(lambda: _aed_deflate_gep(*_cpu(*x), s_, w, thresh))
        ints_k, ints_p = [int(v) for v in gk[4:]], [int(v) for v in gp[4:]]
        e = max(_rel(w_, g) for g, w_ in zip(gk[:4], gp[:4]))
        log(f"  G4 {label}: (kbot, fail, steps) kernel {ints_k} plain {ints_p}, "
            f"{swaps[0]} swaps, max err {e:.2e} relative")
        # the same swaps, other rounding
        check(ints_k == ints_p and e <= 1e-11, f"G4 {label} disagrees")
        check(("rejected" in label) == (ints_p[1] == 1), f"G4 {label}: fail {ints_p[1]}")
        err = max(err, e)
        runs[label] = (x, s_, w, thresh, swaps[0], flops[0], pms)
    detail = {}
    for label in ("WA=322", "WA=162"):     # 162 last: the kernel table's row
        x, s_, w, thresh, nsw, nflops, pms = runs[label]
        WA = x[0].shape[0]
        ms = cuda_ms(lambda: gpu_gep.aed_deflate_gep(*x, s_, w, thresh), 3)
        bms, by = bound(8 * 8 * WA * WA, nflops)
        log(f"  G4 {label}: kernel {ms:.2f} ms ({ms / nsw * 1e3:.2f} us a swap of {nsw}), "
            f"plain (CPU) {pms:.1f} ms, bound {bms:.5f} ms ({by}, {nflops} flops)")
        detail[label] = dict(ms=ms, swaps=nsw, us_a_swap=ms / nsw * 1e3, bound_ms=bms,
                             plain_ms=pms)
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                detail=detail)


# G5's windows (Wb, jrel, mrel, lrel): the n=2000 push's INFW=96 window as
# the push's later windows take it (the zero at row 1, no segment top); the
# n=512 geometry's 84 with the zero at the segment top (the reflection
# skipped there); a window cut short (mrel < Wb) with the top inside; a
# window with no step (jrel = mrel - 1); the last, short window of a push
INF_CASES = ((96, 1, 96, -1), (84, 0, 84, 0), (96, 7, 60, 7), (96, 95, 96, -1),
             (96, 1, 37, -1))


def inf_chase_flops(Wb, jrel, mrel, lrel):
    """fp64 operations of G5 on a window: 6 for each entry pair a step's
    rotation or reflection updates where it can change (H's row pair from
    column i-1, T's from i+1, H's column pair in rows 0 .. i+1, T's in 0 ..
    i, Qw's and Zw's rows the chase has reached)."""
    pairs = 0
    for i in range(jrel, mrel - 1):
        pairs += (Wb - max(i - 1, 0)) + (Wb - i - 1) + (i + 2 - jrel)
        if i != lrel:
            pairs += (i + 2) + (i + 1) + (i + 1 - max(jrel - 1, 0))
    return 6 * pairs


def phase_inf_chase(dev):
    import torch
    from starneig_tpu_torch.ops import gpu_gep
    from starneig_tpu_torch.ops.qz_driver import _inf_chase_kernel
    from starneig_tpu_torch.testing import hooks
    from starneig_tpu_torch.testing.generators import inf_push_window
    err = 0.0
    for Wb, jrel, mrel, lrel in INF_CASES:
        H, T = (torch.as_tensor(x, device=dev)
                for x in inf_push_window(Wb, Wb + jrel, jrel, lrel))
        gk = gpu_gep.inf_chase(H, T, jrel, mrel, lrel)
        gp, pms = host_ms(lambda: _inf_chase_kernel(*_cpu(H, T), jrel, mrel, lrel))
        e = max(_rel(w, g) for g, w in zip(gk, gp))
        Tk = gk[1].cpu()
        exact = (float(Tk[mrel - 1, mrel - 1]) == 0.0
                 and hooks.triangular_structure_error(Tk) == 0.0
                 and hooks.hessenberg_structure_error(gk[0]) == 0.0)
        log(f"  G5 Wb={Wb} jrel={jrel} mrel={mrel} lrel={lrel}: max err {e:.2e} max|M|; "
            f"zero at mrel-1 and exact structure {exact}")
        # the same rotations, other rounding (FMA contraction)
        check(e <= 1e-12 and exact, f"G5 Wb={Wb} jrel={jrel}: {e}, {exact}")
        err = max(err, e)
        if (Wb, jrel, mrel, lrel) == INF_CASES[0]:
            timed_case = (H, T, jrel, mrel, lrel, pms)
    H, T, jrel, mrel, lrel, pms = timed_case
    Wb = H.shape[0]
    ms = cuda_ms(lambda: gpu_gep.inf_chase(H, T, jrel, mrel, lrel), 20)
    steps = mrel - 1 - jrel
    # H, T read, H, T, Qw, Zw written; the pairs that can change
    bms, by = bound(8 * 6 * Wb * Wb, inf_chase_flops(Wb, jrel, mrel, lrel))
    chain = steps * INF_STEP_CYCLES / SM_HZ * 1e3
    log(f"  G5 Wb={Wb}: kernel {ms:.4f} ms ({ms / steps * 1e3:.2f} us a step of {steps}), "
        f"plain (CPU) {pms:.1f} ms, bound {bms:.5f} ms ({by}), serial chain {chain:.4f} ms "
        f"({steps} steps x {INF_STEP_CYCLES} cycles)")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                detail=dict(steps=steps, us_a_step=ms / steps * 1e3, chain_ms=chain))


# G6's inputs (G, W, seed, (dst0s, dst_limits, wlims)): W=16 windows with a
# frozen top row, a frozen bottom row and an insertion limit; W=128 (the
# n=2000 reordering's window) with frozen rows and a limit that stops a
# window early.  Window 0 of each rejects a swap
# (testing/generators.py:planted_pencil_windows).
BUBBLE_GEP_CASES = ((3, 16, 19, ([0, 1, 0], [16, 16, 5], [16, 15, 16])),
                    (2, 128, 131, ([0, 1], [128, 40], [128, 127])))


def bubble_gep_contract(S, T, out):
    """(similarity residual in u, structure errors of S and T) of a pencil
    window bubble's result out = (S', T', Q, Z, ...)."""
    import numpy as np
    from starneig_tpu_torch.testing import hooks
    S2, T2, Q, Z = (x.cpu().numpy() for x in out[:4])
    res = max(np.linalg.norm(Q.T @ S @ Z - S2) / np.linalg.norm(S),
              np.linalg.norm(Q.T @ T @ Z - T2) / np.linalg.norm(T)) / U
    return res, hooks.schur_structure_error(S2), hooks.triangular_structure_error(T2)


def phase_bubble_gep(dev):
    import numpy as np
    import torch
    from starneig_tpu_torch.ops import gpu_reorder, reorder
    from starneig_tpu_torch.ops.reorder import _window_bubble_gep
    from starneig_tpu_torch.testing.generators import planted_pencil_windows
    err, timed_case = 0.0, {}
    for G, W, seed, lims in BUBBLE_GEP_CASES:
        Ss, Ts, sels = planted_pencil_windows(G, W, seed)
        Sd, Td = (torch.as_tensor(x, device=dev) for x in (Ss, Ts))
        hk = {}
        gk = gpu_reorder.window_bubble_gep(Sd, Td, sels, *lims, host=hk)
        plain_ms, nsw = 0.0, []
        for g in range(G):
            hp = {}
            with tally(reorder, "swap_adjacent_gep", lambda *a: 1) as sw:
                gp, t = host_ms(lambda: _window_bubble_gep(
                    torch.as_tensor(Ss[g]), torch.as_tensor(Ts[g]), sels[g], lims[0][g],
                    lims[1][g], lims[2][g], host=hp))
            plain_ms += t
            nsw.append(sw[0])
            ik = (int(gk[5][g]), int(gk[6][g]), int(hk["steps"][g]), int(gk[7][g]))
            ip = (gp[5], gp[6], hp["steps"], gp[7])
            same = ik == ip and np.array_equal(gk[4][g], gp[4])
            e = max(_rel(w, x[g]) for x, w in zip(gk[:4], gp[:4]))
            label = f"G6 W={W} window {g}"
            if same:
                # the same swaps, other rounding
                check(e <= 1e-11, f"{label}: {e} max|M|")
                err = max(err, e)
            else:
                # a decision near its threshold parted: both held to the
                # contract (similarity < 500 u, exact structure)
                ck = bubble_gep_contract(Ss[g], Ts[g], [x[g] for x in gk[:4]])
                cp = bubble_gep_contract(Ss[g], Ts[g], gp)
                log(f"  {label}: decisions part (kernel {ik}, plain {ip}); contract "
                    f"kernel {ck}, plain {cp}")
                check(max(ck[0], cp[0]) < GATE_U and ck[1:] == cp[1:] == (0.0, 0.0),
                      f"{label} breaks the contract")
            log(f"  {label}: (dst, nfail, steps, swaps) kernel {ik} plain {ip}, selection "
                f"equal {np.array_equal(gk[4][g], gp[4])}; max err {e:.2e} max|M|")
        check(int(gk[6][0]) >= 1, f"G6 W={W}: the planted swap was not rejected")
        if W == 128:
            timed_case = dict(Sd=Sd, Td=Td, sels=sels, lims=lims, plain_ms=plain_ms,
                              nsw=sum(nsw), nmax=max(nsw))
    c = timed_case
    G, W = c["Sd"].shape[0], c["Sd"].shape[1]
    ms = cuda_ms(lambda: gpu_reorder.window_bubble_gep(c["Sd"], c["Td"], c["sels"],
                                                       *c["lims"]), 3)
    wp = W + 4
    # a swap: the 4x4 transforms on 2 wp-wide row strips and on the column
    # strips of S, T (wp rows) and Q, Z (W rows), 32 flops a 4-vector; S, T
    # read, S, T, Q, Z written
    bms, by = bound(8 * 6 * G * W * W, c["nsw"] * 32 * (4 * wp + 2 * W))
    log(f"  G6 G={G} W={W} ({c['nsw']} swaps, at most {c['nmax']} a window): kernel "
        f"{ms:.2f} ms ({ms / c['nmax'] * 1e3:.2f} us a swap of the longest window), plain "
        f"(CPU) {c['plain_ms']:.1f} ms, bound {bms:.5f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=c["plain_ms"], bound_ms=bms, bound_by=by,
                detail=dict(swaps=c["nsw"], us_a_swap=ms / c["nmax"] * 1e3))


def gep_gates(A, B, S, T, Q, Z, bt):
    """(residuals of A and B, orthogonality of Q and Z, structure errors of
    S and T, count of |beta| <= 1e-12 max|beta|)."""
    import numpy as np
    from starneig_tpu_torch.testing import hooks
    ra, rb = hooks.residual_gep(A, B, S, T, Q, Z)
    bt = bt.cpu().numpy()
    return (ra, rb, hooks.orthogonality(Q), hooks.orthogonality(Z),
            hooks.schur_structure_error(S), hooks.triangular_structure_error(T),
            int((np.abs(bt) <= 1e-12 * np.abs(bt).max()).sum()))


def profiled_kernels(fn):
    """Run fn() under torch.profiler; return (its result, {kernel name:
    (device ms, calls)} for the device events, longest first, and fn()'s
    CUDA-event time in ms inside the profiled region)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, ms = timed(fn)
    tot = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        tot[e.key] = (us / 1e3, e.count)
    return out, dict(sorted(tot.items(), key=lambda kv: -kv[1][0])), ms


def phase_gep(dev):
    """The GEP path at n=2000: known_spectrum_pencil(2000, complex_ratio 0.3,
    inf_ratio 0.1, seed 0), the GEP_BENCH mix, through
    api.gep.hessenberg_triangular -> api.gep.schur (default geometry: WA=162,
    NS=120, B=12, TMAX=5), gated at 500 u; then the same QZ phase again
    under torch.profiler for each kernel's device total."""
    import numpy as np
    import torch
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.api import gep
    from starneig_tpu_torch.ops import qz_driver
    from starneig_tpu_torch.testing import hooks
    from starneig_tpu_torch.testing.generators import known_spectrum_pencil
    n = GEP_N
    A_np, B_np, alpha, beta = known_spectrum_pencil(n, complex_ratio=0.3, inf_ratio=0.1, seed=0)
    A, B = (torch.as_tensor(x, device=dev) for x in (A_np, B_np))
    torch.cuda.synchronize()
    # the HT phase once under the profiler for each kernel's device total
    # and launches (G1's kernels and the deferred products) and the first,
    # cold call's time (cuSOLVER's and cuBLAS's start-up included), before
    # the launch counts are zeroed; then the path's run, warm and outside
    # the profiler (ht_ms), timed by CUDA events
    _, prof_ht, ht_first_ms = profiled_kernels(lambda: gep.hessenberg_triangular(A, B))
    g1_prof = [v for k, v in prof_ht.items()
               if k.replace("(anonymous namespace)::", "").startswith("ht_")]
    ht_kernel_ms = sum(v[0] for v in g1_prof)
    ht_kernel_launches = sum(v[1] for v in g1_prof)
    kernels.reset_launches()
    (H, T, Q, Z), ht_ms = timed(lambda: gep.hessenberg_triangular(A, B))
    ht_calls = kernels.LAUNCHES["ht_cascade"]
    stats = {}
    with tally(qz_driver, "inf_chase", lambda *a: 1) as inf_calls:
        out, qz_ms = timed(lambda: gep.schur(H, T, Q, Z, stats=stats))
    launches = {k: kernels.LAUNCHES[k] for k in GEP_KERNELS}
    S, Tt, Qo, Zo, ar, ai, bt, info = out
    ra, rb, oq, oz, fs, ft, ninf = gep_gates(A_np, B_np, S, Tt, Qo, Zo, bt)
    chordal = hooks.chordal_eigenvalue_error(ar, ai, bt, alpha, beta)
    steps = (n - 2) * (n - 1) // 2
    ht_bound, ht_by = bound(8 * 8 * n * n, ht_cascade_flops(n))
    geo = {k: stats[k] for k in ("WA", "NS", "B", "WC", "TMAX")}
    log(f"  GEP n={n}: info {int(info)} ht_ms {ht_ms:.1f} (warm, outside the profiler; the "
        f"first, cold call {ht_first_ms:.1f} ms under it; G1's kernels {ht_kernel_ms:.1f} ms "
        f"device time under the profiler, {ht_kernel_ms / steps * 1e3:.3f} us a cascade step, "
        f"the deferred products not included; {ht_calls} wrapper calls, "
        f"{ht_kernel_launches} kernel launches; "
        f"G1's bound {ht_bound:.2f} ms, {ht_by}) "
        f"qz_ms {qz_ms:.1f}; residual A {ra:.1f}u "
        f"B {rb:.1f}u, orthogonality Q {oq:.1f}u Z {oz:.1f}u, structure S {fs} T {ft}; "
        f"{ninf} betas <= 1e-12 max|beta| of {int((beta == 0).sum())} planted infinities, "
        f"chordal error {chordal:.3e}u; geometry {geo}, rounds {stats['rounds']} "
        f"({stats['inf_rounds']} with the infinite push, {inf_calls[0]} G5 window "
        f"chases), recondense calls (G1 window mode) {stats['recondense_calls']}; "
        f"launches {launches}")
    check(int(info) == 0, f"GEP n={n}: info {int(info)}")
    check(max(ra, rb, oq, oz) < GATE_U, f"GEP n={n} gates: {ra} {rb} {oq} {oz}")
    check(fs == 0.0 and ft == 0.0, f"GEP n={n}: structure {fs} {ft}")
    check(geo == dict(WA=162, NS=120, B=12, WC=76, TMAX=5), f"GEP n={n}: geometry {geo}")
    for k in GEP_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the GEP path")
    check(stats["recondense_calls"] > 0, "G1's window mode did not run")
    check(ht_kernel_ms > 0, f"GEP n={n}: the profiler saw no G1 device time")
    # the QZ phase again under the profiler: each kernel's device total, the
    # infinite push's window chases and the sweeps (CUDA events around each
    # call)
    inf_ms, sweep_ms = [0.0], [0.0]
    orig, orig_sweep = qz_driver.inf_chase, qz_driver._qz_sweep

    def timed_chase(*a):
        out_, t = timed(lambda: orig(*a))
        inf_ms[0] += t
        return out_

    def timed_sweep(*a):
        sweep_ms[0] += timed(lambda: orig_sweep(*a))[1]
    qz_driver.inf_chase, qz_driver._qz_sweep = timed_chase, timed_sweep
    try:
        _, prof, _ms = profiled_kernels(lambda: gep.schur(H, T, Q, Z))
    finally:
        qz_driver.inf_chase, qz_driver._qz_sweep = orig, orig_sweep
    top = {k: (round(v[0], 3), v[1]) for k, v in list(prof.items())[:12]}
    log(f"  GEP n={n} QZ device time by kernel (ms, calls; under the profiler): {top}")
    g2_g4 = {}
    for label, key in (("G2", "qz_window_kernel"), ("G3", "qz_sweep_kernel"),
                       ("G4", "aed_deflate_gep_kernel"), ("G1w", "ht_win_"),
                       ("G5", "inf_chase_kernel")):
        hits = [v for k, v in prof.items() if key in k]
        g2_g4[label] = (sum(v[0] for v in hits), sum(v[1] for v in hits))
    # the sweeps' device idle share: G3's device time against their time
    idle = 1.0 - g2_g4["G3"][0] / sweep_ms[0] if sweep_ms[0] else None
    log(f"  GEP n={n} QZ phase: G2 {g2_g4['G2'][0]:.1f} ms device time in {g2_g4['G2'][1]} "
        f"launches, G3 {g2_g4['G3'][0]:.1f} ms in {g2_g4['G3'][1]}, G4 {g2_g4['G4'][0]:.1f} ms "
        f"in {g2_g4['G4'][1]}, G1's window mode {g2_g4['G1w'][0]:.1f} ms in {g2_g4['G1w'][1]} "
        f"kernel launches (a chain and a replay a recondense), G5 {g2_g4['G5'][0]:.2f} ms in "
        f"{g2_g4['G5'][1]}; the sweeps {sweep_ms[0]:.1f} ms, G3 idle {idle:.1%} of them "
        f"(under the profiler)")
    check(min(v[1] for v in g2_g4.values()) > 0,
          f"GEP n={n}: the profiler saw no G1 window/G2/G3/G4/G5 launch")
    # the window mode's device total on the path (37.9 ms a WA=162 window in
    # its first, one-block form; ~370 ms over the path's 29 recondenses)
    check(g2_g4["G1w"][0] < 150.0, f"GEP n={n}: G1's window mode took "
          f"{g2_g4['G1w'][0]:.1f} ms of device time")
    log(f"  GEP n={n} HT device time by kernel: "
        f"{ {k: (round(v[0], 3), v[1]) for k, v in list(prof_ht.items())[:10]} }")
    log(f"  GEP n={n} infinite push: {inf_calls[0]} G5 window chases, "
        f"{inf_ms[0]:.1f} ms (CUDA events around each call, under the profiler)")
    chain = gep_chain(A_np, B_np, A, B, S, Tt, Qo, Zo, ar, ai, bt)
    return dict(info=int(info), ht_ms=ht_ms, ht_first_ms=ht_first_ms, qz_ms=qz_ms,
                ht_kernel_ms=ht_kernel_ms, ht_calls=ht_calls,
                ht_kernel_launches=ht_kernel_launches,
                ht_us_a_step=ht_kernel_ms / steps * 1e3,
                ht_bound_ms=ht_bound, ht_bound_by=ht_by,
                residual_a_u=ra, residual_b_u=rb, orth_q_u=oq, orth_z_u=oz,
                structure=(fs, ft), zero_betas=ninf, chordal_u=chordal,
                rounds=stats["rounds"], inf_rounds=stats["inf_rounds"],
                inf_chase_calls=inf_calls[0], inf_chase_ms=inf_ms[0],
                sweeps_ms=sweep_ms[0], sweep_idle_share=idle,
                recondense_calls=stats["recondense_calls"],
                launches={**launches, **chain["launches"]}, g2_g4_device=g2_g4,
                qz_log=stats["qz_log"], profile_qz=prof, profile_ht=prof_ht, chain=chain)


def finite_right_half(alpha, beta):
    """The phase-6 selection (tests/test_torch_gep_api.py's predicate)."""
    return beta != 0 and (alpha / beta).real > 0


def gep_chain(A_np, B_np, A, B, S, T, Q, Z, ar, ai, bt):
    """Phase 6 past QZ: select -> reorder_schur -> eigenvectors of the
    leading selected block, with the launch counts of this path alone."""
    import numpy as np
    import torch
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.api import gep
    from starneig_tpu_torch.errors import Error
    from starneig_tpu_torch.testing import hooks
    n = S.shape[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    sel, select_ms = host_ms(lambda: gep.select(S, T, finite_right_half))
    rstats = {}
    (S2, T2, Q2, Z2, m, rinfo), reorder_ms = timed(
        lambda: gep.reorder_schur(S, T, Q, Z, sel, stats=rstats))
    lead = np.arange(n) < m
    (X, xinfo), eigenvectors_ms = timed(lambda: gep.eigenvectors(S2, T2, Q2, Z2, lead))
    launches = {k: kernels.LAUNCHES[k] for k in GEP_CHAIN_KERNELS}
    ra, rb, oq, oz, fs, ft, _ = gep_gates(A_np, B_np, S2, T2, Q2, Z2, bt)
    ar2, ai2, bt2 = (x.cpu().numpy() for x in gep.eigenvalues(S2, T2))
    before = (ar.cpu().numpy() + 1j * ai.cpu().numpy(), bt.cpu().numpy())
    kept = hooks.chordal_eigenvalue_error(ar2, ai2, bt2, *before) * U
    lead_ok = all(finite_right_half(complex(a, b), c)
                  for a, b, c in zip(ar2[:m], ai2[:m], bt2[:m]))
    rest = sum(finite_right_half(complex(a, b), c)
               for a, b, c in zip(ar2[m:], ai2[m:], bt2[m:]))
    evec = hooks.eigenvector_residual_gep(A_np, B_np, S2, T2, X, lead)
    log(f"  GEP n={n} reorder: info {int(rinfo)}, selected {int(sel.sum())} rows, leading "
        f"block {m} rows ({rest} selected rows left below), reorder_ms {reorder_ms:.1f} "
        f"(select_ms {select_ms:.1f}), windows {rstats.get('windows')} swaps "
        f"{rstats.get('swaps')} failed {rstats.get('failed_swaps')}; residual A {ra:.1f}u "
        f"B {rb:.1f}u, orthogonality Q {oq:.1f}u Z {oz:.1f}u, structure S {fs} T {ft}; "
        f"spectrum moved {kept:.2e} (chordal)")
    log(f"  GEP n={n} eigenvectors: info {int(xinfo)}, {tuple(X.shape)}, eigenvectors_ms "
        f"{eigenvectors_ms:.1f}, worst residual {evec:.2e}; launches {launches}")
    check(rinfo in (Error.SUCCESS, Error.PARTIAL_REORDERING), f"GEP reorder info {rinfo}")
    if rinfo == Error.SUCCESS:
        check(m == int(sel.sum()), f"GEP leading block {m} != {int(sel.sum())}")
    check(lead_ok and (rest == 0 or rinfo == Error.PARTIAL_REORDERING),
          f"GEP reorder: leading block not the selection ({lead_ok}, {rest} left)")
    check(max(ra, rb, oq, oz) < GATE_U, f"GEP reorder gates: {ra} {rb} {oq} {oz}")
    check(fs == 0.0 and ft == 0.0, f"GEP reorder: structure {fs} {ft}")
    check(kept < 1e-10, f"GEP reorder moved the spectrum by {kept} (chordal)")
    check(xinfo in (Error.SUCCESS, Error.CLOSE_EIGENVALUES), f"GEP eigenvectors info {xinfo}")
    check(tuple(X.shape) == (n, m) and bool(torch.isfinite(X).all()),
          "GEP eigenvectors: wrong shape or not finite")
    check(evec < EVEC_BOUND, f"GEP eigenvector residual {evec}")
    for k in GEP_CHAIN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the GEP reordering")
    return dict(info=int(rinfo), selected=int(sel.sum()), lead=m, reorder_ms=reorder_ms,
                select_ms=select_ms, stats=rstats, residual_a_u=ra, residual_b_u=rb,
                orth_q_u=oq, orth_z_u=oz, spectrum_moved_chordal=kept,
                eigenvectors=dict(info=int(xinfo), eigenvectors_ms=eigenvectors_ms,
                                  worst_residual=evec),
                launches=launches)


def phase_gep_inf(dev):
    """api.gep.schur on tests/test_qz_driver.py:103-132's pencil (n=512 in HT
    form, 51 exact T-diagonal zeros, seed 21) under that test's gates, with
    >= 90% of the infinities back with |beta| <= 1e-12 max|beta|; then the
    infinite eigenvalues to the top and their eigenvectors."""
    import numpy as np
    import torch
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.api import gep
    from starneig_tpu_torch.errors import Error
    n = 512
    rng = np.random.default_rng(21)
    H0 = np.triu(rng.standard_normal((n, n)), -1)
    T0 = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    inf_pos = rng.choice(np.arange(1, n - 1), size=n // 10, replace=False)
    for j in inf_pos:
        T0[j, j] = 0.0
    torch.cuda.synchronize()
    kernels.reset_launches()
    stats = {}
    out, qz_ms = timed(lambda: gep.schur(H0, T0, stats=stats, device=dev))
    launches = {k: kernels.LAUNCHES[k] for k in GEP_KERNELS}
    S, Tt, Qo, Zo, _ar, _ai, bt, info = out
    ra, rb, oq, oz, fs, ft, ninf = gep_gates(H0, T0, S, Tt, Qo, Zo, bt)
    log(f"  GEP n={n} infinite-rich: info {int(info)} qz_ms {qz_ms:.1f}; residual "
        f"{ra:.1f}u {rb:.1f}u, orthogonality {oq:.1f}u {oz:.1f}u, structure {fs} {ft}; "
        f"{ninf} of {len(inf_pos)} infinities back; rounds {stats['rounds']} "
        f"({stats['inf_rounds']} with the infinite push); launches {launches}")
    check(int(info) == 0 and max(ra, rb, oq, oz) < GEP_INF_GATE_U and fs == 0.0
          and ft == 0.0, f"GEP n={n} infinite-rich gates")
    check(ninf >= int(0.9 * len(inf_pos)), f"GEP n={n}: {ninf} infinities back")
    check(stats["inf_rounds"] > 0, f"GEP n={n}: no infinite push ran")
    check(launches["inf_chase"] > 0, f"GEP n={n}: G5 was not launched")
    # the infinite eigenvalues to the top: the JAX package leaves every
    # selected one leading, |beta| <= 1e-12 max|beta|, info 0
    # (tests/test_torch_gep_reorder.py::test_reorder_schur_gep_infinite)
    bmax = float(bt.abs().max())
    sel = gep.select(S, Tt, lambda a, b: abs(b) <= 1e-12 * bmax)
    kernels.reset_launches()
    rstats = {}
    (S2, T2, Q2, Z2, m, rinfo), reorder_ms = timed(
        lambda: gep.reorder_schur(S, Tt, Qo, Zo, sel, stats=rstats))
    (X, xinfo), evec_ms = timed(lambda: gep.eigenvectors(S2, T2, Q2, Z2, np.arange(n) < m))
    bubble = kernels.LAUNCHES["reorder_bubble_gep"]
    d = torch.diagonal(T2).abs().cpu().numpy()
    lead_inf = int((d[:m] <= 1e-12 * d.max()).sum())
    Bd = torch.as_tensor(T0, device=dev)
    bx = float(((Bd @ X).norm(dim=0) / (torch.linalg.norm(Bd) * X.norm(dim=0))).max())
    ra2, rb2, oq2, oz2, fs2, ft2, _ = gep_gates(H0, T0, S2, T2, Q2, Z2, bt)
    log(f"  GEP n={n} infinities to the top: info {int(rinfo)}, selected {int(sel.sum())}, "
        f"leading block {m} rows, {lead_inf} of them with |beta| <= 1e-12 max|beta|; "
        f"reorder_ms {reorder_ms:.1f} ({rstats}), G6 launches {bubble}; residual "
        f"{ra2:.1f}u {rb2:.1f}u, orthogonality {oq2:.1f}u {oz2:.1f}u, structure {fs2} {ft2}; "
        f"eigenvectors info {int(xinfo)} {tuple(X.shape)} in {evec_ms:.1f} ms, worst "
        f"||B x|| / (||B||_F ||x||) {bx:.2e}")
    check(rinfo == Error.SUCCESS and m == int(sel.sum()) == lead_inf == ninf,
          f"GEP n={n}: infinities leading {lead_inf} of {m}, selected {int(sel.sum())}")
    check(max(ra2, rb2, oq2, oz2) < GEP_INF_GATE_U and fs2 == 0.0 and ft2 == 0.0,
          f"GEP n={n} reorder gates")
    check(bubble > 0, f"GEP n={n}: G6 was not launched")
    check(tuple(X.shape) == (n, m) and bx < EVEC_BOUND, f"GEP n={n}: ||B x|| {bx}")
    return dict(info=int(info), qz_ms=qz_ms, residual_a_u=ra, residual_b_u=rb,
                orth_q_u=oq, orth_z_u=oz, infinities=ninf, planted=len(inf_pos),
                rounds=stats["rounds"], inf_rounds=stats["inf_rounds"], launches=launches,
                reorder=dict(info=int(rinfo), lead=m, lead_inf=lead_inf,
                             reorder_ms=reorder_ms, stats=rstats,
                             eigenvectors_ms=evec_ms, worst_bx=bx))


CLI_ARGS = ["--experiment", "full-chain", "--generalized", "--init", "known",
            "--complex-ratio", "0.3", "--inf-ratio", "0.1", "--n", "512"]


def phase_cli():
    """The port's CLI through the generalized full chain in a child process
    (the kernels load from phase 2's build): exit code 0 and no hook line
    failed (without --keep-going a failed hook exits 1)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "starneig_tpu_torch.cli", *CLI_ARGS],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for ln in lines:
        log(f"  cli: {ln}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
    log(f"  cli: exit {proc.returncode} in {secs:.1f} s")
    check(proc.returncode == 0 and not any("FAIL" in ln for ln in lines)
          and any(ln.startswith("RESIDUAL") for ln in lines),
          f"the CLI's generalized full chain failed (exit {proc.returncode})")
    return dict(exit=proc.returncode, seconds=secs, lines=lines)


# ---------------------------------------------------------------------------
# DM: the distributed-memory layer in gloo ranks that share the card
# ---------------------------------------------------------------------------
# ranks of phase 10a (n = MAIN_N) and of 10b (DM_N4, the GEP pencil DM_GEP_N)
DM_RANKS_A, DM_RANKS_B = 2, 4
DM_N4, DM_GEP_N = 1200, 512
DM_TIMEOUT_S = 600.0
# what each rank of a DM run may launch: the owner (rank 0) all of them,
# every rank B1 in the sharded Hessenberg reduction
DM_SEP_KERNELS = SCHUR_KERNELS + ("reorder_bubble",)
DM_SHARED_KERNELS = ("hess_gemv",)
DM_GEP_KERNELS = ("ht_cascade", "ht_recondense", "qz_window", "qz_sweep", "aed_deflate_gep",
                  "reorder_bubble_gep")
# 10a's H and Q against phase 5's: the DM reduction sums the panel matvec,
# Ytop and Q V in another order (partial products over the shards, then
# an all_reduce), so it agrees to rounding, not bit for bit.  Measured on
# the H100: H 7.2e-15 ||A||_F, Q 4.1e-13 (PERF.md section 5); the bound,
# in units of ||A||_F for H and absolute for Q, is the single-process
# Hessenberg tests' (tests/test_torch_hessenberg.py)
DM_HESS_TOL = 1e-11


def dm_comm(stats):
    """(calls, bytes, seconds) of one rank's collectives in a stats dict."""
    return (stats.get("all_reduce", 0) + stats.get("broadcast", 0),
            stats.get("collective_bytes", 0), stats.get("collective_s", 0.0))


def dm_launches(cnt):
    """Each rank's nonzero launch counts."""
    return [{k: v for k, v in c["launches"].items() if v} for c in cnt]


def dm_launch_check(label, cnt, kernels_, shared=()):
    """The owner (rank 0) launched each kernel of the path; every other
    rank launched each kernel of ``shared`` and no other."""
    for k in kernels_:
        check(cnt[0]["launches"][k] > 0, f"{label}: the owner did not launch {k}")
    for rank, c in enumerate(cnt[1:], 1):
        check(all(c["launches"][k] > 0 for k in shared),
              f"{label}: rank {rank} did not launch {shared}: {c['launches']}")
        check(not any(v for k, v in c["launches"].items() if k not in shared),
              f"{label}: rank {rank} launched kernels {c['launches']}")


def dm_sep_gates(label, A, S, Q, info):
    """Phase 5's gates on a gathered SEP result (numpy S, Q; A a tensor on
    the device): info, residual and orthogonality < 500 u, standardized
    Schur form."""
    from starneig_tpu_torch.convert import from_numpy
    from starneig_tpu_torch.testing.hooks import schur_form_error
    Sg = from_numpy(S, A.device)
    res, orth = gates(A, Sg, from_numpy(Q, A.device))
    form = schur_form_error(Sg)
    log(f"  {label}: info {info}, residual_u {res:.1f} orthogonality_u {orth:.1f} "
        f"schur_form_error {form}")
    check(info == 0, f"{label}: info {info}")
    check(res < GATE_U and orth < GATE_U, f"{label} gates: {res}, {orth}")
    check(form == 0.0, f"{label}: S not in standardized Schur form ({form})")
    return res, orth


def phase_dm_sep(dev, main_res):
    """10a: api.sep_dm at n=MAIN_N on DM_RANKS_A gloo ranks sharing the
    card, on phase 5's input: hessenberg (column shards, B1 on every
    rank), schur (column shards), select (Re > 0), reorder_schur (column
    shards), eigenvectors of the leading block (rank 0), each stage timed
    to a barrier; gated as phase 5, its H and Q and its spectrum against
    phase 5's, the ranks' V/T hashes equal."""
    import numpy as np
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.convert import from_numpy
    from starneig_tpu_torch.testing import hooks
    from starneig_tpu_torch.testing.dm import run_ranks
    n = MAIN_N
    A_np = np.random.default_rng(0).standard_normal((n, n))
    t0 = time.perf_counter()
    r, cnt = run_ranks("starneig_tpu_torch.testing.dm:sep_chain", DM_RANKS_A,
                       (A_np, "positive_real"), device=str(dev), timeout_s=DM_TIMEOUT_S)
    wall = time.perf_counter() - t0
    A = from_numpy(A_np, dev)
    st = cnt[0]["stats"]["schur"]
    NP = st["NP"]
    res, orth = dm_sep_gates(f"10a n={n} Schur", A, r["S"], r["Q"], r["info"])
    res2, orth2 = dm_sep_gates(f"10a n={n} reordered", A, r["S2"], r["Q2"], r["rinfo"])
    m = r["m"]
    spec = r["er"] + 1j * r["ei"]
    er2, ei2 = (x.cpu().numpy() for x in sep.eigenvalues(r["S2"], device=dev))
    after = er2 + 1j * ei2
    moved = hooks.eigenvalue_error(after, spec) * U
    vs_sm = hooks.eigenvalue_error(spec, main_res["spectrum"]) * U
    evec = eigenvector_residual(A, from_numpy(r["S2"], dev), from_numpy(r["X"], dev), m)
    ms = {k: cnt[0][k] for k in ("hessenberg_ms", "schur_ms", "select_ms",
                                 "reorder_ms", "eigenvectors_ms")}
    comm = {c["rank"]: {stage: dm_comm(stats) for stage, stats in c["stats"].items()}
            for c in cnt}
    shards = [c["stats"]["schur"]["shard_shape"] for c in cnt]
    Hs, Qs = main_res["hess"]
    na = float(np.linalg.norm(A_np))
    dH = float(np.abs(r["H"] - Hs).max()) / na
    dQ = float(np.abs(r["QH"] - Qs).max())
    below = float(np.abs(np.tril(r["H"], -2)).max())
    hashes = [c["stats"]["hessenberg"].get("vt_sha256") for c in cnt]
    hess_b1 = [c["launches"]["hess_gemv"] for c in cnt]
    hess_peak = [c["stats"]["hessenberg"].get("peak_bytes") for c in cnt]
    log(f"  10a n={n} Hessenberg on column shards {[c['shards']['H'] for c in cnt]}: "
        f"B1 launches by rank {hess_b1}; H vs phase 5 {dH:.2e} ||A||_F, Q vs phase 5 "
        f"{dQ:.2e}, below the subdiagonal {below}; V/T SHA-256 by rank "
        f"{[h[:16] for h in hashes]}; collectives by rank (calls, bytes, s) "
        f"{[dm_comm(c['stats']['hessenberg']) for c in cnt]}; peak device memory "
        f"beyond the input shard by rank {hess_peak} bytes")
    log(f"  10a n={n} on {DM_RANKS_A} ranks ({cnt[0]['backend']}, devices "
        f"{[c['device'] for c in cnt]}): {ms}; rounds {st['rounds']} (phase 5: "
        f"{main_res['stats'].get('rounds')}), Schur shards {shards} of NP={NP}; selected "
        f"{r['selected']}, leading block {m}, spectrum moved {moved:.2e}; spectrum vs "
        f"phase 5 {vs_sm:.2e} max|lambda|; eigenvectors: info {r['xinfo']}, "
        f"{r['X'].shape}, worst residual {evec:.2e}; wall {wall:.1f} s (start-up "
        f"{[round(c['startup_s'], 1) for c in cnt]} s, job {cnt[0]['wall_s']:.1f} s, "
        f"teardown {cnt[0]['teardown_s']:.1f} s)")
    for c in cnt:
        log(f"  10a rank {c['rank']}: launches {dm_launches([c])[0]}; collectives by stage "
            f"(calls, bytes, s): {comm[c['rank']]}")
    check(m == r["selected"] == main_res["reorder"]["selected"],
          f"10a: leading block {m}, selected {r['selected']}, phase 5 "
          f"{main_res['reorder']['selected']}")
    check(r["selected"] == int((r["er"] > 0).sum()), "10a: selection != Re > 0 count")
    check(bool((after[:m].real > 0).all()), "10a: a leading eigenvalue fails the predicate")
    check(moved < EIG_MOVE, f"10a: the reordering moved eigenvalues by {moved}")
    check(vs_sm < 1e-10, f"10a: spectrum differs from phase 5's by {vs_sm} max|lambda|")
    check(r["xinfo"] == 0 and r["X"].shape == (n, m), f"10a eigenvectors: {r['xinfo']}")
    check(evec < EVEC_BOUND, f"10a eigenvector residual {evec}")
    check(all(sh == (NP, NP // DM_RANKS_A) for sh in shards), f"10a: Schur shards {shards}")
    check(all(c["stats"]["schur"]["all_reduce"] > 0 for c in cnt),
          "10a: no collective in schur_dm")
    check(len(set(hashes)) == 1 and hashes[0] is not None,
          f"10a: the ranks' Hessenberg panels differ ({hashes})")
    check(dH < DM_HESS_TOL and dQ < DM_HESS_TOL and below == 0.0,
          f"10a: H, Q differ from phase 5's by {dH} ||A||_F, {dQ} (below {below})")
    check(all(c["shards"]["H"] == (n, n // DM_RANKS_A) for c in cnt),
          "10a: H not in column shards")
    check(all("broadcast" not in c["stats"]["hessenberg"] for c in cnt),
          "10a: the Hessenberg stage broadcast (an owner's hand-out)")
    rounds5 = main_res["stats"].get("rounds")
    check(abs(st["rounds"] - rounds5) <= 2, f"10a: {st['rounds']} rounds, phase 5 {rounds5}")
    dm_launch_check("10a", cnt, DM_SEP_KERNELS, DM_SHARED_KERNELS)
    return dict(ms=ms, wall_s=wall, startup_s=[c["startup_s"] for c in cnt],
                hess=dict(h_vs_phase5=dH, q_vs_phase5=dQ, b1_launches=hess_b1,
                          peak_bytes=hess_peak,
                          comm=[dm_comm(c["stats"]["hessenberg"]) for c in cnt],
                          vt_sha256_equal=len(set(hashes)) == 1),
                job_s=cnt[0]["wall_s"], teardown_s=cnt[0]["teardown_s"],
                rounds=st["rounds"], NP=NP, shards=shards,
                residual_u=res, orthogonality_u=orth, reorder_residual_u=res2,
                reorder_orthogonality_u=orth2, lead=m, spectrum_vs_phase5=vs_sm,
                eig_moved=moved, worst_eigvec_residual=evec, comm=comm,
                launches=[c["launches"] for c in cnt])


def phase_dm_four(dev):
    """10b: api.sep_dm.reduce at n=DM_N4 (Re > 0) and api.gep_dm.reduce of
    known_spectrum_pencil(DM_GEP_N, 0.3, 0.1, seed 0) (finite, Re(a/b) >
    0) on DM_RANKS_B gloo ranks sharing the card, under phases 5's and
    6's gates."""
    import numpy as np
    import torch
    from starneig_tpu_torch.convert import from_numpy
    from starneig_tpu_torch.testing.dm import finite_right_half as frh
    from starneig_tpu_torch.testing.dm import run_ranks
    from starneig_tpu_torch.testing.generators import known_spectrum_pencil
    n, ng = DM_N4, DM_GEP_N
    A_np = np.random.default_rng(1).standard_normal((n, n))
    GA, GB, _alpha, _beta = known_spectrum_pencil(ng, complex_ratio=0.3, inf_ratio=0.1,
                                                  seed=0)
    t0 = time.perf_counter()
    (r, g), cnt_all = run_ranks(
        "starneig_tpu_torch.testing.dm:sequence", DM_RANKS_B,
        ([("sep_reduce", (A_np, "positive_real")),
          ("gep_reduce", (GA, GB, "finite_right_half"))],),
        device=str(dev), timeout_s=DM_TIMEOUT_S)
    wall = time.perf_counter() - t0
    cnt, cntg = ([c["steps"][i] for c in cnt_all] for i in range(2))
    log(f"  10b on {DM_RANKS_B} ranks: wall {wall:.1f} s, of it start-up "
        f"{[round(c['startup_s'], 1) for c in cnt_all]} s, the two jobs "
        f"{[round(c['wall_s'], 1) for c in cnt_all]} s, teardown "
        f"{cnt_all[0]['teardown_s']:.1f} s")
    res, orth = dm_sep_gates(f"10b sep_dm.reduce n={n}", from_numpy(A_np, dev),
                             r["S"], r["Q"], r["info"])
    ev = np.sort_complex(r["er"] + 1j * r["ei"])
    d_np = float(np.abs(ev - np.sort_complex(np.linalg.eigvals(A_np))).max()
                 / np.linalg.norm(A_np))
    m, want = r["nsel"], int((r["er"] > 0).sum())
    log(f"  10b sep_dm.reduce n={n} on {DM_RANKS_B} ranks: leading block {m} (Re > 0: "
        f"{want}), eig diff vs numpy {d_np:.2e} |A|, S shards {[c['shards']['S'] for c in cnt]}, "
        f"Schur shards {[c['stats'].get('shard_shape') for c in cnt]}, "
        f"{cnt[0]['wall_s']:.1f} s; "
        f"collectives (calls, bytes, s) {[dm_comm(c['stats']) for c in cnt]}; "
        f"launches {dm_launches(cnt)}")
    check(m == want and bool((r["er"][:m] > 0).all()), f"10b: leading block {m}, {want}")
    check(d_np < 1e-10, f"10b: eigenvalues differ from numpy by {d_np} |A|")
    check(all(c["shards"]["S"] == (n, n // DM_RANKS_B) for c in cnt), "10b: S shards")
    dm_launch_check("10b sep", cnt, DM_SEP_KERNELS, DM_SHARED_KERNELS)

    ra, rb, oq, oz, fs, ft, _ninf = gep_gates(GA, GB, g["S"], g["T"], g["Q"], g["Z"],
                                              torch.as_tensor(g["bt"]))
    sel = [frh(complex(a, b), c) for a, b, c in zip(g["ar"], g["ai"], g["bt"])]
    mg = g["nsel"]
    log(f"  10b gep_dm.reduce n={ng} on {DM_RANKS_B} ranks: info {g['info']}, residual "
        f"A {ra:.1f}u B {rb:.1f}u, orthogonality Q {oq:.1f}u Z {oz:.1f}u, structure S "
        f"{fs} T {ft}, leading block {mg} rows ({sum(sel)} selected), "
        f"{cntg[0]['wall_s']:.1f} s; "
        f"collectives {[dm_comm(c['stats']) for c in cntg]}; launches "
        f"{dm_launches(cntg)}")
    check(g["info"] == 0, f"10b GEP info {g['info']}")
    check(max(ra, rb, oq, oz) < GATE_U, f"10b GEP gates: {ra} {rb} {oq} {oz}")
    check(fs == 0.0 and ft == 0.0, f"10b GEP structure {fs} {ft}")
    check(mg == sum(sel) and all(sel[:mg]), f"10b GEP leading block {mg}, {sum(sel)} selected")
    check(all(c["shards"]["S"] == (ng, ng // DM_RANKS_B) for c in cntg), "10b GEP: S shards")
    dm_launch_check("10b gep", cntg, DM_GEP_KERNELS)
    return dict(wall_s=wall, startup_s=[c["startup_s"] for c in cnt_all],
                teardown_s=cnt_all[0]["teardown_s"],
                sep=dict(job_s=cnt[0]["wall_s"], residual_u=res, orthogonality_u=orth,
                         lead=m, eig_vs_numpy=d_np, comm=[dm_comm(c["stats"]) for c in cnt]),
                gep=dict(job_s=cntg[0]["wall_s"], residual_a_u=ra, residual_b_u=rb, orth_q_u=oq,
                         orth_z_u=oz, lead=mg, comm=[dm_comm(c["stats"]) for c in cntg]))


# ---------------------------------------------------------------------------
# tools and examples
# ---------------------------------------------------------------------------
TOOLS_N = 512                      # the traced chain's size
# the children of phase 11: (module, arguments); the dry run's size is
# STARNEIG_DRYRUN_N (its default, 512)
TOOL_CHILDREN = {
    "sep_full_chain": ("starneig_tpu_torch.examples.sep_full_chain", ["500"]),
    "gep_full_chain": ("starneig_tpu_torch.examples.gep_full_chain", ["200"]),
    "distributed": ("starneig_tpu_torch.examples.distributed", ["256"]),
    "dryrun": ("starneig_tpu_torch.tools.dryrun", ["2"]),
}
TOOL_CHILD_TIMEOUT_S = 300


def phase_tools(dev):
    """11: phase 5's stages at n=TOOLS_N on the card with the sanity checks
    on (each stage's outputs checked, and a check that must fail shown to
    fail) and each stage in a trace span ended by a synchronize; the trace
    dumped and parsed under native/trace_render.cpp's schema.  Then the
    three examples and tools.dryrun in child processes, all started at
    once (they share the card): exit 0, and the residual lines under
    500 u."""
    import json as _json
    import os
    import re
    import tempfile
    import numpy as np
    import torch
    from starneig_tpu_torch.api import sep
    from starneig_tpu_torch.convert import from_numpy
    from starneig_tpu_torch.tools import sanity, trace
    t0 = time.perf_counter()
    n = TOOLS_N
    A = from_numpy(np.random.default_rng(5).standard_normal((n, n)), dev)
    sanity.enable_sanity_checks(True)
    trace.enable_tracing()
    try:
        def stage(label, fn):
            with trace.trace_span(label, (0, 0, n, n), n=n):
                out = fn()
                torch.cuda.synchronize()
            return out
        sanity.check_finite(A, "A")
        H, Q = stage("hessenberg", lambda: sep.hessenberg(A))
        sanity.check_hessenberg(H)
        sanity.check_orthogonality(Q)
        sanity.check_residual_bracket(A, H, Q, "hessenberg")
        try:
            sanity.check_schur_form(H, "H as a Schur form")
            live = False
        except sanity.SanityError:
            live = True
        check(live, "11: check_schur_form passed a Hessenberg matrix")
        S, Q, er, ei, info = stage("schur", lambda: sep.schur(H, Q))
        check(int(info) == 0, f"11: schur info {int(info)}")
        sanity.check_schur_form(S)
        sanity.check_orthogonality(Q)
        sanity.check_residual_bracket(A, S, Q, "schur")
        sel = stage("select", lambda: sep.select(S, positive_real))
        S2, Q2, m, rinfo = stage("reorder", lambda: sep.reorder_schur(S, Q, sel))
        sanity.check_schur_form(S2)
        sanity.check_residual_bracket(A, S2, Q2, "reorder")
        X, xinfo = stage("eigenvectors",
                         lambda: sep.eigenvectors(S2, Q2, np.arange(n) < m))
        sanity.check_finite(X, "X")
        with tempfile.TemporaryDirectory() as tmp:
            path = trace.dump_trace(os.path.join(tmp, "trace.json"), n=n)
            doc = _json.loads(Path(path).read_text())
    finally:
        sanity.enable_sanity_checks(False)
        trace.disable_tracing()
    labels = [e["label"] for e in doc["events"]]
    spans = {e["label"]: (e["end"] - e["begin"]) * 1e3 for e in doc["events"]}
    check(set(doc) == {"n", "events"} and doc["n"] == n, f"11: trace keys {set(doc)}")
    check(labels == ["hessenberg", "schur", "select", "reorder", "eigenvectors"],
          f"11: trace labels {labels}")
    check(all(e["rect"] == [0, 0, n, n] and 0 <= e["begin"] <= e["end"]
              for e in doc["events"]), "11: trace events malformed")
    log(f"  11 n={n}: sanity checks passed on every stage (and failed on H as a "
        f"Schur form); trace of {len(labels)} spans, ms {spans}; leading block {m}")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = {name: subprocess.Popen([sys.executable, "-m", mod, *argv], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, (mod, argv) in TOOL_CHILDREN.items()}
    try:
        kids = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=TOOL_CHILD_TIMEOUT_S)
            kids[name] = dict(exit=p.returncode, lines=out.strip().splitlines())
            for ln in kids[name]["lines"]:
                log(f"  11 {name}: {ln}")
            if p.returncode != 0:
                log(err[-4000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for name, k in kids.items():
        check(k["exit"] == 0 and k["lines"], f"11: {name} exited {k['exit']}")
        for mt in re.finditer(r"(residual[^=]*|orthogonality) =\s*([0-9.]+) u",
                              "\n".join(k["lines"])):
            check(float(mt.group(2)) < GATE_U, f"11: {name}: {mt.group(0)}")
    check(kids["dryrun"]["lines"][-1].startswith("dryrun_multichip(2): full chain ok"),
          "11: the dry run's line")
    log(f"  11: {secs:.1f} s")
    return dict(seconds=secs, spans_ms=spans, children=kids)


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

    t_start = time.perf_counter()
    log("== 1. device")
    smi = phase_device()
    log("== 2. build")
    build_s = phase_build()
    log("== 3. kernels against their plain versions")
    ht_plain = start_ht_plain(dev)
    qz322 = None
    try:
        results = {"hess_gemv": phase_gemv(dev), "francis": phase_francis(dev),
                   "train_hops": phase_train_hops(dev),
                   "aed_deflate": phase_deflate(dev),
                   "recondense": phase_recondense(dev),
                   "reorder_bubble": phase_bubble(dev),
                   "ht_cascade": phase_ht_cascade(dev, ht_plain[2]),
                   "ht_recondense": phase_ht_recondense(dev),
                   "qz_window": phase_qz_window(dev),
                   "qz_sweep": phase_qz_sweep(dev),
                   "aed_deflate_gep": phase_aed_deflate_gep(dev),
                   "inf_chase": phase_inf_chase(dev),
                   "reorder_bubble_gep": phase_bubble_gep(dev)}
        qz322 = results["qz_window"].pop("plain_w322")
        log("== 4. n=1200 with B=70")
        b70 = phase_schur_b70(dev)
        log("== 5. main path")
        main_res = phase_main(dev)
        log(f"== 6. GEP path, n={GEP_N}")
        gep_res = phase_gep(dev)
        log("== 7. GEP n=512 infinite-rich")
        gep_inf = phase_gep_inf(dev)
        log("== 8. the CLI's generalized full chain")
        cli = phase_cli()
        log(f"== 9. G1 at n={GEP_N} against its plain twin")
        finish_ht_plain(ht_plain, results["ht_cascade"],
                        SMOKE_DEADLINE_S - (time.perf_counter() - t_start))
        finish_qz_plain(qz322, results["qz_window"],
                        SMOKE_DEADLINE_S - (time.perf_counter() - t_start))
        log("== 10. DM: gloo ranks sharing the card")
        t_dm = time.perf_counter()
        dm = dict(a=phase_dm_sep(dev, main_res), b=phase_dm_four(dev))
        dm["wall_s"] = time.perf_counter() - t_dm
        log(f"  phase 10: {dm['wall_s']:.1f} s")
        log("== 11. tools and examples")
        tools = phase_tools(dev)
    finally:
        for child in (ht_plain, qz322):
            if child is not None and child[0].is_alive():
                child[0].terminate()
            if child is not None:
                child[0].join()
    launches = {**main_res["launches"], **gep_res["launches"]}

    table = [dict(name=k, route="cuda", source=SOURCES[k],
                  replaces=REPLACES[k], launches=launches[k],
                  max_abs_err=r["max_abs_err"], ms=r["ms"],
                  plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                  bound_by=r["bound_by"], library_ms=r.get("library_ms"))
             for k, r in results.items()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=smi, build_s=build_s, kernels=results, n1200_b70=b70,
                 main={k: v for k, v in main_res.items() if k not in ("spectrum", "hess")},
                 gep=gep_res, gep_inf=gep_inf, cli=cli, dm=dm, tools=tools,
                 torch=torch.__version__,
                 cuda=torch.version.cuda),
            indent=1, default=str))
    log(f"smoke wall seconds: {time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
