"""The tracer's clock and the program's counters against the card's own
record (``torch.profiler``'s CUDA activity).

Every test needs a CUDA device and nvcc and skips without one; on the
card ``python -m pytest --noconftest tests/test_torch_trace_card.py``
builds the kernels and runs them (about a minute).

* clock agreement: a span that launches a program kernel and ends in a
  synchronize contains that kernel's device event;
* ``kernels.LAUNCHES`` over one ``gep.hessenberg_triangular`` and one
  ``gep.schur`` at n=2000 (the benchmark's GEP pencil) equals the
  program's kernels in the device trace (``kernels.kernel_names``);
* B2's and G2's chase steps: the count B2 writes beside its info is a
  sweep's i - l (one iteration over the whole block: m - 1 steps, as its
  plain twin counts), G2's is within 5% of its twin's, and the drivers'
  ``stats["chase_steps"]`` is positive and the sum of ``round_log``'s.
"""

import numpy as np
import pytest
import torch

from starneig_tpu_torch import kernels
from starneig_tpu_torch.api import gep, sep
from starneig_tpu_torch.ops import gpu_gep, gpu_schur
from starneig_tpu_torch.ops.qz import _small_qz_plain
from starneig_tpu_torch.ops.small_schur import _small_schur_plain
from starneig_tpu_torch.testing.generators import known_spectrum_pencil
from starneig_tpu_torch.tools import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _device_events(fn):
    """fn() under torch.profiler's CUDA activity: (its result, the device
    events as (short name, start_ns, end_ns))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    evs = [(e.name().replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0].split("<")[0], e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return out, evs


def _hessenberg(n, seed):
    return np.triu(np.random.default_rng(seed).standard_normal((n, n)), -1)


def test_span_contains_its_kernel(cuda):
    H = torch.as_tensor(_hessenberg(96, 1), device=cuda)
    Z = torch.eye(96, dtype=torch.float64, device=cuda)
    gpu_schur.francis(H, Z, 96)                    # built and loaded
    torch.cuda.synchronize()

    def probe():
        trace.enable_tracing()
        with trace.trace_span("probe"):
            gpu_schur.francis(H, Z, 96)
            torch.cuda.synchronize()
        trace.disable_tracing()

    _, evs = _device_events(probe)
    (label, b, e), = trace.events_ns()
    (_, kb, ke), = [x for x in evs if x[0] == "francis_kernel"]
    assert label == "probe" and b <= kb <= ke <= e


def test_launches_match_the_device_trace(cuda):
    names = kernels.kernel_names()
    A, B, _a, _b = known_spectrum_pencil(2000, complex_ratio=0.3, inf_ratio=0.1, seed=0)
    A, B = (torch.as_tensor(M, device=cuda) for M in (A, B))
    gep.hessenberg_triangular(A[:64, :64], B[:64, :64])   # built and warm
    for step in ("hessenberg_triangular", "schur"):
        l0 = sum(kernels.LAUNCHES.values())
        if step == "hessenberg_triangular":
            out, evs = _device_events(lambda: gep.hessenberg_triangular(A, B))
            HT = out
        else:
            stats = {}
            out, evs = _device_events(lambda: gep.schur(*HT, stats=stats))
            assert stats["chase_steps"] == sum(r[3] for r in stats["round_log"]) > 0
        launched = sum(kernels.LAUNCHES.values()) - l0
        traced = sum(1 for x in evs if x[0] in names)
        assert launched == traced > 0, step


def test_b2_steps(cuda):
    """One iteration over a random Hessenberg block of m rows is one sweep
    of m - 1 steps, in the kernel and in its twin."""
    w, m = 96, 90
    H = torch.as_tensor(_hessenberg(w, 2))
    Z = torch.eye(w, dtype=torch.float64)
    *_k, steps = gpu_schur.francis(H.to(cuda), Z.to(cuda), m, max_total_iter=1,
                                   with_steps=True)
    *_p, psteps = _small_schur_plain(H, Z, m, max_total_iter=1, with_steps=True)
    assert int(steps) == int(psteps) == m - 1


def test_g2_steps(cuda):
    w = 96
    rng = np.random.default_rng(3)
    H = torch.as_tensor(np.triu(rng.standard_normal((w, w)), -1))
    T = torch.as_tensor(np.triu(rng.standard_normal((w, w))) + 3 * np.eye(w))
    eye = torch.eye(w, dtype=torch.float64)
    *_k, info, steps = gpu_gep.qz_window(*(M.to(cuda) for M in (H, T, eye, eye)), w,
                                         with_steps=True)
    *_p, pinfo, psteps = _small_qz_plain(H, T, eye, eye, w, with_steps=True)
    assert int(info) == int(pinfo) == 0
    assert int(psteps) > 0 and abs(int(steps) - int(psteps)) <= 0.05 * int(psteps)


def test_sep_schur_steps(cuda):
    H, Q = sep.hessenberg(torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1200, 1200)), device=cuda))
    stats = {}
    *_out, info = sep.schur(H, Q, stats=stats)
    assert int(info) == 0 and stats["path"] == "aed"
    assert len(stats["round_log"]) == stats["rounds"]
    assert stats["chase_steps"] == sum(r[3] for r in stats["round_log"]) > 0
