"""The port stands alone: importing it pulls in no JAX and builds nothing,
its CPU path never touches the kernel library, and ``chip_smoke.py``
refuses to run without a CUDA card or without the port beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _run(code_or_args, cwd=ROOT):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_pulls_no_jax_and_builds_nothing():
    proc = _run(
        "import sys\n"
        "import starneig_tpu_torch\n"
        "from starneig_tpu_torch.api import gep, sep\n"
        "from starneig_tpu_torch.ops import gpu_hess, gpu_schur, schur\n"
        "from starneig_tpu_torch.ops import gpu_gep, hess_triangular, qz, qz_driver\n"
        "from starneig_tpu_torch.ops import gpu_reorder, reorder, eigenvectors\n"
        "from starneig_tpu_torch.testing import hooks, generators\n"
        "from starneig_tpu_torch import cli, testing\n"
        "from starneig_tpu_torch import kernels, convert\n"
        "from starneig_tpu_torch import node, parallel\n"
        "from starneig_tpu_torch.parallel import distr, dm_core, block_cyclic\n"
        "from starneig_tpu_torch.api import sep_dm, gep_dm\n"
        "from starneig_tpu_torch.testing import dm\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'starneig_tpu' or m.startswith('starneig_tpu.')]\n"
        "assert not bad, bad\n"
        "assert kernels._lib is None and kernels.build_seconds is None\n"
        "print('clean')\n")
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_cpu_path_launches_no_kernel():
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.api import sep
    before = dict(kernels.LAUNCHES)
    A = torch.as_tensor(np.random.default_rng(0).standard_normal((70, 70)))
    H, Q = sep.hessenberg(A, device="cpu")
    S, Q2, er, ei, info = sep.schur(H, Q, device="cpu")
    assert int(info) == 0
    sel = sep.select(S, lambda lam: lam.real > 0)
    S2, Q3, m, rinfo = sep.reorder_schur(S, Q2, sel, device="cpu")
    X, xinfo = sep.eigenvectors(S2, Q3, np.arange(70) < m, device="cpu")
    assert int(rinfo) == 0 and int(xinfo) == 0 and X.shape == (70, m)
    assert kernels.LAUNCHES == before
    assert kernels._lib is None


@pytest.mark.parametrize("wrapper", ["aed_recondense", "window_bubble", "ht_cascade",
                                     "ht_recondense", "qz_window", "qz_sweep",
                                     "aed_deflate_gep", "inf_chase",
                                     "window_bubble_gep"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A wrapper launches its kernel or raises: a CPU tensor never reaches
    the kernel library."""
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.ops import gpu_gep, gpu_reorder, gpu_schur
    T = torch.eye(8, dtype=torch.float64)
    W = torch.eye(16, dtype=torch.float64)         # a train window, B = 2
    calls = {
        "aed_recondense": lambda: gpu_schur.aed_recondense(T, T, 0.5, 4),
        "window_bubble": lambda: gpu_reorder.window_bubble(
            T[None], np.ones((1, 8), bool), [0], [8], [8]),
        "ht_cascade": lambda: gpu_gep.ht_cascade(T, T, T, T),
        "ht_recondense": lambda: gpu_gep.ht_recondense(T, T, T, T, 0.5, 4),
        "qz_window": lambda: gpu_gep.qz_window(T, T, T, T, 8),
        "qz_sweep": lambda: gpu_gep.qz_sweep(W, W, torch.zeros(2, 4, dtype=torch.float64),
                                             4, 12, 0, 2, 6),
        "aed_deflate_gep": lambda: gpu_gep.aed_deflate_gep(T, T, T, T, 0.5, 8, 0.0),
        "inf_chase": lambda: gpu_gep.inf_chase(T, T, 1, 8, -1),
        "window_bubble_gep": lambda: gpu_reorder.window_bubble_gep(
            T[None], T[None], np.ones((1, 8), bool), [0], [8], [8]),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()
    assert kernels._lib is None


def test_gep_cpu_path_launches_no_kernel():
    """The GEP chain on the CPU (the small path and the QZ iteration, then the
    reordering and the eigenvectors) runs the plain twins only."""
    from starneig_tpu_torch import kernels
    from starneig_tpu_torch.api import gep
    from starneig_tpu_torch.config import SchurConf
    before = dict(kernels.LAUNCHES)
    rng = np.random.default_rng(0)
    for n, conf in ((24, None), (32, SchurConf(small_limit=16, aed_window_size=10,
                                                aed_shift_count=8))):
        A, B = rng.standard_normal((n, n)), rng.standard_normal((n, n)) + 3 * np.eye(n)
        H, T, Q, Z = gep.hessenberg_triangular(A, B, device="cpu")
        stats = {}
        S, Tt, Qs, Zs, *_, info = gep.schur(H, T, Q, Z, conf=conf, stats=stats,
                                            device="cpu")
        assert int(info) == 0 and stats["path"] == ("small" if conf is None else "aed")
        sel = gep.select(S, Tt, lambda a, b: b != 0 and (a / b).real > 0)
        assert sel.dtype == bool and sel.shape == (n,)
        S2, T2, Q2, Z2, m, rinfo = gep.reorder_schur(S, Tt, Qs, Zs, sel, device="cpu")
        X, xinfo = gep.eigenvectors(S2, T2, Q2, Z2, np.arange(n) < m, device="cpu")
        assert int(rinfo) == 0 and m == int(sel.sum()) and X.shape == (n, m)
    assert kernels.LAUNCHES == before
    assert kernels._lib is None


def test_chip_smoke_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script runs instead")
    proc = _run([str(ROOT / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_needs_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
