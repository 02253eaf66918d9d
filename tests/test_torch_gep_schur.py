"""The port's multishift QZ driver with AED at n=150, on the configuration
of tests/test_qz_driver.py:46-56 (small limit 32, AED window 24, 16
shifts), against the JAX package (CPU): both pass that test's gates (info,
exact structure, residuals and orthogonality below 5000 u), and their
spectra agree with scipy's within its eigenvalue bound (5e5 u)."""

import jax.numpy as jnp
import numpy as np
import scipy.linalg
import torch

from starneig_tpu.config import SchurConf as JSchurConf
from starneig_tpu.ops import hess_triangular as jht
from starneig_tpu.ops import qz_driver as jqd
from starneig_tpu_torch.convert import conf_from_jax, from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import qz_driver as tqd
from starneig_tpu_torch.testing import hooks

torch.set_num_threads(1)


def test_qz_schur_aed_path():
    n = 150
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n)) + 3 * np.eye(n)
    H, T, Q, Z = (np.asarray(x) for x in jht.hessenberg_triangular(A, B))
    conf = JSchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    want = jqd.qz_schur(*(jnp.asarray(x) for x in (H, T, Q, Z)), conf=conf)
    stats = {}
    got = tqd.qz_schur(*(from_numpy(x) for x in (H, T, Q, Z)), conf=conf_from_jax(conf),
                       stats=stats)
    assert want[7] == got[7] == Error.SUCCESS
    assert (stats["WA"], stats["NS"], stats["B"]) == (32, 16, 12)
    ev_ref = scipy.linalg.eigvals(A, B)
    for S_, T_, Q_, Z_, ar, ai, bt, _info in (want, got):
        S_, T_, Q_, Z_, ar, ai, bt = (to_numpy(x) if torch.is_tensor(x) else np.asarray(x)
                                      for x in (S_, T_, Q_, Z_, ar, ai, bt))
        assert hooks.schur_structure_error(S_) == 0.0
        assert hooks.triangular_structure_error(T_) == 0.0
        ra, rb = hooks.residual_gep(A, B, S_, T_, Q_, Z_)
        assert max(ra, rb, hooks.orthogonality(Q_), hooks.orthogonality(Z_)) < 5000
        safe = np.where(np.abs(bt) < 1e-12, 1e-12, bt)
        assert hooks.eigenvalue_error((ar + 1j * ai) / safe, ev_ref) < 5e5
    assert stats["rounds"] > 1 and stats["inf_rounds"] == 0
