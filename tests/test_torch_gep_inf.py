"""The port's QZ driver on the infinite-eigenvalue segment of
tests/test_qz_driver.py:58-91 (n=120 in HT form, exact T-diagonal zeros at
five non-adjacent rows, small limit 32, AED window 24): the rounds that
push an infinite eigenvalue down in windows run (plain PyTorch), and both
packages pass that test's gates and recover every planted infinity with
beta == 0 (|beta| <= 1e-12 max|beta|) (CPU).  The push's window chase
(``_inf_chase_kernel``, the plain twin of kernel G5) is also held to JAX's
elementwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.config import SchurConf as JSchurConf
from starneig_tpu.ops import qz_driver as jqd
from starneig_tpu_torch.convert import conf_from_jax, from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import qz_driver as tqd
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import inf_push_window

torch.set_num_threads(1)


def test_qz_schur_inf_large_segment():
    rng = np.random.default_rng(11)
    n = 120
    H0 = np.triu(rng.standard_normal((n, n)), -1)
    T0 = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    inf_pos = [15, 40, 62, 77, 103]
    for j in inf_pos:
        T0[j, j] = 0.0
    conf = JSchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    want = jqd.qz_schur(jnp.asarray(H0), jnp.asarray(T0), conf=conf)
    stats = {}
    got = tqd.qz_schur(from_numpy(H0), from_numpy(T0), conf=conf_from_jax(conf),
                       stats=stats)
    assert want[7] == got[7] == Error.SUCCESS
    for S_, T_, Q_, Z_, _ar, _ai, bt, _info in (want, got):
        S_, T_, Q_, Z_, bt = (to_numpy(x) if torch.is_tensor(x) else np.asarray(x)
                              for x in (S_, T_, Q_, Z_, bt))
        assert hooks.schur_structure_error(S_) == 0.0
        assert hooks.triangular_structure_error(T_) == 0.0
        ra, rb = hooks.residual_gep(H0, T0, S_, T_, Q_, Z_)
        assert max(ra, rb, hooks.orthogonality(Q_), hooks.orthogonality(Z_)) < 5000
        assert int((np.abs(bt) <= 1e-12 * np.abs(bt).max()).sum()) >= len(inf_pos)
    assert stats["inf_rounds"] >= len(inf_pos) and stats["inf_chase_calls"] > 0


@pytest.mark.parametrize("jrel,mrel,lrel", [(1, 24, -1), (0, 24, 0), (5, 17, 5),
                                            (3, 20, -1)])
def test_inf_chase_kernel(jrel, mrel, lrel):
    """The window chase of the infinite push (the twin of kernel G5) against
    JAX's _inf_chase_kernel at Wb = 24, with the right reflection skipped at
    lrel (the segment top) or not skipped (lrel = -1): the same rotations,
    within 1e-13 max|M|; the zero planted and moved to mrel - 1."""
    Wb = 24
    H, T = inf_push_window(Wb, 24 + jrel, jrel, lrel)
    want = jqd._inf_chase_kernel(jnp.asarray(H), jnp.asarray(T), jrel, mrel, lrel, Wb)
    got = tqd._inf_chase_kernel(from_numpy(H), from_numpy(T), jrel, mrel, lrel)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.abs(w - to_numpy(g)).max() <= 1e-13 * np.abs(w).max()
    Tg = to_numpy(got[1])
    assert Tg[mrel - 1, mrel - 1] == 0.0
    assert hooks.triangular_structure_error(Tg) == 0.0
    assert hooks.hessenberg_structure_error(to_numpy(got[0])) == 0.0
