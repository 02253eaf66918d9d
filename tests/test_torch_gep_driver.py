"""The port's multishift QZ driver and its building blocks against the JAX
package's XLA path, on the same seeded inputs (CPU).

Single steps (the GEP spike deflation, a QZ train, the final block
standardization) agree elementwise to 1e-12: the same operations in
another summation order; the port's train runs in (6B+4)-row windows with
GEMM strip updates, the JAX one at full width.  The whole driver is held to
what it guarantees (the gates of tests/test_qz_driver.py): info, exact
generalized Schur structure, residuals and orthogonality below 5000 u.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops import hess_triangular as jht
from starneig_tpu.ops import qz_driver as jqd
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import qz_driver as tqd
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import planted_schur_pair

torch.set_num_threads(1)

U = np.finfo(np.float64).eps


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-300)


@pytest.mark.parametrize("s", [1e-13, 1e-10])
def test_aed_deflate_gep(s):
    """kbot and fail equal, the matrices within 1e-12 (spike 1e-13: some
    bottom blocks deflate, the others move up; 1e-10: none deflates and
    every block moves)."""
    WA = 40
    S, T, Q, Z = planted_schur_pair(WA, WA - 2, 7)
    thresh = U / 2 * np.linalg.norm(S)
    want = jqd._aed_deflate_gep(*(jnp.asarray(x) for x in (S, T, Q, Z)), s, WA - 2, thresh)
    got = tqd._aed_deflate_gep(*(from_numpy(x) for x in (S, T, Q, Z)), s, WA - 2, thresh)
    assert (int(got[4]), int(got[5])) == (int(want[4]), bool(want[5]))
    for w, g in zip(want[:4], got[:4]):
        assert _rel(w, to_numpy(g)) <= 1e-12


def _padded_pencil(n, P, l, seed):
    NP = n + 2 * P
    rng = np.random.default_rng(seed)
    S = np.zeros((NP, NP))
    T = np.zeros((NP, NP))
    S[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n)), -1)
    S[P + l, P + l - 1] = 0.0
    T[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    Q = np.zeros((n, NP))
    Q[:, P:P + n] = np.eye(n)
    return S, T, Q, Q.copy()


@pytest.mark.parametrize("B,n,l,ihi", [(3, 60, 5, 50), (12, 100, 4, 100)])
def test_qz_sweep(B, n, l, ihi):
    """One B-bulge train across [l, ihi): the port's windowed hops against
    the JAX full-width _qz_sweep_batch, 1e-12 relative."""
    P = 6 * B + 6
    S, T, Q, Z = _padded_pencil(n, P, l, 3 + B)
    sh = np.random.default_rng(B).standard_normal((B, 4))
    sh[:, 3] = -sh[:, 1]
    want = jqd._qz_sweep_batch(*(jnp.asarray(x) for x in (S, T, Q, Z)), P + l, P + ihi,
                               *(jnp.asarray(sh[:, i]) for i in range(4)), B=B)
    got = [from_numpy(x) for x in (S, T, Q, Z)]
    tqd._qz_sweep(*got, P + l, P + ihi, from_numpy(sh), B)
    for w, g in zip(want, got):
        assert _rel(w, to_numpy(g)) <= 1e-12


def test_standardize_blocks_gep():
    S, T, Q, Z = planted_schur_pair(30, 30, 4)
    # unstandardized blocks: a real pair, a coupled T entry
    S[10, 9] = 0.8
    S[9, 10] = 0.5
    T[20, 21] = 0.3
    want = jqd.standardize_blocks_gep(*(jnp.asarray(x) for x in (S, T, Q, Z)))
    got = tqd.standardize_blocks_gep(*(from_numpy(x) for x in (S, T, Q, Z)))
    for w, g in zip(want, got):
        assert _rel(w, to_numpy(g)) <= 1e-12


def test_qz_schur_n48():
    """The driver at n=48 with the default configuration (WA = 32)."""
    n = 48
    rng = np.random.default_rng(1)
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n)) + 3 * np.eye(n)
    H, T, Q, Z = (np.asarray(x) for x in jht.hessenberg_triangular(A, B))
    want = jqd.qz_schur(*(jnp.asarray(x) for x in (H, T, Q, Z)))
    stats = {}
    got = tqd.qz_schur(*(from_numpy(x) for x in (H, T, Q, Z)), stats=stats)
    assert want[7] == got[7] == Error.SUCCESS
    for S_, T_, Q_, Z_ in (want[:4], got[:4]):
        assert hooks.schur_structure_error(S_) == 0.0
        assert hooks.triangular_structure_error(T_) == 0.0
        ra, rb = hooks.residual_gep(A, B, S_, T_, Q_, Z_)
        assert max(ra, rb, hooks.orthogonality(Q_), hooks.orthogonality(Z_)) < 5000
    ev_j = np.sort_complex((np.asarray(want[4]) + 1j * np.asarray(want[5])) / np.asarray(want[6]))
    ev_t = np.sort_complex((to_numpy(got[4]) + 1j * to_numpy(got[5])) / to_numpy(got[6]))
    assert np.abs(ev_j - ev_t).max() <= 1e-9 * np.abs(ev_j).max()
    assert stats["rounds"] > 0 and stats["recondense_calls"] > 0
