"""The port's generalized eigenvectors (``ops/eigenvectors.py``:
``eigenvectors_schur_gep``) against the JAX package's, on the three inputs
of tests/test_eigenvectors_gep.py (CPU): n = 24 with every eigenvalue
selected, n = 32 with a subset, n = 20 with infinite eigenvalues.

Both run the same recurrence per eigenvalue (the port batched over the
eigenvalues, JAX vmapped), so info is equal and X agrees within 1e-10
max|X| (summation order of the row products); the port's vectors also
pass that test's residual checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from starneig_tpu.ops.eigenvectors import eigenvectors_schur_gep as j_evec_gep
from starneig_tpu.ops.hess_triangular import hessenberg_triangular
from starneig_tpu.ops.qz import small_qz
from starneig_tpu.testing import known_spectrum_pencil, random_dense
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.ops.eigenvectors import eigenvectors_schur_gep

torch.set_num_threads(1)


def _make(n, seed, **kw):
    """tests/test_eigenvectors_gep.py:_make."""
    if kw:
        A, B, _alpha, _beta = known_spectrum_pencil(n, seed=seed, **kw)
    else:
        A = random_dense(n, seed=seed)
        B = random_dense(n, seed=seed + 77) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, Qo, Zo, info = small_qz(H, T, Q, Z, n)
    assert int(info) == 0
    return A, B, *map(np.asarray, (S, Tt, Qo, Zo))


def _worst_residual(A, B, S, Tt, X, select):
    """tests/test_eigenvectors_gep.py:_check_vectors: beta A x = alpha B x
    per returned column (B x = 0 for an infinite eigenvalue)."""
    n = A.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    nrm = np.linalg.norm(A) + np.linalg.norm(B)
    worst = 0.0
    c = i = 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                ev = scipy.linalg.eigvals(S[i:i + 2, i:i + 2], Tt[i:i + 2, i:i + 2])
                lam = ev[0] if ev[0].imag > 0 else ev[1]
                x = X[:, c] + 1j * X[:, c + 1]
                worst = max(worst, np.linalg.norm(A @ x - lam * (B @ x))
                            / (nrm * np.linalg.norm(x)))
                c += 2
            i += 2
        else:
            if select[i]:
                x = X[:, c]
                if abs(Tt[i, i]) > 1e-12:
                    lam = S[i, i] / Tt[i, i]
                    r = np.linalg.norm(A @ x - lam * (B @ x)) / (
                        nrm * np.linalg.norm(x) * max(1, abs(lam)))
                else:
                    r = np.linalg.norm(B @ x) / (nrm * np.linalg.norm(x))
                worst = max(worst, r)
                c += 1
            i += 1
    return worst


@pytest.mark.parametrize("case", ["all", "subset", "infinite"])
def test_eigenvectors_schur_gep(case):
    n, seed, kw = {"all": (24, 1, {}), "subset": (32, 5, {}),
                   "infinite": (20, 9, dict(complex_ratio=0.2, inf_ratio=0.2))}[case]
    A, B, S, Tt, Q, Z = _make(n, seed, **kw)
    sel = (np.random.default_rng(0).random(n) < 0.4) if case == "subset" \
        else np.ones(n, bool)
    Xj, infoj = j_evec_gep(jnp.asarray(S), jnp.asarray(Tt), jnp.asarray(Q),
                           jnp.asarray(Z), sel)
    Xt, infot = eigenvectors_schur_gep(*(from_numpy(x) for x in (S, Tt, Q, Z)), sel)
    Xj = np.asarray(Xj)
    assert infot == infoj
    assert Xt.shape == Xj.shape
    assert np.abs(to_numpy(Xt) - Xj).max() <= 1e-10 * np.abs(Xj).max()
    bound = 1e-8 if case == "infinite" else 1e-10     # that test's bounds
    assert _worst_residual(A, B, S, Tt, to_numpy(Xt), sel) < bound
    if case == "infinite":
        assert (np.abs(np.diagonal(Tt)) <= 1e-12 * np.abs(np.diagonal(Tt)).max()).any()


def test_eigenvectors_schur_gep_none_selected():
    _A, _B, S, Tt, Q, Z = _make(8, 3)
    X, info = eigenvectors_schur_gep(*(from_numpy(x) for x in (S, Tt, Q, Z)),
                                     np.zeros(8, bool))
    assert X.shape == (8, 0) and int(info) == 0
