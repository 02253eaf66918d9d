"""The port's SEP eigenvectors against the JAX package's, on the same
seeded Schur forms (CPU).

Both run the same guarded backward substitution, batched over the
selected eigenvalues, so the unit-norm vectors agree within 1e-12
elementwise (summation order only) and the info codes are equal.  The
port's vectors are also held to ``tests/test_eigenvectors.py``'s bounds:
a relative eigenvector residual below 1e-12, and below 1e-10 of the row
scale on the graded matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops.eigenvectors import eigenvectors_schur as jevec
from starneig_tpu.ops.small_schur import small_schur as jsmall
from starneig_tpu.testing import random_hessenberg
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import eigenvectors as tev_mod
from starneig_tpu_torch.ops.eigenvectors import eigenvectors_schur as tevec
from starneig_tpu_torch.testing import generators

torch.set_num_threads(1)


def _schur(n, seed):
    H = random_hessenberg(n, seed=seed)
    S, Q, info = jsmall(jnp.array(H), jnp.eye(n), n)
    assert int(info) == 0
    return H, np.asarray(S), np.asarray(Q)


def _planted(case):
    """(None, S, I, select) of a numpy-made Schur form (no Hessenberg input)."""
    S, sel = case
    return None, S, np.eye(S.shape[0]), sel


def _random(n, seed, pick):
    H, S, Q = _schur(n, seed)
    return H, S, Q, pick(n)


CASES = {
    "all_selected": lambda: _random(32, 1, lambda n: np.ones(n, bool)),
    "subset_with_pairs": lambda: _random(40, 2, lambda n: np.random.default_rng(41).random(n) < 0.3),
    "none_selected": lambda: _random(10, 3, lambda n: np.zeros(n, bool)),
    "graded": lambda: _planted(generators.graded_schur()),
    "close_eigenvalues": lambda: _planted(generators.close_schur(False)),
    "distinct_eigenvalues": lambda: _planted(generators.close_schur(True)),
    "growth": lambda: _planted(generators.growth_schur()),
}


def _worst_residual(A, S, X, select):
    """max ||A x - lambda x|| / (||A|| ||x||) over the columns of X."""
    n = S.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    d, sup = np.diagonal(S), np.concatenate([np.diagonal(S, 1), [0.0]])
    worst, c, i = 0.0, 0, 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                lam = 0.5 * (d[i] + d[i + 1]) + 1j * np.sqrt(abs(sup[i]) * abs(sub[i]))
                x = X[:, c] + 1j * X[:, c + 1]
                c += 2
            else:
                i += 2
                continue
            i += 2
        else:
            if not select[i]:
                i += 1
                continue
            lam, x = d[i], X[:, c].astype(complex)
            c += 1
            i += 1
        r = np.linalg.norm(A @ x - lam * x) / (np.linalg.norm(A) * np.linalg.norm(x))
        worst = max(worst, r)
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_eigenvectors_schur(case):
    H, S, Q, sel = CASES[case]()
    Xj, infoj = jevec(jnp.asarray(S), jnp.asarray(Q), sel)
    Xt, infot = tevec(from_numpy(S), from_numpy(Q), sel)
    Xj, Xt = np.asarray(Xj), to_numpy(Xt)
    assert int(infot) == int(infoj)
    assert Xt.shape == Xj.shape
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-12)
    assert np.isfinite(Xt).all()
    if case == "none_selected":
        assert Xt.shape == (S.shape[0], 0)
    elif case == "close_eigenvalues":
        assert infot == Error.CLOSE_EIGENVALUES
    elif case == "graded":
        for c, j in enumerate((20, 39)):
            x = Xt[:, c]
            denom = np.max(np.abs(S) @ np.abs(x)) + S[j, j] * np.abs(x).max()
            assert np.linalg.norm(S @ x - S[j, j] * x) / denom < 1e-10
    else:
        assert infot == Error.SUCCESS
        if H is not None:
            assert _worst_residual(H, S, Xt, sel) < 1e-12


def test_eigenvectors_rescale_fires(monkeypatch):
    """The growth case scales its vectors (fac < 1) in the plain row loop,
    and the guarded result still matches JAX, finite and normalized."""
    facs = []
    rescale = tev_mod._rescale

    def spy(*args):
        fac = rescale(*args)
        facs.append(float(fac.min()))
        return fac
    monkeypatch.setattr(tev_mod, "_rescale", spy)
    S, sel = generators.growth_schur()
    Q = np.eye(S.shape[0])
    Xt, infot = tevec(from_numpy(S), from_numpy(Q), sel)
    assert min(facs) < 1e-50           # at least one vector scaled down hard
    Xj, infoj = jevec(jnp.asarray(S), jnp.asarray(Q), sel)
    assert int(infot) == int(infoj) == Error.SUCCESS
    Xt = to_numpy(Xt)
    np.testing.assert_allclose(Xt, np.asarray(Xj), rtol=0, atol=1e-12)
    assert np.isfinite(Xt).all()
    np.testing.assert_allclose(np.linalg.norm(Xt, axis=0), 1.0, rtol=0, atol=1e-14)
