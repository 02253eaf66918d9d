"""The port's scalar primitives and eigenvalue extraction against the JAX
package's, on the same seeded inputs (CPU, float64).

Tolerance: 1e-13 relative.  Both sides evaluate the same formulas in IEEE
float64; they differ only where XLA and PyTorch order a sum differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops import eigvals as jeig
from starneig_tpu.ops import primitives as jprim
from starneig_tpu_torch.ops import eigvals as teig
from starneig_tpu_torch.ops import primitives as tprim

torch.set_num_threads(1)

RTOL = 1e-13


def _close(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.all(err <= RTOL), float(err.max())


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _quads(seed, n=64):
    """Random 2x2 entries plus the special cases of each select chain."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, n))
    special = np.array([
        [1.0, 2.0, 0.0, 3.0],        # c == 0
        [1.0, 0.0, 2.0, 3.0],        # b == 0
        [1.5, 2.0, -1.0, 1.5],       # equal diagonal, opposite signs
        [1.5, 2.0, 1.0, 1.5],        # equal diagonal, same signs
        [0.0, 0.0, 0.0, 0.0],        # all zero
        [1.0, 1e-300, 1e-300, 1.0],  # tiny coupling
        [2.0, -3.0, 3.0, 2.0],       # standardized complex pair
    ]).T
    return np.concatenate([q, special], axis=1)


HOUSEHOLDER_CASES = {
    "dense": (np.random.default_rng(1).standard_normal(7), None),
    "masked": (np.random.default_rng(2).standard_normal(16),
               np.arange(16) < 5),
    "rolled-mask": (np.random.default_rng(3).standard_normal(6),
                    np.array([True, False, True, True, False, True])),
    "zero-tail": (np.array([3.0, 0.0, 0.0]), None),
    "all-zero": (np.zeros(4), None),
    "tiny": (1e-200 * np.random.default_rng(4).standard_normal(5), None),
    "batched": (np.random.default_rng(5).standard_normal((9, 3)),
                np.tile([True, True, False], (9, 1))),
}


@pytest.mark.parametrize("case", sorted(HOUSEHOLDER_CASES))
def test_householder(case):
    x, mask = HOUSEHOLDER_CASES[case]
    if x.ndim == 2:
        want = jax.vmap(jprim.householder)(jnp.asarray(x), jnp.asarray(mask))
    else:
        want = jprim.householder(jnp.asarray(x),
                                 None if mask is None else jnp.asarray(mask))
    got = tprim.householder(_t(x), None if mask is None else torch.as_tensor(mask))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_givens(seed):
    rng = np.random.default_rng(seed)
    f = np.concatenate([rng.standard_normal(32), [0.0, 5.0, 0.0, -2.0]])
    g = np.concatenate([rng.standard_normal(32), [5.0, 0.0, 0.0, 1.0]])
    want = jprim.givens(jnp.asarray(f), jnp.asarray(g))
    got = tprim.givens(_t(f), _t(g))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("fn", ["eig2x2", "standardize_2x2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_two_by_two(fn, seed):
    q = _quads(seed)
    want = getattr(jprim, fn)(*map(jnp.asarray, q))
    got = getattr(tprim, fn)(*map(_t, q))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("use3", [True, False])
def test_first_column_shifted(use3):
    rng = np.random.default_rng(7 + use3)
    h = rng.standard_normal((3, 3))
    sh = rng.standard_normal((4, 8))
    sh[3] = -sh[1]
    sh[:, 0] = 0.0                      # zero shifts, nonzero block
    want = jax.vmap(lambda a, b, c, d: jprim.first_column_shifted(
        jnp.asarray(h), a, b, c, d, use3))(*map(jnp.asarray, sh))
    got = tprim.first_column_shifted(_t(h), *map(_t, sh), use3)
    _close(got, want)
    zero = tprim.first_column_shifted(torch.zeros(3, 3, dtype=torch.float64),
                                      *map(_t, np.zeros(4)), use3)
    _close(zero, np.zeros(3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_eigenvalues(seed):
    rng = np.random.default_rng(seed)
    n = 24
    S = np.triu(rng.standard_normal((n, n)))
    for p in range(1 + seed, n - 1, 5):     # 2x2 blocks, complex and real
        S[p + 1, p] = rng.standard_normal()
    want = jeig.extract_eigenvalues(jnp.asarray(S))
    got = teig.extract_eigenvalues(_t(S))
    for a, b in zip(got, want):
        _close(a, b)
