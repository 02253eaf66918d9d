"""The port's adjacent block swap against the JAX package's.

Same seeded 4x4 inputs (the construction of tests/test_swaps.py); Q and
Dh agree elementwise to 1e-12 (the 4x4 Sylvester solve and QR run the
same operations in a different summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops.swaps import swap_adjacent as jswap
from starneig_tpu_torch.ops.swaps import swap_adjacent as tswap

torch.set_num_threads(1)

TOL = 1e-12


def _block(p, rng):
    if p == 1:
        return np.array([[rng.standard_normal()]])
    a = rng.standard_normal()
    return np.array([[a, abs(rng.standard_normal()) + 0.2],
                     [-(abs(rng.standard_normal()) + 0.2), a]])


def _d4(p, q, seed):
    rng = np.random.default_rng(seed)
    D = np.triu(rng.standard_normal((4, 4)))
    D[:p, :p] = _block(p, rng)
    D[p:p + q, p:p + q] = _block(q, rng)
    D[p:p + q, :p] = 0
    D[p + q:, :p + q] = 0
    return D


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p,q", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_swap_adjacent(p, q, seed):
    D = _d4(p, q, 10 * p + q + 100 * seed)
    Qj, Dj, aj = jswap(jnp.asarray(D), p, q)
    Qt, Dt, at = tswap(torch.as_tensor(D), p, q)
    assert bool(aj) == bool(at)
    scale = 1 + np.abs(D).max()
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), atol=TOL)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=TOL * scale)
    # the (2,1) block is exactly zero on both sides
    assert np.all(Dt.numpy()[q:p + q, :q] == 0)


def test_swap_near_identical_blocks():
    # two nearly identical 2x2 blocks: an ill-conditioned swap whose
    # acceptance is a rounding-level decision, so each side is held to the
    # contract on its own: accepted with a small backward error, or
    # rejected as the identity
    rng = np.random.default_rng(4)
    blk = _block(2, rng)
    D = np.triu(rng.standard_normal((4, 4))) * 1e-8
    D[:2, :2] = blk
    D[2:, 2:] = blk + 1e-13 * rng.standard_normal((2, 2))
    D[2:, :2] = 0
    Qt, Dt, at = tswap(torch.as_tensor(D), 2, 2)
    Qt, Dt = Qt.numpy(), Dt.numpy()
    if at:
        assert np.abs(Qt.T @ D @ Qt - Dt).max() < 1e-10
        np.testing.assert_allclose(Qt.T @ Qt, np.eye(4), atol=1e-13)
    else:
        np.testing.assert_array_equal(Dt, D)
        np.testing.assert_array_equal(Qt, np.eye(4))
