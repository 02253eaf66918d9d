"""The port's Hessenberg-triangular reduction and the GEP recondense against
the JAX package's XLA path, on the same seeded inputs (CPU).

Both run the same Givens rotations in the same order, so they agree
elementwise to 1e-12 max|M| (summation order and fused multiply-adds
only), with the structures exact.  One input is held to the contract
instead: the recondense of a random window at a large kbot, where the
re-reduction is ill-conditioned (a one-ulp change of the input moves the
JAX result itself by O(1) from kbot ~ 25 on).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops import hess_triangular as jht
from starneig_tpu.ops import qz_driver as jqd
from starneig_tpu.ops.eigvals import extract_eigenvalues_gen as jextract_gen
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.ops import hess_triangular as tht
from starneig_tpu_torch.ops import qz_driver as tqd
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues_gen
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import known_spectrum_pencil, planted_schur_pair

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max(initial=0.0)) / max(float(np.abs(a).max(initial=0.0)), 1e-300)


@pytest.mark.parametrize("n", [2, 3, 8, 24, 64])
def test_hessenberg_triangular(n):
    rng = np.random.default_rng(100 + n)
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n))
    want = jht.hessenberg_triangular(jnp.asarray(A), jnp.asarray(B))
    got = tht.hessenberg_triangular(from_numpy(A), from_numpy(B))
    for w, g in zip(want, got):
        assert _rel(w, to_numpy(g)) <= 1e-12
    H, T, Q, Z = got
    assert hooks.hessenberg_structure_error(H) == 0.0
    assert hooks.triangular_structure_error(T) == 0.0
    ra, rb = hooks.residual_gep(A, B, H, T, Q, Z)
    assert ra < 500 and rb < 500


def test_hessenberg_triangular_accumulates():
    """Given Q and Z accumulate on the right, as in the JAX version."""
    n = 12
    rng = np.random.default_rng(5)
    A, B = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    Q0 = np.linalg.qr(rng.standard_normal((n, n)))[0]
    Z0 = np.linalg.qr(rng.standard_normal((n, n)))[0]
    want = jht.hessenberg_triangular(*(jnp.asarray(x) for x in (A, B, Q0, Z0)))
    got = tht.hessenberg_triangular(*(from_numpy(x) for x in (A, B, Q0, Z0)))
    for w, g in zip(want, got):
        assert _rel(w, to_numpy(g)) <= 1e-12


def _recondense_contract(S, T, Q, Z, s, kbot, out):
    """(similarity of S and T, max structure error, max non-leading spike
    entry, |beta| - s ||Q[0, :kbot]||) of a recondense result."""
    S2, T2, Q2, Z2, beta = (np.asarray(x) for x in out)
    Ul, Vr = Q.T @ Q2, Z.T @ Z2
    sim = max(np.linalg.norm(Ul.T @ S @ Vr - S2) / np.linalg.norm(S),
              np.linalg.norm(Ul.T @ T @ Vr - T2) / np.linalg.norm(T))
    struct = max(np.abs(np.tril(S2[:kbot, :kbot], -2)).max(initial=0.0),
                 np.abs(np.tril(T2[:kbot, :kbot], -1)).max(initial=0.0))
    spike = np.abs(s * Q2[0, 1:kbot]).max(initial=0.0)
    return sim, struct, spike, abs(abs(float(beta)) - abs(s) * np.linalg.norm(Q[0, :kbot]))


@pytest.mark.parametrize("kbot", [0, 1, 10, 38])
def test_aed_recondense_gep(kbot):
    WA, s = 40, 0.7
    S, T, Q, Z = planted_schur_pair(WA, WA, 40)
    want = [np.asarray(x) for x in jqd._aed_recondense_gep(
        *(jnp.asarray(x) for x in (S, T, Q, Z)), s, kbot)]
    got = [to_numpy(x) for x in tqd._aed_recondense_gep(
        *(from_numpy(x) for x in (S, T, Q, Z)), s, kbot)]
    if kbot <= 10:
        for w, g in zip(want, got):
            assert _rel(w, g) <= 1e-12
    for out in (want, got):
        sim, struct, spike, beta = _recondense_contract(S, T, Q, Z, s, kbot, out)
        assert sim < 1e-14 and struct == 0.0 and spike < 1e-15 and beta < 1e-14


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_eigenvalues_gen(seed):
    """Eigenvalues of a Schur pair with 2x2 blocks and zero betas."""
    S, T, _Q, _Z = planted_schur_pair(20, 20, seed)
    T[5, 5] = 0.0
    T[11, 11] = 0.0
    want = jextract_gen(jnp.asarray(S), jnp.asarray(T))
    got = extract_eigenvalues_gen(from_numpy(S), from_numpy(T))
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=1e-14, atol=1e-14)


def _one_ulp_move(inp):
    """Max relative move of the plain cascade's result when A moves by one
    ulp."""
    out0 = tht._ht_reduce(*(from_numpy(x) for x in inp))
    out1 = tht._ht_reduce(from_numpy(np.nextafter(inp[0], np.inf)),
                          *(from_numpy(x) for x in inp[1:]))
    return max(_rel(to_numpy(a), to_numpy(b)) for a, b in zip(out0, out1))


@pytest.mark.parametrize("pencil", ["regular", "singular_b"])
def test_ht_one_ulp(pencil):
    """How far one ulp of input moves the cascade at n=192: a regular pencil
    (A Gaussian, B the upper triangle of a Gaussian) by less than 1e-12,
    so the kernel is held to its plain twin elementwise there (the card
    test; chip_smoke.py at n=2000); the GEP path's pencil
    (known_spectrum_pencil with 10% infinite eigenvalues, B singular,
    after the QR of B) by more than 1e-10, because its right rotations
    are taken from entries of B at rounding level: no elementwise
    comparison holds there, so the path is held to its residual and
    structure gates."""
    n = 192
    if pencil == "regular":
        rng = np.random.default_rng(n)
        A = rng.standard_normal((n, n))
        B = np.triu(rng.standard_normal((n, n)))
        inp = (A, B, np.eye(n), np.eye(n))
    else:
        A, B, _alpha, _beta = known_spectrum_pencil(n, complex_ratio=0.3, inf_ratio=0.1, seed=0)
        inp = tuple(to_numpy(x) for x in tht.triangularize_b(from_numpy(A), from_numpy(B)))
    move = _one_ulp_move(inp)
    if pencil == "regular":
        assert move < 1e-12
    else:
        assert move > 1e-10
