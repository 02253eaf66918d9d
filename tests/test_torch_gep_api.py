"""The port's GEP entry points (``api.gep``) at n=96 against the JAX
package's (CPU).

Without a CUDA card a call that leaves the device to its default raises;
``device="cpu"`` runs the plain PyTorch versions, leaves its inputs
unmodified, and the chain hessenberg_triangular -> schur passes the
reference's gates (info, exact structure, residuals and orthogonality
below 500 u).  ``select`` gives JAX's bitmap on the same Schur pair.
``reduce`` (with ``select`` and ``reorder_schur`` inside) and
``eigenvectors`` of its leading block agree with the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.api import gep as jgep
from starneig_tpu_torch.api import gep as tgep
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import known_spectrum_pencil

torch.set_num_threads(1)

GATE = 500.0


def _pencil(n=96):
    A, B, _al, _be = known_spectrum_pencil(n, complex_ratio=0.3, seed=96)
    return A, B


def _right_half(alpha, beta):
    return beta != 0 and (alpha / beta).real > 0


@pytest.mark.parametrize("call", ["hessenberg_triangular", "schur", "eigenvalues",
                                  "reorder_schur", "eigenvectors", "reduce"])
def test_default_device_needs_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    A, B = _pencil(8)
    eye, sel = np.eye(8), np.ones(8, bool)
    args = {"reorder_schur": (A, B, eye, eye, sel),
            "eigenvectors": (A, B, eye, eye, sel)}.get(call, (A, B))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        getattr(tgep, call)(*args)


def test_chain_on_cpu():
    A, B = _pencil()
    At, Bt = torch.as_tensor(A.copy()), torch.as_tensor(B.copy())
    H, T, Q, Z = tgep.hessenberg_triangular(At, Bt, device="cpu")
    assert torch.equal(At, torch.as_tensor(A)) and torch.equal(Bt, torch.as_tensor(B))
    assert hooks.hessenberg_structure_error(H) == 0.0
    assert hooks.triangular_structure_error(T) == 0.0
    Hc, Tc, Qc, Zc = (x.clone() for x in (H, T, Q, Z))
    stats = {}
    S, Tt, Qo, Zo, ar, ai, bt, info = tgep.schur(H, T, Q, Z, stats=stats, device="cpu")
    for x, xc in zip((H, T, Q, Z), (Hc, Tc, Qc, Zc)):
        assert torch.equal(x, xc)
    assert info == Error.SUCCESS and stats["path"] == "aed"
    assert hooks.schur_structure_error(S) == 0.0
    assert hooks.triangular_structure_error(Tt) == 0.0
    ra, rb = hooks.residual_gep(A, B, S, Tt, Qo, Zo)
    assert max(ra, rb, hooks.orthogonality(Qo), hooks.orthogonality(Zo)) < GATE
    er, ei, eb = tgep.eigenvalues(S, Tt, device="cpu")
    for x, y in zip((er, ei, eb), (ar, ai, bt)):
        assert torch.equal(x, y)
    # the JAX chain's spectrum
    Sj, Tj, _Qj, _Zj, arj, aij, btj, _m, infoj = jgep.reduce(jnp.asarray(A), jnp.asarray(B))
    assert infoj == Error.SUCCESS
    ev_j = np.sort_complex((np.asarray(arj) + 1j * np.asarray(aij)) / np.asarray(btj))
    ev_t = np.sort_complex((to_numpy(ar) + 1j * to_numpy(ai)) / to_numpy(bt))
    assert np.abs(ev_j - ev_t).max() <= 1e-10 * np.abs(ev_j).max()
    # select: the same bitmap as JAX's on the same Schur pair
    sel_j = jgep.select(Sj, Tj, _right_half)
    sel_t = tgep.select(from_numpy(Sj), from_numpy(Tj), _right_half)
    np.testing.assert_array_equal(sel_t, sel_j)
    assert 0 < sel_t.sum() < len(sel_t)


def test_small_path_on_cpu():
    """Below the small limit schur is one window QZ solve."""
    A, B = _pencil(40)
    H, T, Q, Z = tgep.hessenberg_triangular(A, B, device="cpu")
    stats = {}
    S, Tt, Qo, Zo, _ar, _ai, _bt, info = tgep.schur(H, T, Q, Z, stats=stats, device="cpu")
    assert info == Error.SUCCESS and stats["path"] == "small"
    ra, rb = hooks.residual_gep(A, B, S, Tt, Qo, Zo)
    assert max(ra, rb) < GATE and hooks.schur_structure_error(S) == 0.0


@pytest.mark.parametrize("n", [40, 72])
def test_reduce_and_eigenvectors_on_cpu(n):
    """api.gep.reduce with the right-half predicate against
    starneig_tpu.api.gep.reduce (n=40: the small QZ path; n=72: the QZ
    iteration with AED): the same info and leading count, leading spectra
    within 1e-10 (chordal), the 500 u gates and exact structure; then the
    leading block's eigenvectors against JAX's on the JAX Schur pair
    (1e-10 max|X|) and by their residuals on the port's (1e-10)."""
    from starneig_tpu.ops.eigenvectors import eigenvectors_schur_gep
    A, B = _pencil(n)
    want = jgep.reduce(jnp.asarray(A), jnp.asarray(B), _right_half)
    got = tgep.reduce(A, B, _right_half, device="cpu")
    assert want[8] == got[8] == Error.SUCCESS and want[7] == got[7] > 0
    m = got[7]
    S, T, Q, Z = map(to_numpy, got[:4])
    assert hooks.schur_structure_error(S) == 0.0
    assert hooks.triangular_structure_error(T) == 0.0
    ra, rb = hooks.residual_gep(A, B, S, T, Q, Z)
    assert max(ra, rb, hooks.orthogonality(Q), hooks.orthogonality(Z)) < GATE
    lead = [np.asarray(x)[:m] for x in want[4:7]]
    chordal = hooks.chordal_eigenvalue_error(
        *(to_numpy(x)[:m] for x in got[4:7]), lead[0] + 1j * lead[1], lead[2])
    assert chordal * hooks.UNIT_ROUNDOFF[np.dtype(np.float64)] < 1e-10
    ar, bt = (to_numpy(x)[:m] for x in (got[4], got[6]))
    assert (bt != 0).all() and ((ar / bt) > 0).all()
    # eigenvectors of the leading block
    sel = np.arange(n) < m
    Xj, infoj = eigenvectors_schur_gep(*want[:4], sel)
    Xt, infot = tgep.eigenvectors(*(from_numpy(x) for x in want[:4]), sel, device="cpu")
    Xj = np.asarray(Xj)
    assert infot == infoj and np.abs(to_numpy(Xt) - Xj).max() <= 1e-10 * np.abs(Xj).max()
    X, xinfo = tgep.eigenvectors(*got[:4], sel, device="cpu")
    assert X.shape[1] == m and xinfo == Error.SUCCESS
    assert hooks.eigenvector_residual_gep(A, B, *got[:2], X, sel) < 1e-10
