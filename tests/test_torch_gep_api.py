"""The port's GEP entry points (``api.gep``) at n=96 against the JAX
package's (CPU).

Without a CUDA card a call that leaves the device to its default raises;
``device="cpu"`` runs the plain PyTorch versions, leaves its inputs
unmodified, and the chain hessenberg_triangular -> schur passes the
reference's gates (info, exact structure, residuals and orthogonality
below 500 u).  ``select`` gives JAX's bitmap on the same Schur pair.
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


@pytest.mark.parametrize("call", ["hessenberg_triangular", "schur", "eigenvalues"])
def test_default_device_needs_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    A, B = _pencil(8)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        getattr(tgep, call)(A, B)


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
