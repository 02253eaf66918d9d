"""The port's SEP chain against the JAX package's (CPU): ``sep.reduce``
with the predicate Re(lambda) > 0, then ``sep.eigenvectors`` of the
leading block, at n=200 on the same seeded A (``tests/test_full_chain.py``
is the JAX package's own test of this chain).

Both chains are backward stable, but their Schur forms differ by roundoff
(the Francis window solves diverge elementwise, see
``tests/test_torch_schur.py``), so they are held to what the chain
guarantees: the same info and the same number of selected rows, the
leading eigenvalues equal as multisets within 1e-10 ||A||_F, every leading
eigenvalue satisfying the predicate, exact quasi-triangular structure,
residual and orthogonality below the reference's 500 u warn gate, and
eigenvector residuals ||A x - lambda x|| / (||A|| ||x||) below 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import torch

from starneig_tpu.api import sep as jsep
from starneig_tpu.testing import random_dense
from starneig_tpu_torch.api import sep as tsep
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
from starneig_tpu_torch.testing.hooks import (
    eigenvalue_error,
    orthogonality,
    residual_sep,
    schur_form_error,
    schur_structure_error,
)

torch.set_num_threads(1)

GATE = 500.0


def _lead_eigs(S, m):
    er, ei = extract_eigenvalues(from_numpy(S[:m, :m]))
    return np.sort_complex(to_numpy(er) + 1j * to_numpy(ei))


def test_sep_reduce_then_eigenvectors():
    n = 200
    A = random_dense(n, seed=42)
    pred = lambda lam: lam.real > 0          # noqa: E731
    Sj, Qj, erj, eij, nj, infoj = jsep.reduce(jnp.asarray(A), predicate=pred)
    St, Qt, ert, eit, nt, infot = tsep.reduce(from_numpy(A), predicate=pred,
                                               device="cpu")
    assert int(infot) == int(infoj) == Error.SUCCESS
    assert nt == nj == int((np.linalg.eigvals(A).real > 0).sum())
    Sj, St, Qt = np.asarray(Sj), to_numpy(St), to_numpy(Qt)

    na = np.linalg.norm(A)
    lead_t, lead_j = _lead_eigs(St, nt), _lead_eigs(Sj, nj)
    assert np.abs(lead_t - lead_j).max() <= 1e-10 * na
    assert np.all(lead_t.real > 0)
    assert schur_structure_error(St) == 0.0 and schur_form_error(from_numpy(St)) == 0.0
    assert residual_sep(A, St, Qt) < GATE and orthogonality(Qt) < GATE
    ev = to_numpy(ert) + 1j * to_numpy(eit)
    assert eigenvalue_error(ev, np.linalg.eigvals(A)) < 10000

    sel = np.arange(n) < nt
    X, xinfo = tsep.eigenvectors(from_numpy(St), from_numpy(Qt), sel,
                                   device="cpu")
    assert xinfo == Error.SUCCESS
    X = to_numpy(X)
    assert X.shape == (n, nt)       # a column per real value, two per pair
    er, ei = extract_eigenvalues(from_numpy(St[:nt, :nt]))
    er, ei = to_numpy(er), to_numpy(ei)
    worst, c = 0.0, 0
    while c < nt:
        if ei[c] != 0:
            lam, x = er[c] + 1j * abs(ei[c]), X[:, c] + 1j * X[:, c + 1]
            c += 2
        else:
            lam, x = er[c], X[:, c].astype(complex)
            c += 1
        worst = max(worst, np.linalg.norm(A @ x - lam * x) / (na * np.linalg.norm(x)))
    assert worst < 1e-12, worst
