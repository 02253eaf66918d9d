"""Full GEP solve chain: pencil (A, B) -> generalized Schur form + reordering.

Counterpart of ``examples/gep_full_chain.py`` (the reference's
``examples/gep_sm_full_chain.c``).

Run:  python -m starneig_tpu_torch.examples.gep_full_chain [n] [--device cpu]
"""

import numpy as np

from starneig_tpu_torch.api import gep
from starneig_tpu_torch.convert import to_numpy
from starneig_tpu_torch.examples._args import parse
from starneig_tpu_torch.testing import orthogonality, residual_gep


def main(n: int = 200, device=None) -> None:
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n)) + 3 * np.eye(n)

    S, T, Q, Z, ar, ai, bt, nsel, info = gep.reduce(
        A, B, predicate=lambda alpha, beta: beta != 0 and (alpha / beta).real > 0,
        device=device)
    print(f"info = {info}, selected = {nsel}")

    S, T, Q, Z = map(to_numpy, (S, T, Q, Z))
    ra, rb = residual_gep(A, B, S, T, Q, Z)
    print(f"residual A    = {ra:8.1f} u")
    print(f"residual B    = {rb:8.1f} u")
    print(f"orthogonality = {max(orthogonality(Q), orthogonality(Z)):8.1f} u")

    bt = to_numpy(bt)
    n_inf = int((np.abs(bt) < 1e-12).sum())
    print(f"infinite eigenvalues: {n_inf}")

    select = np.zeros(n, bool)
    select[:max(nsel, 1)] = True
    X, xinfo = gep.eigenvectors(S, T, Q, Z, select, device=device)
    print(f"generalized eigenvectors: {tuple(X.shape)}")


if __name__ == "__main__":
    main(*parse(__doc__, 200))
