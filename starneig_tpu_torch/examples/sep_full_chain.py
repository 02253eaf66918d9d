"""Full SEP solve chain: dense A -> eigenvalues, Schur form, deflating subspace.

Counterpart of ``examples/sep_full_chain.py`` (the reference's
``examples/sep_sm_full_chain.c``): reduce a random dense matrix to real
Schur form, reorder the eigenvalues with positive real part to the top,
validate, and compute their eigenvectors.

Run:  python -m starneig_tpu_torch.examples.sep_full_chain [n] [--device cpu]
"""

import numpy as np

from starneig_tpu_torch.api import sep
from starneig_tpu_torch.convert import to_numpy
from starneig_tpu_torch.examples._args import parse
from starneig_tpu_torch.testing import orthogonality, residual_sep


def main(n: int = 500, device=None) -> None:
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n))

    # full chain: Hessenberg -> Schur -> Select -> Reorder
    S, Q, er, ei, nsel, info = sep.reduce(A, predicate=lambda lam: lam.real > 0,
                                          device=device)
    print(f"info = {info}, selected (positive real part) = {nsel}")

    S, Q = to_numpy(S), to_numpy(Q)
    print(f"residual      = {residual_sep(A, S, Q):8.1f} u")
    print(f"orthogonality = {orthogonality(Q):8.1f} u")

    # eigenvectors for the deflating subspace
    select = np.zeros(n, bool)
    select[:nsel] = True
    X, xinfo = sep.eigenvectors(S, Q, select, device=device)
    print(f"eigenvectors: {tuple(X.shape)}")


if __name__ == "__main__":
    main(*parse(__doc__, 500))
