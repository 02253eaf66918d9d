"""Test-support layer: matrix generators and validation hooks, shared by
the tests, ``chip_smoke.py`` and the CLI (``starneig_tpu/testing`` in the
JAX package)."""

from starneig_tpu_torch.testing.generators import (
    known_spectrum_matrix,
    known_spectrum_pencil,
    random_dense,
    random_hessenberg,
)
from starneig_tpu_torch.testing.hooks import (
    UNIT_ROUNDOFF,
    eigenvalue_error,
    hessenberg_structure_error,
    orthogonality,
    residual_gep,
    residual_sep,
    schur_structure_error,
)
