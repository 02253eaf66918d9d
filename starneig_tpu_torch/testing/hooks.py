"""Structure checks of a real Schur form.

Port of the structure part of ``starneig_tpu/testing/hooks.py``, extended
to what :func:`starneig_tpu_torch.ops.eigvals.extract_eigenvalues` relies
on: every 2x2 diagonal block in standard form.
"""

from __future__ import annotations

import math

import torch


def schur_form_error(S) -> float:
    """Deviation of S from a standardized real quasi-triangular form.

    Checks that S is zero below the first subdiagonal, that no two
    consecutive subdiagonal entries are nonzero (2x2 blocks do not
    overlap), and that every 2x2 block (nonzero subdiagonal) has equal
    diagonal entries and a complex pair (S[i, i+1] S[i+1, i] < 0), as
    dlanv2 leaves it.  Returns the largest offending magnitude, ``inf``
    for a 2x2 block with real eigenvalues, and 0.0 for a valid form.
    """
    S = torch.as_tensor(S)
    if S.shape[0] < 2:
        return 0.0
    d, sub, sup = (torch.diagonal(S, k) for k in (0, -1, 1))
    blk = sub != 0
    if bool((blk & (sub * sup >= 0)).any()):
        return math.inf
    z = S.new_zeros(1)
    parts = (torch.tril(S, -2).abs().flatten(),
             torch.minimum(sub[:-1].abs(), sub[1:].abs()),
             (d[:-1] - d[1:]).abs()[blk], z)
    return float(torch.cat(parts).max())
