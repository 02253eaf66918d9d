"""Numerical sanity checks between solve phases (debug mode).

Counterpart of ``starneig_tpu/tools/sanity.py`` (the reference's
``src/common/sanity.h``, STARNEIG_ENABLE_SANITY_CHECKS): NaN/Inf scans,
orthogonality, Hessenberg and Schur structure, residual brackets.  Each
check takes torch tensors on any device, or array-likes (numpy arrays):
the reduction runs where the tensor is and one number comes back to the
host.  Enable with ``enable_sanity_checks()`` or STARNEIG_TPU_SANITY=1;
a check raises ``SanityError`` on a violation and does nothing while
disabled.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_ENABLED = bool(int(os.environ.get("STARNEIG_TPU_SANITY", "0")))


class SanityError(AssertionError):
    pass


def sanity_enabled() -> bool:
    return _ENABLED


def enable_sanity_checks(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def _t(M, like=None) -> torch.Tensor:
    """M as a tensor: a tensor as it is, an array-like on the CPU (or on
    the device of ``like``)."""
    if isinstance(M, torch.Tensor):
        return M
    M = torch.as_tensor(np.asarray(M))
    return M if like is None else M.to(like.device)


def _u(dtype) -> float:
    return float(torch.finfo(dtype).eps) / 2


def check_finite(M, label: str = "matrix") -> None:
    """NaN/Inf scan (reference: sanity.h:120-145)."""
    if not _ENABLED:
        return
    if not bool(torch.isfinite(_t(M)).all()):
        raise SanityError(f"{label}: non-finite entries detected")


def check_hessenberg(H, label: str = "H") -> None:
    """Upper-Hessenberg structure check (reference: sanity.h:681-735)."""
    if not _ENABLED:
        return
    H = _t(H)
    if H.shape[0] > 2 and float(torch.tril(H, -2).abs().max()) != 0.0:
        raise SanityError(f"{label}: nonzero below the first subdiagonal")


def check_schur_form(S, label: str = "S") -> None:
    """Quasi-triangular structure check (reference: sanity.h:541-677)."""
    if not _ENABLED:
        return
    S = _t(S)
    n = S.shape[0]
    if n > 2 and float(torch.tril(S, -2).abs().max()) != 0.0:
        raise SanityError(f"{label}: nonzero below the first subdiagonal")
    sub = torch.diagonal(S, -1).abs()
    if n > 2 and float(torch.minimum(sub[:-1], sub[1:]).max()) > 0:
        raise SanityError(f"{label}: overlapping 2x2 blocks")


def check_orthogonality(Q, label: str = "Q", limit_u: float = 1e6) -> None:
    """||QQ^T - I|| check (reference: sanity.h:195-245)."""
    if not _ENABLED:
        return
    Q = _t(Q)
    eye = torch.eye(Q.shape[0], dtype=Q.dtype, device=Q.device)
    r = float(torch.linalg.norm(Q @ Q.T - eye)) / _u(Q.dtype)
    if r > limit_u:
        raise SanityError(f"{label}: orthogonality {r:.1f}u exceeds {limit_u}u")


def check_residual_bracket(A, S, Q, label: str = "phase",
                           limit: float = 1e-8) -> None:
    """Residual bracketing around a phase (reference: sanity.h:330-456)."""
    if not _ENABLED:
        return
    first = next((M for M in (A, S, Q) if isinstance(M, torch.Tensor)), None)
    A, S, Q = (_t(M, first) for M in (A, S, Q))
    r = float(torch.linalg.norm(Q @ S @ Q.T - A)) \
        / max(float(torch.linalg.norm(A)), 1e-300)
    if r > limit:
        raise SanityError(f"{label}: residual {r:.2e} exceeds {limit:.2e}")
