"""Plain reference solvers for each step of a chain: LAPACK through numpy
and scipy on the host, in a precision the caller chooses, importing
nothing of the program.

In float64 they pass the judge; put in the program's place in float32
(``control.py``) they are the control that the judge has to fail.  The state keys are the program's
(``harness/program.py``).  The Hessenberg-triangular step hands the pencil
on unreduced (Q = Z = I): the reference QZ reduces a general pencil.  The
selection rule sees a beta that the judge takes for a rounding of 0 as 0
(``judge.INFINITE``): LAPACK's QZ can leave an infinite eigenvalue's beta
tiny.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from reference.judge import INFINITE, block_starts


def _np(t, dtype):
    return t.detach().cpu().numpy().astype(dtype)


def _eigs(S, T=None):
    """Each row's eigenvalue (alpha, beta) from the diagonal blocks of S (of
    (S, T)), in S's precision; a pair's first row takes the root with Im > 0."""
    n = S.shape[0]
    ct = np.complex64 if S.dtype == np.float32 else np.complex128
    d = np.diagonal(S).astype(ct)
    sub = np.concatenate([np.diagonal(S, -1), [0]]).astype(S.dtype)
    alpha = d.copy()
    beta = np.ones(n, S.dtype) if T is None else np.diagonal(T).copy()
    for i in np.nonzero(block_starts(sub))[0]:
        if T is None:
            w = np.linalg.eigvals(S[i:i + 2, i:i + 2])
            ab = np.stack([w, np.ones(2)])
        else:
            ab = scipy.linalg.eigvals(S[i:i + 2, i:i + 2], T[i:i + 2, i:i + 2],
                                      homogeneous_eigvals=True)
        k = np.argsort(-(ab[0] * np.conj(ab[1])).imag)
        alpha[i:i + 2] = ab[0][k]
        beta[i:i + 2] = ab[1][k].real
    return alpha.astype(ct), beta


def _vectors(S, T, Z, m):
    """Eigenvectors of the pencil's leading m block in LAPACK real storage:
    the generalized eigenvectors of the m x m block matched to its diagonal
    blocks, back-transformed by Z's leading columns."""
    Sm, Tm = S[:m, :m], T[:m, :m]
    ab, V = scipy.linalg.eig(Sm, Tm, homogeneous_eigvals=True)
    alpha, beta = _eigs(Sm, Tm)
    sub = np.concatenate([np.diagonal(Sm, -1), [0]])
    start = block_starts(sub)
    Y = np.zeros((m, m), S.dtype)
    used = np.zeros(V.shape[1], bool)
    i = 0
    while i < m:
        d = np.abs(ab[0] * beta[i] - alpha[i] * ab[1])
        d[used] = np.inf
        j = int(np.argmin(d))
        used[j] = True
        if start[i]:
            Y[:, i], Y[:, i + 1] = V[:, j].real, V[:, j].imag
            i += 2
        else:
            Y[:, i] = V[:, j].real
            i += 1
    return Z[:, :m] @ Y


def _rule(pred, S, T):
    """The selection rule on (alpha, beta), with a beta that is a rounding
    of 0 taken as 0 (infinite)."""
    scale = INFINITE * float(np.linalg.norm(T)) / float(np.linalg.norm(S))

    def rule(a, b):
        return pred(complex(a), 0.0 if abs(b) <= scale * abs(a) else float(b))
    return rule


def run_step(step: str, st: dict, pred, dtype) -> None:
    """One step of the reference on the host state ``st`` (numpy arrays in
    ``dtype``), in place."""
    A = st.get("A")
    if step == "sep.hessenberg":
        st["H"], st["Q"] = scipy.linalg.hessenberg(A, calc_q=True)
    elif step == "sep.schur":
        S, Zs = scipy.linalg.schur(st.pop("H"), output="real")
        st.update(S=S, Q=st["Q"] @ Zs, info=0)
        st["eig_real"], st["eig_imag"] = _split(_eigs(S))
    elif step == "sep.eigenvalues":
        st["eig_real"], st["eig_imag"] = _split(_eigs(st["S"]))
    elif step == "gep.hessenberg_triangular":
        n = A.shape[0]
        st.update(H=A.copy(), T=st["B"].copy(), Q=np.eye(n, dtype=dtype),
                  Z=np.eye(n, dtype=dtype))
    elif step == "gep.schur":
        S, T, Qs, Zs = scipy.linalg.qz(st.pop("H"), st["T"], output="real")
        st.update(S=S, T=T, Q=st["Q"] @ Qs, Z=st["Z"] @ Zs, info=0)
        st["eig_real"], st["eig_imag"], st["eig_beta"] = _split3(_eigs(S, T))
    elif step == "gep.eigenvalues":
        st["eig_real"], st["eig_imag"], st["eig_beta"] = _split3(_eigs(st["S"], st["T"]))
    elif step == "gep.select":
        a, b = _eigs(st["S"], st["T"])
        rule = _rule(pred, st["S"], st["T"])
        st["sel"] = np.array([rule(x, y) for x, y in zip(a, b)])
    elif step == "gep.reorder_schur":
        rule = _rule(pred, st["S"], st["T"])
        S, T, _a, _b, Qs, Zs = scipy.linalg.ordqz(
            st["S"], st["T"], output="real",
            sort=lambda al, be: np.array([rule(x, y.real) for x, y in zip(al, be)], bool))
        st.update(S=S, T=T, Q=st["Q"] @ Qs, Z=st["Z"] @ Zs, m=int(np.sum(st["sel"])),
                  reorder_info=0)
        _drop_eigs(st)
    elif step == "gep.eigenvectors":
        st["X"] = _vectors(st["S"], st["T"], st["Z"], st["m"])
    else:
        raise KeyError(f"no reference for step {step!r}")


def host_state(inputs: dict, dtype) -> dict:
    return {k: _np(v, dtype) for k, v in inputs.items()}


def to_device(st: dict, device) -> dict:
    """The host state as the judge reads it: float64 tensors on ``device``."""
    return {k: (torch.as_tensor(v.astype(np.float64), device=device)
                if isinstance(v, np.ndarray) and v.dtype != bool else v)
            for k, v in st.items()}


def _split(ab):
    a, b = ab
    lam = a / b
    return lam.real, lam.imag


def _split3(ab):
    a, b = ab
    return a.real, a.imag, b


def _drop_eigs(st):
    for k in ("eig_real", "eig_imag", "eig_beta"):
        st.pop(k, None)
