"""Validation hooks: residual, orthogonality, structure and eigenvalue
checks, in units of the unit roundoff u.

Port of the SEP and GEP checks of ``starneig_tpu/testing/hooks.py`` (reference
``test/common/hooks.c:405`` residual, ``:759`` Schur structure, ``:1036``
eigenvalues; norms ``test/common/checks.c:180,196``; the thresholds of
the reference's test program, as ``starneig_tpu/testing/hooks.py`` cites
them: residual warn 500 / fail 10000, eigenvalues warn 1000 / fail
10000).  The checks compute in numpy; tensors on any
device are accepted and copied to the host.  :func:`schur_form_error` is
the port's own, stricter structure check on a tensor.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager

import numpy as np
import torch

# the reference scales by 2^52, i.e. u = eps = 2^-52 for f64
# (checks.c:190,204: ((long long)1<<52) * norm ratio)
UNIT_ROUNDOFF = {
    np.dtype(np.float64): np.finfo(np.float64).eps,
    np.dtype(np.float32): np.finfo(np.float32).eps,
}

RESIDUAL_WARN = 500.0
RESIDUAL_FAIL = 10000.0
EIGENVALUE_WARN = 1000.0
EIGENVALUE_FAIL = 10000.0


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _u(dtype) -> float:
    return UNIT_ROUNDOFF[np.dtype(dtype)]


def residual_sep(A, S, Q) -> float:
    """||Q S Q^T - A||_F / ||A||_F in units of u (hooks.c:405)."""
    A, S, Q = map(_np, (A, S, Q))
    r = np.linalg.norm(Q @ S @ Q.T - A) / max(np.linalg.norm(A), 1e-300)
    return float(r / _u(A.dtype))


def residual_gep(A, B, S, T, Q, Z):
    """(||Q S Z^T - A|| / ||A||, ||Q T Z^T - B|| / ||B||) in units of u."""
    A, B, S, T, Q, Z = map(_np, (A, B, S, T, Q, Z))
    ra = np.linalg.norm(Q @ S @ Z.T - A) / max(np.linalg.norm(A), 1e-300)
    rb = np.linalg.norm(Q @ T @ Z.T - B) / max(np.linalg.norm(B), 1e-300)
    return float(ra / _u(A.dtype)), float(rb / _u(B.dtype))


def orthogonality(Q) -> float:
    """||Q Q^T - I||_F / sqrt(n) in units of u (checks.c:196-204)."""
    Q = _np(Q)
    n = Q.shape[0]
    r = np.linalg.norm(Q @ Q.T - np.eye(n, dtype=Q.dtype)) / np.sqrt(n)
    return float(r / _u(Q.dtype))


def schur_structure_error(S) -> float:
    """Deviation from real quasi-triangular structure.

    Checks: zero below the first subdiagonal; no two consecutive nonzero
    subdiagonal entries (2x2 blocks cannot overlap).  Returns the largest
    offending magnitude (0.0 when the structure is valid).
    """
    S = _np(S)
    n = S.shape[0]
    err = np.max(np.abs(np.tril(S, -2))) if n > 2 else 0.0
    sub = np.abs(np.diagonal(S, -1))
    overlap = np.minimum(sub[:-1], sub[1:]) if n > 2 else np.zeros(0)
    if overlap.size:
        err = max(err, float(np.max(overlap)))
    return float(err)


def hessenberg_structure_error(H) -> float:
    """Largest |entry| below the first subdiagonal (must be exactly 0)."""
    H = _np(H)
    return float(np.max(np.abs(np.tril(H, -2))) if H.shape[0] > 2 else 0.0)


def triangular_structure_error(T) -> float:
    """Largest |entry| below the diagonal (upper triangular check)."""
    T = _np(T)
    return float(np.max(np.abs(np.tril(T, -1))))


def eigenvalue_error(computed, known, scale=None) -> float:
    """Max matched-eigenvalue distance in units of u (hooks.c:1036).

    Greedy bipartite match of the computed spectrum against the known one,
    error normalized by max |eigenvalue| (or ``scale``).
    """
    computed = np.asarray(computed, complex)
    known = np.asarray(known, complex).copy()
    if scale is None:
        scale = max(np.max(np.abs(known)), 1e-300)
    used = np.zeros(len(known), bool)
    worst = 0.0
    for lam in computed:
        d = np.abs(known - lam)
        d[used] = np.inf
        j = int(np.argmin(d))
        used[j] = True
        worst = max(worst, float(d[j]))
    return worst / scale / _u(np.float64)


def reordering_check(eig_real, eig_imag, select_in, num_selected_out) -> bool:
    """Selected eigenvalues landed in the leading block (reorder hook)."""
    # the caller passes the post-reorder spectrum and the original selection
    # count; detailed value matching is done via eigenvalue_error on the
    # leading block.
    return bool(num_selected_out >= 0)


def chordal_eigenvalue_error(ar, ai, bt, alpha_known, beta_known) -> float:
    """Max matched chordal distance between computed and known generalized
    spectra, in units of u (the GEP known-eigenvalues hook,
    test/common/hooks.c:1344; the chordal metric handles infinities:
    d((a1,b1),(a2,b2)) = |a1 b2 - a2 b1| / (||(a1,b1)|| ||(a2,b2)||))."""
    a1 = _np(ar).astype(float) + 1j * _np(ai).astype(float)
    b1 = _np(bt).astype(float)
    a2 = np.asarray(alpha_known, complex)
    b2 = np.asarray(beta_known, float)
    n1 = np.sqrt(np.abs(a1) ** 2 + b1 ** 2)
    n2 = np.sqrt(np.abs(a2) ** 2 + b2 ** 2)
    # greedy: each known value takes its closest unused computed value
    used = np.zeros(len(a1), bool)
    worst = 0.0
    for j in range(len(a2)):
        d = np.abs(a1 * b2[j] - a2[j] * b1) / np.maximum(n1, 1e-300) / \
            max(n2[j], 1e-300)
        d[used] = np.inf
        i = int(np.argmin(d))
        used[i] = True
        worst = max(worst, float(d[i]))
    return worst / _u(np.float64)


def spectrum_analysis(er, ei, bt=None, tol=1e-12):
    """Count zero / infinite / indefinite eigenvalues (the analysis hook,
    test/common/hooks.c:1511).  For SEP pass bt=None (no infinities)."""
    er = _np(er).astype(float)
    ei = _np(ei).astype(float)
    mag = np.abs(er + 1j * ei)
    if bt is None:
        zeros = int((mag <= tol * max(mag.max(), 1e-300)).sum())
        return {"zero": zeros, "infinite": 0,
                "indefinite": 0, "total": len(er)}
    bt = _np(bt).astype(float)
    bscale = max(np.abs(bt).max(), 1e-300)
    inf_mask = np.abs(bt) <= tol * bscale
    ascale = max(mag.max(), 1e-300)
    zero_mask = (mag <= tol * ascale) & ~inf_mask
    indef = int((inf_mask & (mag <= tol * ascale)).sum())
    return {"zero": int(zero_mask.sum()), "infinite": int(inf_mask.sum()),
            "indefinite": indef, "total": len(er)}


def eigenvector_residual_gep(A, B, S, T, X, select) -> float:
    """Worst ||beta A x - alpha B x|| / ((|beta| ||A||_F + |alpha| ||B||_F)
    ||x||) over the columns of X, the eigenvectors of the selected blocks of
    the generalized Schur form (S, T) of (A, B) in LAPACK-style real storage
    (a (Re, Im) column pair per complex pair, for the eigenvalue with
    positive imaginary part).  (alpha, beta) come from the diagonal blocks
    in homogeneous form, so an infinite eigenvalue (beta = 0) is held to
    ||B x|| / (||B||_F ||x||)."""
    import scipy.linalg
    A, B, S, T, X = map(_np, (A, B, S, T, X))
    select = _np(select).astype(bool)
    n = S.shape[0]
    na, nb = np.linalg.norm(A), np.linalg.norm(B)
    AX, BX = A @ X, B @ X
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    worst = 0.0
    c = i = 0
    while i < n:
        pair = sub[i] != 0
        if select[i] or (pair and select[i + 1]):
            if pair:
                ab = scipy.linalg.eigvals(S[i:i + 2, i:i + 2], T[i:i + 2, i:i + 2],
                                          homogeneous_eigvals=True)
                k = int(np.argmax((ab[0] * np.conj(ab[1])).imag))
                alpha, beta = ab[0][k], ab[1][k]
                x = X[:, c] + 1j * X[:, c + 1]
                ax, bx = AX[:, c] + 1j * AX[:, c + 1], BX[:, c] + 1j * BX[:, c + 1]
                c += 2
            else:
                alpha, beta = S[i, i], T[i, i]
                x, ax, bx = X[:, c], AX[:, c], BX[:, c]
                c += 1
            r = np.linalg.norm(beta * ax - alpha * bx) / max(
                (abs(beta) * na + abs(alpha) * nb) * np.linalg.norm(x), 1e-300)
            worst = max(worst, float(r))
        i += 2 if pair else 1
    return worst


def selection_bitmap(eig_real, eig_imag, sub, ratio, distr="uniform",
                     seed=0):
    """Build a selection bitmap over Schur blocks (reference
    test/common/select_distr.c:105-268): ``uniform`` selects each block
    independently with probability ``ratio``; ``cluster`` selects one
    contiguous run of blocks holding ~ratio of the spectrum."""
    n = len(eig_real)
    rng = np.random.default_rng(seed)
    sub = _np(sub)
    sel = np.zeros(n, bool)
    # block starts
    starts = []
    i = 0
    while i < n:
        starts.append(i)
        i += 2 if (i + 1 < n and sub[i] != 0) else 1
    if distr == "cluster":
        k = max(1, int(round(len(starts) * ratio)))
        c0 = int(rng.integers(0, max(1, len(starts) - k + 1)))
        chosen = range(c0, c0 + k)
    else:
        chosen = [j for j in range(len(starts)) if rng.random() < ratio]
    for j in chosen:
        p = starts[j]
        sel[p] = True
        if p + 1 < n and sub[p] != 0:
            sel[p + 1] = True
    return sel


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


def _tensor(x, device=None):
    t = torch.as_tensor(x)
    return t if device is None else t.to(device)


def _orthogonality_t(V) -> float:
    """:func:`orthogonality` of a tensor, computed on its device."""
    n = V.shape[0]
    eye = torch.eye(n, dtype=V.dtype, device=V.device)
    return float(torch.linalg.norm(V @ V.T - eye)) / math.sqrt(n) / _u(np.float64)


def eigenvector_residual_sep(A, S, X, m) -> float:
    """Worst ||A x - lambda x|| / (||A||_F ||x||) over the eigenvectors X
    (n, m) of the leading m x m block of the real Schur form S of A, in
    LAPACK-style real storage: a column per real eigenvalue, a (Re, Im)
    column pair per complex pair, for the eigenvalue with positive
    imaginary part.  Computed in torch on S's device (numpy arrays become
    CPU tensors)."""
    from starneig_tpu_torch.ops.eigvals import extract_eigenvalues
    S = _tensor(S)
    A, X = _tensor(A, S.device), _tensor(X, S.device)
    er, ei = extract_eigenvalues(S[:m, :m])
    first = ei > 0                       # the pair's (Re, Im) columns start here
    keep = first | (ei == 0)
    c = torch.arange(m, device=S.device)
    partner = torch.where(first, c + 1, c).clamp_max(m - 1)
    AX = A @ X
    Xi = torch.where(first, X[:, partner], 0.0)
    AXi = torch.where(first, AX[:, partner], 0.0)
    Rr = AX - (er * X - ei * Xi)
    Ri = AXi - (er * Xi + ei * X)
    rn = torch.sqrt((Rr * Rr + Ri * Ri).sum(0))
    xn = torch.sqrt((X * X + Xi * Xi).sum(0))
    return float((rn / (torch.linalg.norm(A) * xn))[keep].max())


def selected_leading(S, m, predicate, T=None):
    """(lead_ok, rest) after a reordering: whether every eigenvalue of the
    leading m x m block of S (of the pencil (S, T) if T is given)
    satisfies ``predicate``, and how many rows below m hold an eigenvalue
    that does.  The predicate takes what ``api.sep.select`` (a complex
    lambda) or ``api.gep.select`` (alpha, beta) passes it; a 2x2 block is
    judged as a whole, as the selection does."""
    from starneig_tpu_torch.api import gep, sep
    S = _tensor(S)
    sel = sep.select(S, predicate) if T is None else \
        gep.select(S, _tensor(T, S.device), predicate)
    return bool(sel[:m].all()), int(sel[m:].sum())


def sep_gates(A, S, Q):
    """(residual ||Q S Q^T - A||_F / ||A||_F, orthogonality ||Q Q^T -
    I||_F / sqrt(n), both in units of u; :func:`schur_form_error` of S),
    computed in torch on S's device: the SEP gates of a card run, where
    the n^3 products are the card's."""
    S = _tensor(S)
    A, Q = _tensor(A, S.device), _tensor(Q, S.device)
    res = float(torch.linalg.norm(Q @ S @ Q.T - A) / torch.linalg.norm(A)) / _u(np.float64)
    return res, _orthogonality_t(Q), schur_form_error(S)


def gep_gates(A, B, S, T, Q, Z):
    """(residual of A, residual of B, orthogonality of Q, of Z, in units
    of u; :func:`schur_structure_error` of S, :func:`triangular_structure_error`
    of T), the residuals and orthogonalities computed in torch on S's
    device (:func:`residual_gep`'s and :func:`orthogonality`'s formulas)."""
    S = _tensor(S)
    A, B, T, Q, Z = (_tensor(x, S.device) for x in (A, B, T, Q, Z))

    def rel(M, R):
        return float(torch.linalg.norm(Q @ M @ Z.T - R) / torch.linalg.norm(R)) / \
            _u(np.float64)
    return (rel(S, A), rel(T, B), _orthogonality_t(Q), _orthogonality_t(Z),
            schur_structure_error(S), triangular_structure_error(T))


def timed(fn):
    """(fn(), its wall time in ms), the card's queue drained before the
    start and after the end (``torch.cuda.synchronize``) where a card is
    in use: a phase's time as a caller sees it."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


@contextmanager
def train_bottoms():
    """Within: each QZ train the driver starts, through the hop loop
    (``ops/qz_driver.py:_qz_sweep``, any extent) or G3's train mode
    (``_qz_train``), appends (l, ihi, S[ihi, ihi-1]) to the yielded list,
    the padded segment and the entry below its bottom as the train finds
    it (the precondition of G3's row ranges: zero).  A sharded extent
    reads the entry with its collective ``get_block``, on every rank."""
    from starneig_tpu_torch.ops import qz_driver
    from starneig_tpu_torch.ops.schur import DenseExtent
    record = []
    sweep, train = qz_driver._qz_sweep, qz_driver._qz_train

    def bottom(Spad, ihi, ext):
        return float(ext.get_block(Spad, ihi, ihi - 1, 1, 1)[0, 0])

    def sweep_rec(Spad, Tpad, Qpad, Zpad, l, ihi, sh, B, **kw):
        record.append((l, ihi, bottom(Spad, ihi, kw.get("ext", DenseExtent))))
        return sweep(Spad, Tpad, Qpad, Zpad, l, ihi, sh, B, **kw)

    def train_rec(Spad, Tpad, Qpad, Zpad, l, ihi, sh, B):
        record.append((l, ihi, bottom(Spad, ihi, DenseExtent)))
        return train(Spad, Tpad, Qpad, Zpad, l, ihi, sh, B)
    qz_driver._qz_sweep, qz_driver._qz_train = sweep_rec, train_rec
    try:
        yield record
    finally:
        qz_driver._qz_sweep, qz_driver._qz_train = sweep, train
