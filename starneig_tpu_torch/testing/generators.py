"""Seeded inputs (numpy only): windows for checking the reordering kernels
against their plain twins, and copies of
``starneig_tpu/testing/generators.py`` (``random_dense``,
``random_orthogonal``, ``random_hessenberg``, ``known_spectrum_matrix``
with ``_to_hessenberg``, ``known_spectrum_pencil``) so that a card without
JAX builds the same matrices and pencils from the same seeds."""

from __future__ import annotations

import numpy as np


def planted_windows(G: int, W: int, seed: int):
    """G (W, W) quasi-triangular windows and their block-aligned selections.

    Every fifth row from row 1 starts a standardized 2x2 block (a complex
    pair), and each block is selected with probability 1/2.  Window 0 also
    holds two equal adjacent 2x2 blocks at rows 6 and 8 with the lower one
    selected: the Sylvester equation of their swap is singular, so that
    swap is rejected.  Returns (Ts (G, W, W), sels (G, W) bool).
    """
    rng = np.random.default_rng(seed)
    Ts, sels = [], []
    for g in range(G):
        T = np.triu(rng.standard_normal((W, W)))
        for p in range(1, W - 2, 5):
            T[p + 1, p] = -abs(rng.standard_normal())
            T[p, p + 1] = abs(rng.standard_normal())
            T[p + 1, p + 1] = T[p, p]
        sel = np.zeros(W, bool)
        i = 0
        while i < W:
            sz = 2 if i + 1 < W and T[i + 1, i] != 0 else 1
            sel[i:i + sz] = rng.random() < 0.5
            i += sz
        if g == 0 and W >= 10:
            for p in (6, 8):
                T[p:p + 2, p:p + 2] = [[1.0, 2.0], [-0.5, 1.0]]
            T[6:8, 8:10] = [[3.0, -1.0], [2.0, 5.0]]
            sel[6:8], sel[8:10] = False, True
        Ts.append(T)
        sels.append(sel)
    return np.stack(Ts), np.stack(sels)


def planted_pencil_windows(G: int, W: int, seed: int):
    """G (W, W) windows of a generalized Schur form and their block-aligned
    selections: S upper triangular with a standardized 2x2 block (a complex
    pair, T's block a multiple of I) starting at every fifth row from row
    1, T upper triangular with diagonal >= 1 except an exact zero (an
    infinite eigenvalue) at every seventh row from row 3 that no block
    holds.  Each block is selected with probability 1/2.  Window 0 also
    holds two equal adjacent 2x2 pencil blocks at rows 6 and 8 with the
    lower one selected: the generalized Sylvester equation of their swap is
    singular, so that swap is rejected.  Returns (Ss, Ts (G, W, W),
    sels (G, W) bool)."""
    rng = np.random.default_rng(seed)
    Ss, Ts, sels = [], [], []
    for g in range(G):
        S = np.triu(rng.standard_normal((W, W)))
        T = np.triu(rng.standard_normal((W, W)))
        T[np.diag_indices(W)] = 1.0 + np.abs(rng.standard_normal(W))
        pairs = range(1, W - 2, 5)
        for p in pairs:
            S[p + 1, p] = -abs(rng.standard_normal()) - 0.1
            S[p, p + 1] = abs(rng.standard_normal()) + 0.1
            S[p + 1, p + 1] = S[p, p]
            T[p, p + 1] = 0.0
            T[p + 1, p + 1] = T[p, p]
        in_pair = {r for p in pairs for r in (p, p + 1)}
        for j in range(3, W, 7):
            if j not in in_pair:
                T[j, j] = 0.0
        if g == 0 and W >= 10:
            for p in (6, 8):
                S[p:p + 2, p:p + 2] = [[1.0, 2.0], [-0.5, 1.0]]
                T[p:p + 2, p:p + 2] = np.eye(2)
            S[6:8, 8:10] = [[3.0, -1.0], [2.0, 5.0]]
            T[6:8, 8:10] = [[0.5, 1.0], [-1.0, 0.25]]
        sel = np.zeros(W, bool)
        i = 0
        while i < W:
            sz = 2 if i + 1 < W and S[i + 1, i] != 0 else 1
            sel[i:i + sz] = rng.random() < 0.5
            i += sz
        if g == 0 and W >= 10:
            sel[6:8], sel[8:10] = False, True
        Ss.append(S)
        Ts.append(T)
        sels.append(sel)
    return np.stack(Ss), np.stack(Ts), np.stack(sels)


def inf_push_window(Wb: int, seed: int, jrel: int, lrel: int):
    """A (Wb, Wb) Hessenberg-triangular window pair (H, T) as the QZ
    iteration's infinite push gives it: H random Hessenberg, T a random upper
    triangle plus 3 I with a negligible diagonal entry (1e-17) at jrel and,
    for lrel >= 1, the segment top there (H[lrel, lrel - 1] = 0)."""
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((Wb, Wb)), -1)
    T = np.triu(rng.standard_normal((Wb, Wb))) + 3 * np.eye(Wb)
    T[jrel, jrel] = 1e-17
    if lrel >= 1:
        H[lrel, lrel - 1] = 0.0
    return H, T


def _rng(seed):
    return np.random.default_rng(seed)


def random_dense(n: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    return _rng(seed).standard_normal((n, n)).astype(dtype)


def random_orthogonal(n: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    q, r = np.linalg.qr(_rng(seed).standard_normal((n, n)))
    return (q * np.sign(np.diag(r))).astype(dtype)


def random_hessenberg(n: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    return np.triu(random_dense(n, seed, dtype), -1)


def known_spectrum_matrix(n: int, complex_ratio: float = 0.5,
                          zero_ratio: float = 0.0, seed: int = 0,
                          dtype=np.float64, hessenberg: bool = False):
    """Dense matrix with a planted spectrum.

    Builds a quasi-triangular Schur form (standardized 2x2 blocks for the
    complex pairs, a zero eigenvalue with probability ``zero_ratio``) and
    scrambles it by a random orthogonal similarity.  Returns (A, eig), eig
    the complex eigenvalues.  With ``hessenberg`` the scrambled matrix is
    reduced back to upper Hessenberg form (same spectrum).
    """
    rng = _rng(seed)
    S = np.zeros((n, n), dtype)
    eig = np.zeros(n, complex)
    i = 0
    while i < n:
        make_pair = i + 1 < n and rng.random() < complex_ratio
        if make_pair:
            # standardized 2x2 block [[p, b], [c, p]] with b c < 0
            p = rng.standard_normal()
            b = np.abs(rng.standard_normal()) + 0.1
            c = -(np.abs(rng.standard_normal()) + 0.1)
            S[i, i] = p
            S[i + 1, i + 1] = p
            S[i, i + 1] = b
            S[i + 1, i] = c
            w = np.sqrt(-b * c)
            eig[i] = p + 1j * w
            eig[i + 1] = p - 1j * w
            i += 2
        else:
            lam = 0.0 if rng.random() < zero_ratio else rng.standard_normal()
            S[i, i] = lam
            eig[i] = lam
            i += 1
    # the strict upper triangle above the blocks, scaled by 1/sqrt(n): an
    # unscaled random triangle makes the eigenvalue condition numbers grow
    # exponentially in n
    upper = np.triu(rng.standard_normal((n, n)), 2) / np.sqrt(max(n, 2))
    S = S + upper.astype(dtype)
    Q0 = random_orthogonal(n, seed + 1, dtype)
    A = Q0 @ S @ Q0.T
    if hessenberg:
        A = _to_hessenberg(A)
    return A.astype(dtype), eig


def _to_hessenberg(A: np.ndarray) -> np.ndarray:
    """Upper Hessenberg form by host Householder (test scaffolding)."""
    import scipy.linalg

    return scipy.linalg.hessenberg(A)


def known_spectrum_pencil(n: int, complex_ratio: float = 0.5,
                          zero_ratio: float = 0.0, inf_ratio: float = 0.0,
                          seed: int = 0, dtype=np.float64):
    """Pencil (A, B) with a planted generalized spectrum.

    Builds a generalized Schur pair (S, T): S quasi-triangular, T upper
    triangular with zero diagonal entries planting infinite eigenvalues;
    scrambles it with random orthogonal Q0, Z0: A = Q0 S Z0^T,
    B = Q0 T Z0^T.  Returns (A, B, alpha, beta): the eigenvalues are
    alpha/beta, beta == 0 for an infinite one.
    """
    rng = _rng(seed)
    S = np.zeros((n, n), dtype)
    T = np.zeros((n, n), dtype)
    alpha = np.zeros(n, complex)
    beta = np.ones(n)
    i = 0
    while i < n:
        make_pair = i + 1 < n and rng.random() < complex_ratio
        if make_pair:
            p = rng.standard_normal()
            b = np.abs(rng.standard_normal()) + 0.1
            c = -(np.abs(rng.standard_normal()) + 0.1)
            S[i, i] = p
            S[i + 1, i + 1] = p
            S[i, i + 1] = b
            S[i + 1, i] = c
            T[i, i] = 1.0
            T[i + 1, i + 1] = 1.0
            w = np.sqrt(-b * c)
            alpha[i] = p + 1j * w
            alpha[i + 1] = p - 1j * w
            i += 2
        else:
            r = rng.random()
            if r < inf_ratio:
                S[i, i] = np.abs(rng.standard_normal()) + 0.5
                T[i, i] = 0.0
                alpha[i] = S[i, i]
                beta[i] = 0.0
            elif r < inf_ratio + zero_ratio:
                S[i, i] = 0.0
                T[i, i] = np.abs(rng.standard_normal()) + 0.5
                alpha[i] = 0.0
            else:
                S[i, i] = rng.standard_normal()
                T[i, i] = np.abs(rng.standard_normal()) + 0.5
                alpha[i] = S[i, i]
                beta[i] = T[i, i]
            i += 1
    scale = 1.0 / np.sqrt(max(n, 2))
    S = S + (np.triu(rng.standard_normal((n, n)), 2) * scale).astype(dtype)
    Tnoise = np.triu(rng.standard_normal((n, n)), 1) * scale
    # T stays diagonal inside the 2x2 S-blocks: a nonzero T[i, i+1] there
    # would change the planted pair
    for i in range(n - 1):
        if S[i + 1, i] != 0:
            Tnoise[i, i + 1] = 0.0
    T = T + Tnoise.astype(dtype)
    Q0 = random_orthogonal(n, seed + 1, dtype)
    Z0 = random_orthogonal(n, seed + 2, dtype)
    A = Q0 @ S @ Z0.T
    B = Q0 @ T @ Z0.T
    return A.astype(dtype), B.astype(dtype), alpha, beta


def planted_schur_pair(W: int, kact: int, seed: int):
    """A (W, W) generalized Schur pair (S, T) and near-identity orthogonal
    window transforms (Q, Z), as an AED window holds them: S upper
    triangular with standardized 2x2 complex blocks planted every 7 rows in
    its leading kact block (T diagonal inside them), T upper triangular
    with diagonal >= 2 - |noise|, zero outside the leading kact block."""
    rng = np.random.default_rng(seed)
    S = np.zeros((W, W))
    T = np.zeros((W, W))
    S[:kact, :kact] = np.triu(rng.standard_normal((kact, kact)))
    T[:kact, :kact] = np.triu(rng.standard_normal((kact, kact))) + 2 * np.eye(kact)
    for p in range(3, kact - 2, 7):
        S[p + 1, p] = -abs(rng.standard_normal()) - 0.1
        S[p, p + 1] = abs(rng.standard_normal()) + 0.1
        S[p + 1, p + 1] = S[p, p]
        T[p, p + 1] = 0.0
        T[p + 1, p + 1] = T[p, p]
    Q = np.eye(W)
    Z = np.eye(W)
    for M in (Q, Z):
        M[:kact, :kact] = np.linalg.qr(
            np.eye(kact) + 0.05 * rng.standard_normal((kact, kact)))[0]
    return S, T, Q, Z
