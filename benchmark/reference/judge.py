"""The comparison that decides ``correct``: plain torch and numpy, importing
nothing of the program.

``judge(problem, inputs, outputs, predicate)`` reads the input tensors the
benchmark made and the outputs a solver gave for them (the program's, or
the reference solvers' of ``solvers.py`` for the control) and returns the
numbers it compares, each a float where lower is better:

- ``residual_u``: ||Q S Q^T - A||_F / ||A||_F (SEP; S is H after a
  Hessenberg reduction), or the larger of ||Q S Z^T - A||_F / ||A||_F and
  ||Q T Z^T - B||_F / ||B||_F (GEP), in units of u = 2^-52;
- ``orthogonality_u``: ||Q^T Q - I||_F / sqrt(n) (the larger of Q's and
  Z's), in u;
- ``structure``: the largest entry where the form has a structural zero
  (below H's subdiagonal; below S's subdiagonal, two adjacent nonzero
  subdiagonal entries, a 2x2 block that is not a standardized complex pair
  (SEP); below T's diagonal (GEP)), ``inf`` for a 2x2 block with real
  eigenvalues;
- ``info``: the solver's nonzero return codes (Schur or QZ, reordering);
- ``eigenvalue_u``: the largest backward error of a returned eigenvalue
  with respect to the diagonal block at its row, in u;
- ``misplaced``: after a reordering, the rows of the leading m that hold an
  eigenvalue the rule rejects, plus the rows below m that hold one it
  accepts (+1 when m splits a 2x2 block), leaving out the rows that
  rounding can put on either side of the rule (``_accepts``); an infinite
  eigenvalue (beta 0 or a rounding of 0) is always rejected;
- ``eigenvector_u``: the largest ||A x - lambda x|| / (||A||_F ||x||)
  (SEP) or ||beta A x - alpha B x|| / ((|beta| ||A||_F + |alpha| ||B||_F)
  ||x||) (GEP) over the returned eigenvectors of the leading m block, in u.

A number is judged only where the outputs hold what it reads.
"""

from __future__ import annotations

import math

import numpy as np
import torch

U = 2.0 ** -52


def _rel(M, R) -> float:
    return float(torch.linalg.norm(M - R) / torch.linalg.norm(R)) / U


def _orth(Q) -> float:
    n = Q.shape[0]
    E = Q.T @ Q
    E.diagonal().sub_(1.0)
    return float(torch.linalg.norm(E)) / math.sqrt(n) / U


def _diagonals(M):
    """(diagonal, subdiagonal, superdiagonal) of M on the host, the
    off-diagonals padded with a trailing 0."""
    z = M.new_zeros(1)
    d = torch.stack([torch.diagonal(M), torch.cat([torch.diagonal(M, -1), z]),
                     torch.cat([torch.diagonal(M, 1), z])])
    return d.cpu().numpy()


def block_starts(sub: np.ndarray) -> np.ndarray:
    """Which rows start a 2x2 diagonal block (a nonzero subdiagonal entry
    not preceded by one)."""
    nz = sub != 0
    start = nz.copy()
    for i in range(1, len(nz)):
        if start[i - 1]:
            start[i] = False
    return start


def _tril_max(M, k: int) -> float:
    return float(torch.tril(M, k).abs().max()) if M.shape[0] > 1 - k else 0.0


def structure_sep(S) -> float:
    """Deviation of S from a standardized real quasi-triangular form."""
    d, sub, sup = _diagonals(S)
    err = _tril_max(S, -2)
    if len(d) < 2:
        return err
    blk = sub[:-1] != 0
    if np.any(blk & (sub[:-1] * sup[:-1] >= 0)):
        return math.inf
    adj = np.minimum(np.abs(sub[:-2]), np.abs(sub[1:-1])) if len(d) > 2 else np.zeros(0)
    parts = [err, float(adj.max()) if adj.size else 0.0]
    dd = np.abs(d[:-1] - d[1:])[blk]
    if dd.size:
        parts.append(float(dd.max()))
    return max(parts)


def structure_hessenberg(H) -> float:
    return _tril_max(H, -2)


def structure_gep(S, T) -> float:
    """Deviation of (S, T) from a generalized real Schur form: S
    quasi-triangular with non-adjacent 2x2 blocks, T upper triangular."""
    _d, sub, _sup = _diagonals(S)
    adj = np.minimum(np.abs(sub[:-2]), np.abs(sub[1:-1])) if len(sub) > 2 else np.zeros(0)
    return max(_tril_max(S, -2), _tril_max(T, -1), float(adj.max()) if adj.size else 0.0)


def block_eigenvalues(S, T=None):
    """Each row's eigenvalue in homogeneous form (alpha complex, beta real),
    worked out from the diagonal blocks of S (of the pencil (S, T)); a 2x2
    block's row pair gets its two roots, the first with Im(alpha/beta) >= 0.  Returns
    (alpha, beta, start) as numpy arrays, start marking the rows that begin
    a 2x2 block."""
    d, sub, sup = _diagonals(S)
    n = len(d)
    start = block_starts(sub)
    if T is None:
        alpha = d.astype(complex)
        beta = np.ones(n)
    else:
        td, _tsub, tsup = _diagonals(T)
        alpha = d.astype(complex)
        beta = td.copy()
    i = np.nonzero(start)[0]
    if i.size:
        s11, s12, s21, s22 = d[i], sup[i], sub[i], d[i + 1]
        if T is None:
            mid = 0.5 * (s11 + s22)
            root = np.sqrt((0.25 * (s11 - s22) ** 2 + s12 * s21).astype(complex))
            a1, a2, b = mid + root, mid - root, np.ones(i.size)
        else:
            # the pencil's quadratic in extended precision: a pair close to
            # a real double root loses digits to cancellation in float64
            ld = np.longdouble
            s11, s12, s21, s22 = (x.astype(ld) for x in (s11, s12, s21, s22))
            t11, t12, t22 = (x.astype(ld) for x in (td[i], tsup[i], td[i + 1]))
            qa = t11 * t22
            qb = -(s11 * t22 + s22 * t11 - s21 * t12)
            qc = s11 * s22 - s12 * s21
            root = np.sqrt((qb * qb - 4 * qa * qc).astype(np.clongdouble))
            a1, a2 = ((-qb + root) / 2).astype(complex), ((-qb - root) / 2).astype(complex)
            b = qa.astype(float)
        swap = a1.imag * b < a2.imag * b
        a1, a2 = np.where(swap, a2, a1), np.where(swap, a1, a2)
        alpha[i], alpha[i + 1] = a1, a2
        beta[i], beta[i + 1] = b, b
    return alpha, beta, start


def eigenvalue_error(S, T, start, alpha_p, beta_p) -> float:
    """Largest backward error of a returned eigenvalue (alpha, beta) with
    respect to the diagonal block of S (of (S, T)) at its row:
    sigma_min(beta S_b - alpha T_b) / (||(alpha, beta)|| ||(S_b, T_b)||_F),
    in u (T_b = I for the SEP; the homogeneous norms keep an infinite
    eigenvalue of a 1x1 block, beta = T_b = 0, at 0).  It is small for any eigenvalue of the
    block however ill-conditioned, and needs no ordering within a pair."""
    d, sub, sup = _diagonals(S)
    n = len(d)
    if T is None:
        td, tsup = np.ones(n), np.zeros(n)
    else:
        td, _tsub, tsup = _diagonals(T)
    second = np.zeros(n, bool)
    second[1:] = start[:-1]
    top = np.where(second, np.arange(n) - 1, np.arange(n))   # the block's first row
    pair = start[top]
    t = top
    t1 = np.minimum(t + 1, n - 1)
    s11, s12 = d[t], np.where(pair, sup[t], 0.0)
    s21, s22 = np.where(pair, sub[t], 0.0), np.where(pair, d[t1], 0.0)
    t11, t12, t22 = td[t], np.where(pair, tsup[t], 0.0), np.where(pair, td[t1], 0.0)
    a, b = np.asarray(alpha_p, complex), np.asarray(beta_p, float)
    m11, m12, m21, m22 = b * s11 - a * t11, b * s12 - a * t12, b * s21, b * s22 - a * t22
    f2 = np.abs(m11) ** 2 + np.abs(m12) ** 2 + np.abs(m21) ** 2 + np.abs(m22) ** 2
    det = np.abs(m11 * m22 - m12 * m21)
    smax = np.sqrt((f2 + np.sqrt(np.maximum(f2 * f2 - 4 * det * det, 0.0))) / 2)
    smin = np.where(pair, det / np.maximum(smax, 1e-300), np.abs(m11))
    ns = np.sqrt(s11 ** 2 + s12 ** 2 + s21 ** 2 + s22 ** 2)
    nt = np.sqrt(t11 ** 2 + t12 ** 2 + t22 ** 2)
    den = np.sqrt(np.abs(a) ** 2 + b * b) * np.sqrt(ns * ns + nt * nt)
    eta = np.where(den > 0, smin / np.where(den > 0, den, 1.0), np.inf)
    eta = np.where(np.isnan(eta), np.inf, eta)
    return float(np.max(eta)) / U if n else 0.0


BAND = 1e-10
INFINITE = 1e-13
HUGE = 1e-4


def _accepts(alpha, beta, predicate, snorm, tnorm):
    """(accepted, undecided) for each row's eigenvalue under the rule
    ``finite_right_half`` (beta != 0 and Re(alpha / beta) > 0).  The
    eigenvalue's size in the pencil's own scale, r = |beta| ||S||_F /
    (|alpha| ||T||_F) (1 / |lambda| for ||S|| = ||T||), sorts the rows:

    - r <= INFINITE: an infinite eigenvalue, beta 0 or a rounding of 0
      (a reordering leaves a moved zero at about u): rejected;
    - INFINITE < r <= HUGE: an infinite eigenvalue of a defective block
      (adjacent infinite rows) that rounding left finite, at about sqrt(u)
      (u^(1/3) for a block of three): whether beta != 0 holds is rounding's
      choice, so the row is undecided;
    - otherwise finite: accepted where Re(lambda) > 0, undecided where
      Re(lambda) is within BAND |lambda| of zero."""
    if predicate != "finite_right_half":
        raise KeyError(f"unknown predicate {predicate!r}")
    a = np.abs(alpha) * tnorm
    r = np.divide(np.abs(beta) * snorm, a, out=np.full(len(a), np.inf), where=a > 0)
    r = np.where(beta == 0, 0.0, r)
    infinite, finite = r <= INFINITE, r > HUGE
    lam = alpha / np.where(infinite, 1.0, beta)
    near = np.abs(lam.real) <= BAND * np.abs(lam)
    return finite & (lam.real > 0), (~infinite & ~finite) | (finite & near)


def misplaced(alpha, beta, start, m: int, predicate: str, snorm: float, tnorm: float) -> int:
    acc, undecided = _accepts(alpha, beta, predicate, snorm, tnorm)
    n = len(acc)
    rows = np.arange(n)
    bad = int(np.sum(~acc & ~undecided & (rows < m)) + np.sum(acc & ~undecided & (rows >= m)))
    if 0 < m < n and start[m - 1]:
        bad += 1
    return bad


def eigenvector_error(A, X, alpha, beta, start, m: int, B=None) -> float:
    """Largest eigenvector residual over the leading m block's vectors
    (X in LAPACK real storage: a column per real eigenvalue, a (Re, Im)
    column pair per complex pair, for the root with Im > 0), in u."""
    dev = X.device
    second = np.zeros_like(start)
    second[1:] = start[:-1]
    first = np.nonzero(~second[:m])[0]           # a column per block start
    pair = start[first]
    if X.shape[1] != m or first.size == 0:
        return math.inf
    f = torch.as_tensor(first, device=dev)
    p = torch.as_tensor(np.where(pair, first + 1, first), device=dev)
    pm = torch.as_tensor(pair, device=dev)
    ar = torch.as_tensor(alpha[first].real, device=dev)
    ai = torch.as_tensor(alpha[first].imag, device=dev)
    bt = torch.as_tensor(beta[first], dtype=torch.float64, device=dev)
    AX = A @ X
    BX = X if B is None else B @ X
    xr, xi = X[:, f], torch.where(pm, X[:, p], 0.0)
    axr, axi = AX[:, f], torch.where(pm, AX[:, p], 0.0)
    bxr, bxi = BX[:, f], torch.where(pm, BX[:, p], 0.0)
    re = bt * axr - ar * bxr + ai * bxi
    im = bt * axi - ar * bxi - ai * bxr
    num = torch.sqrt((re * re + im * im).sum(0))
    xn = torch.sqrt((xr * xr + xi * xi).sum(0))
    na = torch.linalg.norm(A)
    if B is None:
        den = na * xn
    else:
        den = (bt.abs() * na + torch.sqrt(ar * ar + ai * ai) * torch.linalg.norm(B)) * xn
    r = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), math.inf)
    r = torch.where(torch.isnan(r), math.inf, r)
    return float(r.max()) / U


def judge(problem: str, inputs: dict, out: dict, predicate=None) -> dict:
    """The numbers compared for one problem (see the module note)."""
    A = inputs["A"]
    B = inputs.get("B")
    nums = {}
    infos = [int(out[k]) for k in ("info", "reorder_info") if k in out]
    nums["info"] = float(sum(1 for v in infos if v != 0))
    if problem == "sep":
        S = out["S"] if "S" in out else out["H"]
        Q = out["Q"]
        nums["residual_u"] = _rel(Q @ S @ Q.T, A)
        nums["orthogonality_u"] = _orth(Q)
        nums["structure"] = structure_sep(S) if "S" in out else structure_hessenberg(S)
        if "S" not in out:
            return nums
        alpha, beta, start = block_eigenvalues(S)
    else:
        S, T, Q, Z = out["S"], out["T"], out["Q"], out["Z"]
        nums["residual_u"] = max(_rel(Q @ S @ Z.T, A), _rel(Q @ T @ Z.T, B))
        nums["orthogonality_u"] = max(_orth(Q), _orth(Z))
        nums["structure"] = structure_gep(S, T)
        alpha, beta, start = block_eigenvalues(S, T)
    if "eig_real" in out:
        ap = (out["eig_real"].cpu().numpy() + 1j * out["eig_imag"].cpu().numpy())
        bp = out["eig_beta"].cpu().numpy() if "eig_beta" in out else np.ones(len(ap))
        nums["eigenvalue_u"] = eigenvalue_error(S, T if problem == "gep" else None,
                                                start, ap, bp)
    if "m" in out:
        m = int(out["m"])
        norms = float(torch.linalg.norm(S)), float(torch.linalg.norm(out["T"]))
        nums["misplaced"] = float(misplaced(alpha, beta, start, m, predicate, *norms))
        if "X" in out:
            nums["eigenvector_u"] = eigenvector_error(A, out["X"], alpha, beta, start, m, B)
    return nums


def backward_error_u(nums: dict) -> float:
    """The normwise backward error of one problem: the larger of its
    residual and its orthogonality, in u."""
    return max(nums["residual_u"], nums["orthogonality_u"])


def failures(nums: dict, limits: dict) -> list:
    """The names of the numbers above their limits (a NaN fails)."""
    return [k for k, v in nums.items() if not v <= limits[k]]
