"""The port's generalized eigenvectors (``ops/eigenvectors.py``:
``eigenvectors_schur_gep``) against the JAX package's, on the three inputs
of tests/test_eigenvectors_gep.py (CPU): n = 24 with every eigenvalue
selected, n = 32 with a subset, n = 20 with infinite eigenvalues.

Both run the same recurrence per eigenvalue (the port batched over the
eigenvalues, JAX vmapped), so info is equal and X agrees within 1e-10
max|X| (summation order of the row products); the port's vectors also
pass that test's residual checks.  ``test_backsolve_gep_twin`` holds the
port's plain row loop (the twin of kernel E2) to JAX's
``_backsolve_all_gep`` on the same scaled eigenvalues, before the
back-transformation: the normalized vectors within 1e-12, the close flags
equal, on those three inputs and on two numpy pencils that fire the
guards (a rescale, a lifted diagonal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from starneig_tpu.ops.eigenvectors import _backsolve_all_gep as j_backsolve_gep
from starneig_tpu.ops.eigenvectors import eigenvectors_schur_gep as j_evec_gep
from starneig_tpu.ops.hess_triangular import hessenberg_triangular
from starneig_tpu.ops.qz import small_qz
from starneig_tpu.testing import known_spectrum_pencil, random_dense
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.ops import eigenvectors as ev
from starneig_tpu_torch.ops.eigenvectors import eigenvectors_schur_gep
from starneig_tpu_torch.testing import generators

torch.set_num_threads(1)


def _make(n, seed, **kw):
    """tests/test_eigenvectors_gep.py:_make."""
    if kw:
        A, B, _alpha, _beta = known_spectrum_pencil(n, seed=seed, **kw)
    else:
        A = random_dense(n, seed=seed)
        B = random_dense(n, seed=seed + 77) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, Qo, Zo, info = small_qz(H, T, Q, Z, n)
    assert int(info) == 0
    return A, B, *map(np.asarray, (S, Tt, Qo, Zo))


def _worst_residual(A, B, S, Tt, X, select):
    """tests/test_eigenvectors_gep.py:_check_vectors: beta A x = alpha B x
    per returned column (B x = 0 for an infinite eigenvalue)."""
    n = A.shape[0]
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    nrm = np.linalg.norm(A) + np.linalg.norm(B)
    worst = 0.0
    c = i = 0
    while i < n:
        if sub[i] != 0:
            if select[i] or select[i + 1]:
                ev = scipy.linalg.eigvals(S[i:i + 2, i:i + 2], Tt[i:i + 2, i:i + 2])
                lam = ev[0] if ev[0].imag > 0 else ev[1]
                x = X[:, c] + 1j * X[:, c + 1]
                worst = max(worst, np.linalg.norm(A @ x - lam * (B @ x))
                            / (nrm * np.linalg.norm(x)))
                c += 2
            i += 2
        else:
            if select[i]:
                x = X[:, c]
                if abs(Tt[i, i]) > 1e-12:
                    lam = S[i, i] / Tt[i, i]
                    r = np.linalg.norm(A @ x - lam * (B @ x)) / (
                        nrm * np.linalg.norm(x) * max(1, abs(lam)))
                else:
                    r = np.linalg.norm(B @ x) / (nrm * np.linalg.norm(x))
                worst = max(worst, r)
                c += 1
            i += 1
    return worst


@pytest.mark.parametrize("case", ["all", "subset", "infinite"])
def test_eigenvectors_schur_gep(case):
    n, seed, kw = {"all": (24, 1, {}), "subset": (32, 5, {}),
                   "infinite": (20, 9, dict(complex_ratio=0.2, inf_ratio=0.2))}[case]
    A, B, S, Tt, Q, Z = _make(n, seed, **kw)
    sel = (np.random.default_rng(0).random(n) < 0.4) if case == "subset" \
        else np.ones(n, bool)
    Xj, infoj = j_evec_gep(jnp.asarray(S), jnp.asarray(Tt), jnp.asarray(Q),
                           jnp.asarray(Z), sel)
    Xt, infot = eigenvectors_schur_gep(*(from_numpy(x) for x in (S, Tt, Q, Z)), sel)
    Xj = np.asarray(Xj)
    assert infot == infoj
    assert Xt.shape == Xj.shape
    assert np.abs(to_numpy(Xt) - Xj).max() <= 1e-10 * np.abs(Xj).max()
    bound = 1e-8 if case == "infinite" else 1e-10     # that test's bounds
    assert _worst_residual(A, B, S, Tt, to_numpy(Xt), sel) < bound
    if case == "infinite":
        assert (np.abs(np.diagonal(Tt)) <= 1e-12 * np.abs(np.diagonal(Tt)).max()).any()


def test_eigenvectors_schur_gep_none_selected():
    _A, _B, S, Tt, Q, Z = _make(8, 3)
    X, info = eigenvectors_schur_gep(*(from_numpy(x) for x in (S, Tt, Q, Z)),
                                     np.zeros(8, bool))
    assert X.shape == (8, 0) and int(info) == 0


def _twin_case(case):
    """(S, T, select) of a twin case: the three inputs above, or a numpy
    pencil whose backsolve rescales (growth) or lifts a diagonal (close)."""
    if case == "growth":
        return generators.growth_pencil()
    if case == "close":
        return generators.close_pencil()
    n, seed, kw = {"all": (24, 1, {}), "subset": (32, 5, {}),
                   "infinite": (20, 9, dict(complex_ratio=0.2, inf_ratio=0.2))}[case]
    _A, _B, S, Tt, _Q, _Z = _make(n, seed, **kw)
    sel = (np.random.default_rng(0).random(n) < 0.4) if case == "subset" \
        else np.ones(n, bool)
    return S, Tt, sel


@pytest.mark.parametrize("case", ["all", "subset", "infinite", "growth", "close"])
def test_backsolve_gep_twin(case, monkeypatch):
    """The plain GEP row loop (_backsolve_inputs_gep, _backsolve_rows_gep,
    _normalize) against JAX's _backsolve_all_gep (jitted, XLA on the CPU)
    on the same scaled (ar, ai, bt, pos, is_pair): xr and xi within 1e-12,
    the close flags equal; growth scales a vector by fac < 1e-50, close
    sets a flag."""
    facs = []
    rescale = ev._rescale

    def spy(*args):
        fac = rescale(*args)
        facs.append(float(fac.min()))
        return fac
    monkeypatch.setattr(ev, "_rescale", spy)
    S, Tt, sel = _twin_case(case)
    St, Tq = from_numpy(S), from_numpy(Tt)
    pos, pair, ar, ai, bt = (list(x) for x in zip(*ev._selected_blocks_gep(St, Tq, sel)))
    m = len(pos)
    as_t = dict(dtype=torch.float64)
    ar_t, ai_t, bt_t = (torch.tensor(v, **as_t) for v in (ar, ai, bt))
    args = ev._backsolve_inputs_gep(St, Tq, ar_t, ai_t, bt_t, pos, pair)
    close = ev._backsolve_rows_gep(St, Tq, ar_t, ai_t, bt_t, pos, pair, *args)
    xr, xi = (to_numpy(x) for x in ev._normalize(*args[-2:]))
    # JAX's call, padded as its eigenvectors_schur_gep pads
    mp = max(8, -(-m // 8) * 8)
    pad = mp - m
    jxr, jxi, jclose = j_backsolve_gep(
        jnp.asarray(S), jnp.asarray(Tt), jnp.asarray(ar + [0.0] * pad),
        jnp.asarray(ai + [0.0] * pad), jnp.asarray(bt + [1.0] * pad),
        jnp.asarray(pos + [0] * pad, jnp.int32), jnp.asarray(pair + [False] * pad),
        jnp.asarray([True] * m + [False] * pad))
    assert np.abs(xr - np.asarray(jxr)[:m]).max() <= 1e-12
    assert np.abs(xi - np.asarray(jxi)[:m]).max() <= 1e-12
    np.testing.assert_array_equal(to_numpy(close), np.asarray(jclose)[:m])
    assert np.isfinite(xr).all() and np.isfinite(xi).all()
    assert not any(xi[j].any() for j in range(m) if not pair[j])   # real: xi zero
    if case == "growth":
        assert min(facs) < 1e-50           # at least one vector scaled down hard
    if case == "close":
        assert bool(close.any())
    if case == "infinite":
        assert any(b == 0.0 for b in bt)
