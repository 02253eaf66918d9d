"""The port's QZ driver on the infinite-eigenvalue segment of
tests/test_qz_driver.py:58-91 (n=120 in HT form, exact T-diagonal zeros at
five non-adjacent rows, small limit 32, AED window 24): the rounds that
push an infinite eigenvalue down in windows run (plain PyTorch), and both
packages pass that test's gates and recover every planted infinity with
beta == 0 (|beta| <= 1e-12 max|beta|) (CPU).  The push's window chase
(``_inf_chase_kernel``, the plain twin of kernel G5) is also held to JAX's
elementwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.config import SchurConf as JSchurConf
from starneig_tpu.ops import qz_driver as jqd
from starneig_tpu_torch.convert import conf_from_jax, from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import qz_driver as tqd
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.ops import primitives as prim
from starneig_tpu_torch.testing.generators import inf_push_window

torch.set_num_threads(1)


def test_qz_schur_inf_large_segment():
    rng = np.random.default_rng(11)
    n = 120
    H0 = np.triu(rng.standard_normal((n, n)), -1)
    T0 = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    inf_pos = [15, 40, 62, 77, 103]
    for j in inf_pos:
        T0[j, j] = 0.0
    conf = JSchurConf(small_limit=32, aed_window_size=24, aed_shift_count=16)
    want = jqd.qz_schur(jnp.asarray(H0), jnp.asarray(T0), conf=conf)
    stats = {}
    got = tqd.qz_schur(from_numpy(H0), from_numpy(T0), conf=conf_from_jax(conf),
                       stats=stats)
    assert want[7] == got[7] == Error.SUCCESS
    for S_, T_, Q_, Z_, _ar, _ai, bt, _info in (want, got):
        S_, T_, Q_, Z_, bt = (to_numpy(x) if torch.is_tensor(x) else np.asarray(x)
                              for x in (S_, T_, Q_, Z_, bt))
        assert hooks.schur_structure_error(S_) == 0.0
        assert hooks.triangular_structure_error(T_) == 0.0
        ra, rb = hooks.residual_gep(H0, T0, S_, T_, Q_, Z_)
        assert max(ra, rb, hooks.orthogonality(Q_), hooks.orthogonality(Z_)) < 5000
        assert int((np.abs(bt) <= 1e-12 * np.abs(bt).max()).sum()) >= len(inf_pos)
    assert stats["inf_rounds"] >= len(inf_pos) and stats["inf_chase_calls"] > 0


@pytest.mark.parametrize("jrel,mrel,lrel", [(1, 24, -1), (0, 24, 0), (5, 17, 5),
                                            (3, 20, -1)])
def test_inf_chase_kernel(jrel, mrel, lrel):
    """The window chase of the infinite push (the twin of kernel G5) against
    JAX's _inf_chase_kernel at Wb = 24, with the right reflection skipped at
    lrel (the segment top) or not skipped (lrel = -1): the same rotations,
    within 1e-13 max|M|; the zero planted and moved to mrel - 1."""
    Wb = 24
    H, T = inf_push_window(Wb, 24 + jrel, jrel, lrel)
    want = jqd._inf_chase_kernel(jnp.asarray(H), jnp.asarray(T), jrel, mrel, lrel, Wb)
    got = tqd._inf_chase_kernel(from_numpy(H), from_numpy(T), jrel, mrel, lrel)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.abs(w - to_numpy(g)).max() <= 1e-13 * np.abs(w).max()
    Tg = to_numpy(got[1])
    assert Tg[mrel - 1, mrel - 1] == 0.0
    assert hooks.triangular_structure_error(Tg) == 0.0
    assert hooks.hessenberg_structure_error(to_numpy(got[0])) == 0.0


def _givens_r(f, g):
    """prim.givens, the twin's rotation, on floats: (c, s, r)."""
    return tuple(float(v) for v in prim.givens(torch.tensor(float(f), dtype=torch.float64),
                                               torch.tensor(float(g), dtype=torch.float64)))


def _g5_cut_chase(H, T, jrel, mrel, lrel, force_cut=False):
    """Kernel G5's chase (kernels/csrc/inf_chase.cu) in numpy: rows i, i+1
    of H from column i-1 and of T from column i+1, columns i-1, i of H's
    rows 0 .. i+1 and T's 0 .. i (the full ranges where a reflection is
    skipped inside the chase, lrel > jrel, unless force_cut), the next
    left rotation formed before this step's reflection is applied, and
    Qw's and Zw's rows from entries carried in registers (identity
    columns), only the rows the chase has reached stored."""
    Wb = H.shape[0]
    H, T = H.copy(), T.copy()
    Q, Z = np.eye(Wb), np.eye(Wb)
    T[jrel, jrel] = 0.0
    i0, last, zlo = jrel, mrel - 2, max(jrel - 1, 0)
    full = lrel > jrel and not force_cut
    r = np.arange(Wb)
    qv, zv = (r == i0).astype(float), (r == i0 - 1).astype(float)
    if i0 <= last:
        c, s, rl = _givens_r(T[i0, i0 + 1], T[i0 + 1, i0 + 1])
    for i in range(i0, last + 1):
        i1 = i + 1
        hlo, tlo = (0, 0) if full else (max(i - 1, 0), i1)
        for X, lo in ((H, hlo), (T, tlo)):
            x0, x1 = X[i, lo:].copy(), X[i1, lo:].copy()
            X[i, lo:], X[i1, lo:] = c * x0 + s * x1, -s * x0 + c * x1
        a = (r == i1).astype(float)
        nq, qv = c * qv + s * a, -s * qv + c * a
        rows = (r >= i0) & (r <= i1)
        Q[rows, i] = nq[rows]
        T[i, i1], T[i1, i1], T[i1, i] = rl, 0.0, 0.0
        refl, im1 = i != lrel, max(i - 1, 0)
        if refl:
            cr, sr, rr = _givens_r(H[i1, im1], H[i1, i])
        if i1 <= last:
            c, s, rl = _givens_r(T[i1, i1 + 1], T[i1 + 1, i1 + 1])
        a = (r == i).astype(float)
        if refl:
            for X, n in ((H, Wb if full else i1 + 1), (T, Wb if full else i + 1)):
                xa, xb = X[:n, im1].copy(), X[:n, i].copy()
                if im1 != i:
                    X[:n, im1] = -sr * xa + cr * xb
                X[:n, i] = cr * xa + sr * xb
            H[i1, i], H[i1, im1] = rr, 0.0
            if i == 0:
                zv = cr * a + sr * a
            else:
                rows = (r >= zlo) & (r <= i)
                Z[rows, i - 1] = (-sr * zv + cr * a)[rows]
                zv = cr * zv + sr * a
        else:
            if i > 0:
                rows = (r >= zlo) & (r <= i)
                Z[rows, i - 1] = zv[rows]
            zv = a
    if i0 <= last:
        rows = (r >= i0) & (r <= last + 1)
        Q[rows, last + 1] = qv[rows]
        rows = (r >= zlo) & (r <= last)
        Z[rows, last] = zv[rows]
    return H, T, Q, Z


@pytest.mark.parametrize("Wb,jrel,mrel,lrel", [(96, 1, 96, -1), (84, 0, 84, 0),
                                               (96, 7, 60, 7), (96, 95, 96, -1),
                                               (96, 1, 37, -1), (24, 3, 20, 5)])
def test_g5_ranges(Wb, jrel, mrel, lrel):
    """Kernel G5 touches only the entries of a window chase that can change
    and carries Qw's and Zw's moving columns in registers: _g5_cut_chase
    equals the full-width twin tqd._inf_chase_kernel entry for entry on the
    push's windows (chip_smoke.INF_CASES), a window with no step, the last,
    short window of a push and, with a reflection skipped inside the chase
    (lrel > jrel, H's fill left), the full ranges (the cut ranges alone
    differ there).  np.array_equal compares values, not a zero's sign."""
    H, T = inf_push_window(Wb, Wb + jrel, jrel, lrel)
    want = tqd._inf_chase_kernel(from_numpy(H), from_numpy(T), jrel, mrel, lrel)
    got = _g5_cut_chase(H, T, jrel, mrel, lrel)
    for w, g in zip(want, got):
        assert np.array_equal(to_numpy(w), g)
    if lrel > jrel:
        cut = _g5_cut_chase(H, T, jrel, mrel, lrel, force_cut=True)
        assert not all(np.array_equal(to_numpy(w), g) for w, g in zip(want, cut))
