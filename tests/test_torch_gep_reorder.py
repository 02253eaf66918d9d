"""The port's pencil reordering (``ops/reorder.py``: ``_window_bubble_gep``,
``reorder_schur_gep``) against the JAX package's, on the same seeded
inputs (CPU).

The window bubble runs the same scan/swap machine with the same dtgex2
swaps, so every integer (selection, insertion row, rejected swaps) is
equal and the matrices agree within 1e-12 max|M| (summation order of the
4-row and 4-column updates).  The chain over windows agrees within 1e-10
max|M| (the window transforms' GEMMs round in another order over many
windows), with the same leading count and info, and passes the gates of
tests/test_reorder_gep.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from starneig_tpu.config import ReorderConf as JReorderConf
from starneig_tpu.ops import reorder as jr
from starneig_tpu.ops.eigvals import extract_eigenvalues_gen
from starneig_tpu.ops.hess_triangular import hessenberg_triangular
from starneig_tpu.ops.qz import small_qz
from starneig_tpu.testing import random_dense
from starneig_tpu_torch.convert import conf_from_jax, from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import reorder as tr
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.generators import planted_pencil_windows

torch.set_num_threads(1)


def _make_gen_schur(n, seed):
    """tests/test_reorder_gep.py:_make_gen_schur: a random pencil's
    generalized Schur form by the JAX package."""
    A = random_dense(n, seed=seed)
    B = random_dense(n, seed=seed + 1000) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, Qo, Zo, info = small_qz(H, T, Q, Z, n)
    assert int(info) == 0
    return A, B, *map(np.asarray, (S, Tt, Qo, Zo))


def _eigs(S, Tt):
    er, ei, bt = map(np.asarray, extract_eigenvalues_gen(jnp.asarray(S), jnp.asarray(Tt)))
    return (er + 1j * ei) / np.where(bt == 0, 1e-300, bt)


def _bubble_both(S, T, sel, dst0, dst_limit, wlim):
    want = jr._window_bubble_gep(jnp.asarray(S), jnp.asarray(T), jnp.asarray(sel),
                                 dst0, dst_limit, wlim)
    host = {}
    got = tr._window_bubble_gep(from_numpy(S), from_numpy(T), sel, dst0, dst_limit,
                                wlim, host=host)
    return want, got, host


def _hold_window(want, got):
    """Equal integers and selection; matrices within 1e-12 max|M|."""
    assert (int(want[5]), int(want[6])) == (got[5], got[6])
    np.testing.assert_array_equal(np.asarray(want[4]), got[4])
    for w, g in zip(want[:4], got[:4]):
        w = np.asarray(w)
        assert np.abs(w - to_numpy(g)).max() <= 1e-12 * np.abs(w).max()


@pytest.mark.parametrize("case", ["whole", "straddled", "limited"])
def test_window_bubble_gep(case):
    """Windows of a random pencil's Schur form (n=32, W=16) as the chain
    places them: the whole leading window; a window whose top row is the
    second row of a 2x2 block and whose edges freeze the straddling halves
    (dst0 = 1 and, where a block straddles the bottom edge, wlim = W - 1);
    an insertion limit that stops the bubble early."""
    n, W = 32, 16
    _A, _B, S, T, _Q, _Z = _make_gen_schur(n, 32)
    sub = np.concatenate([np.diagonal(S, -1), [0.0]])
    sel = tr._align_select(sub, np.random.default_rng(7).random(n) < 0.5)
    ws = 0
    if case == "straddled":
        ws = next(w for w in range(1, n - W) if sub[w - 1] != 0)
    wlo = 1 if ws > 0 and sub[ws - 1] != 0 else 0
    wlim = W - 1 if ws + W < n and sub[ws + W - 1] != 0 else W
    lims = (wlo, 5 if case == "limited" else W, wlim)
    w = slice(ws, ws + W)
    want, got, host = _bubble_both(S[w, w], T[w, w], sel[w], *lims)
    _hold_window(want, got)
    assert got[7] > 0 and host["steps"] >= got[7]
    np.testing.assert_array_equal(host["subdiag"], np.diagonal(to_numpy(got[0]), -1))


@pytest.mark.parametrize("W,g,lims", [(16, 0, (0, 16, 16)), (16, 1, (1, 16, 15)),
                                      (24, 0, (0, 6, 24))])
def test_window_bubble_gep_planted(W, g, lims):
    """Planted windows with 2x2 blocks, exact T-diagonal zeros (infinite
    eigenvalues moved past and moving) and, in window 0, a swap of two equal
    2x2 pencil blocks, which both packages reject."""
    Ss, Ts, sels = planted_pencil_windows(2, W, W + 1)
    want, got, _host = _bubble_both(Ss[g], Ts[g], sels[g], *lims)
    _hold_window(want, got)
    if g == 0:       # the rejected 2x2 block is deselected
        assert got[6] == 1 and got[4].sum() == sels[g].sum() - 2


def _gates(A, B, S2, T2, Q2, Z2, limit):
    assert hooks.schur_structure_error(S2) == 0.0
    assert hooks.triangular_structure_error(T2) == 0.0
    ra, rb = hooks.residual_gep(A, B, S2, T2, Q2, Z2)
    assert max(ra, rb, hooks.orthogonality(Q2), hooks.orthogonality(Z2)) < limit


@pytest.mark.parametrize("n,W", [(8, None), (24, None), (48, 16)])
def test_reorder_schur_gep(n, W):
    A, B, S, T, Q, Z = _make_gen_schur(n, seed=n + 3)
    ev = _eigs(S, T)
    sel = ev.real > np.median(ev.real)
    conf = None if W is None else JReorderConf(window_size=W)
    want = jr.reorder_schur_gep(S, T, Q, Z, sel, conf)
    stats = {}
    got = tr.reorder_schur_gep(*(from_numpy(x) for x in (S, T, Q, Z)), sel,
                               conf_from_jax(conf), stats=stats)
    assert (want[4], want[5]) == (got[4], got[5]) and got[5] == Error.SUCCESS
    for w, g in zip(want[:4], got[:4]):
        w = np.asarray(w)
        assert np.abs(w - to_numpy(g)).max() <= 1e-10 * np.abs(w).max()
    S2, T2, Q2, Z2 = map(to_numpy, got[:4])
    _gates(A, B, S2, T2, Q2, Z2, 5000)
    m = got[4]
    lead = scipy.linalg.eigvals(S2[:m, :m], T2[:m, :m])
    assert len(lead) == int(sel.sum())
    assert hooks.eigenvalue_error(lead, ev[sel]) < 1e6
    assert stats["windows"] >= 1 and stats["swaps"] > 0 and stats["failed_swaps"] == 0


def _planted_pencil(n, seed, inf_rows):
    """A generalized Schur pair (S quasi-triangular with standardized 2x2
    blocks, T upper triangular) with exact T-diagonal zeros at inf_rows, as
    the QZ iteration leaves the infinite eigenvalues it pushed down."""
    Ss, Ts, _sel = planted_pencil_windows(1, n, seed)
    S, T = Ss[0], Ts[0]
    d = np.diagonal(T).copy()
    d[d == 0.0] = 1.5
    d[list(inf_rows)] = 0.0
    T[np.diag_indices(n)] = d
    return S, T


def test_reorder_schur_gep_infinite():
    """The infinite eigenvalues (exact T-diagonal zeros near the bottom) to
    the top: the same count and info as JAX, the same matrices within
    1e-10, and every leading beta at most 1e-12 max|beta| on both sides."""
    n = 40
    inf_rows = (33, 35, 38)
    S, T = _planted_pencil(n, 12, inf_rows)
    Q = Z = np.eye(n)
    sel = np.abs(np.diagonal(T)) == 0.0
    assert sel.sum() == len(inf_rows)
    want = jr.reorder_schur_gep(S, T, Q, Z, sel)
    got = tr.reorder_schur_gep(*(from_numpy(x) for x in (S, T, Q, Z)), sel)
    assert (want[4], want[5]) == (got[4], got[5]) == (len(inf_rows), Error.SUCCESS)
    for w, g in zip(want[:4], got[:4]):
        w = np.asarray(w)
        assert np.abs(w - to_numpy(g)).max() <= 1e-10 * np.abs(w).max()
    for T2 in (np.asarray(want[1]), to_numpy(got[1])):
        d = np.abs(np.diagonal(T2))
        assert (d[:len(inf_rows)] <= 1e-12 * d.max()).all()
    S2, T2, Q2, Z2 = map(to_numpy, got[:4])
    _gates(S, T, S2, T2, Q2, Z2, 500)
