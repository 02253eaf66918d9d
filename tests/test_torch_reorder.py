"""The port's eigenvalue reordering against the JAX package's, on the same
seeded Schur forms (CPU).

The window bubble and both routines run the same swaps in the same order
on both sides, so they must agree on every integer (rows in the leading
block, info, the selection, the insertion row, the failed swaps) and on S
and Q within 1e-12 ||S||_F: the same operations in another summation
order.  Each output is also held to the reference's own gates: exact
quasi-triangular structure, residual and orthogonality below 2000 u
(``tests/test_reorder.py``'s bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.config import ReorderConf as JReorderConf
from starneig_tpu.ops import reorder as jreorder
from starneig_tpu.ops.small_schur import small_schur as jsmall
from starneig_tpu.testing import random_hessenberg
from starneig_tpu_torch.config import ReorderConf
from starneig_tpu_torch.convert import from_numpy, to_numpy
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import reorder as treorder
from starneig_tpu_torch.testing.hooks import (
    orthogonality,
    residual_sep,
    schur_structure_error,
)

torch.set_num_threads(1)

GATE = 2000.0


def _schur(n, seed):
    H = random_hessenberg(n, seed=seed)
    S, Q, info = jsmall(jnp.array(H), jnp.eye(n), n)
    assert int(info) == 0
    return np.asarray(S), np.asarray(Q), H


def _median_pick(n):
    def pick(S):
        d = np.diagonal(S)
        return d > np.median(d)
    return pick


def _rejecting_schur():
    """A 12x12 Schur form whose 2x2 blocks at rows 6 and 8 are equal: the
    Sylvester equation of their swap is singular and the swap is
    rejected."""
    n = 12
    rng = np.random.default_rng(19)
    S = np.triu(rng.standard_normal((n, n)))
    for p in (2, 6, 8):
        S[p, p], S[p + 1, p + 1] = 1.0, 1.0
        S[p, p + 1], S[p + 1, p] = 2.0, -0.5
    S[6:8, 8:10] = [[3.0, -1.0], [2.0, 5.0]]
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return S, Q


# name: (n, seed, select(S) -> bool array, window size, mode)
CASES = {
    "small_n8": (8, 8, _median_pick(8), None, "chain"),
    "small_n24": (24, 24, _median_pick(24), None, "chain"),
    "none_selected": (10, 2, lambda S: np.zeros(10, bool), None, "chain"),
    "all_selected": (10, 3, lambda S: np.ones(10, bool), None, "chain"),
    "single_bottom": (16, 5, lambda S: np.arange(16) == 15, None, "chain"),
    "windowed_n96_w24": (96, 7, lambda S: np.random.default_rng(42).random(96) < 0.35,
                         24, "chain"),
    "complex_pairs_n48_w16": (48, 11, lambda S: np.arange(48) >= 24, 16, "chain"),
    "parallel_n96_w24": (96, 31, lambda S: np.random.default_rng(5).random(96) < 0.3,
                         24, "parallel"),
}


def _run_both(S0, Q0, select, W, mode):
    jfn = jreorder.reorder_schur if mode == "chain" else jreorder.reorder_schur_parallel
    tfn = treorder.reorder_schur if mode == "chain" else treorder.reorder_schur_parallel
    jconf = None if W is None else JReorderConf(window_size=W)
    tconf = None if W is None else ReorderConf(window_size=W)
    Sj, Qj, mj, infoj = jfn(S0, Q0, select, jconf)
    stats = {}
    St, Qt, mt, infot = tfn(from_numpy(S0), from_numpy(Q0), select, tconf,
                            stats=stats)
    return (np.asarray(Sj), np.asarray(Qj), mj, int(infoj)), \
        (to_numpy(St), to_numpy(Qt), mt, int(infot)), stats


def _check_agree(j, t, S0):
    (Sj, Qj, mj, ij), (St, Qt, mt, it) = j, t
    assert (mt, it) == (mj, ij)
    tol = 1e-12 * np.linalg.norm(S0)
    np.testing.assert_allclose(St, Sj, rtol=0, atol=tol)
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_reorder_schur(case):
    n, seed, pick, W, mode = CASES[case]
    S0, Q0, H = _schur(n, seed)
    select = pick(S0)
    j, t, stats = _run_both(S0, Q0, select, W, mode)
    _check_agree(j, t, S0)
    St, Qt, m, info = t
    assert info == Error.SUCCESS
    assert schur_structure_error(St) == 0.0
    assert residual_sep(H, St, Qt) < GATE and orthogonality(Qt) < GATE
    want = treorder._align_select(np.concatenate([np.diagonal(S0, -1), [0.0]]),
                                  select)
    assert m == int(want.sum())
    if case in ("none_selected", "all_selected"):
        np.testing.assert_array_equal(St, S0)
        assert stats.get("swaps", 0) == 0
    if mode == "parallel":
        assert stats["passes"] > 0 and stats["swaps"] > 0


def test_reorder_rejected_swap_is_partial():
    S0, Q0 = _rejecting_schur()
    select = np.arange(12) == 8                     # the lower equal block
    j, t, stats = _run_both(S0, Q0, select, None, "chain")
    _check_agree(j, t, S0)
    St, Qt, m, info = t
    assert info == Error.PARTIAL_REORDERING
    assert stats["failed_swaps"] == 1
    assert np.isfinite(St).all() and schur_structure_error(St) == 0.0
    A = Q0 @ S0 @ Q0.T
    assert residual_sep(A, St, Qt) < GATE and orthogonality(Qt) < GATE


def _bubble_window(W, seed):
    S0, _, _ = _schur(W, seed)
    sel = treorder._align_select(np.concatenate([np.diagonal(S0, -1), [0.0]]),
                                 np.random.default_rng(seed).random(W) < 0.5)
    return S0, sel


# name: (window, seed, dst0, dst_limit, wlim); dst0 is a block start, as
# the reorder routines place it
BUBBLE_CASES = {"free": (16, 3, 0, 16, 16), "capped": (16, 3, 0, 5, 16),
                "frozen_edges": (20, 4, 1, 20, 19), "late_start": (24, 9, 7, 24, 24)}


@pytest.mark.parametrize("case", list(BUBBLE_CASES))
def test_window_bubble(case):
    W, seed, dst0, dst_limit, wlim = BUBBLE_CASES[case]
    Tw, sel = _bubble_window(W, seed)
    Tj, Qj, selj, dstj, nfj = jreorder._window_bubble(
        jnp.asarray(Tw), jnp.asarray(sel), dst0, dst_limit, wlim)
    Tt, Qt, selt, dstt, nft, nsw = treorder._window_bubble(
        from_numpy(Tw), sel, dst0, dst_limit, wlim)
    assert (dstt, nft) == (int(dstj), int(nfj))
    np.testing.assert_array_equal(selt, np.asarray(selj))
    np.testing.assert_allclose(to_numpy(Tt), np.asarray(Tj), rtol=0,
                               atol=1e-12 * np.linalg.norm(Tw))
    np.testing.assert_allclose(to_numpy(Qt), np.asarray(Qj), rtol=0, atol=1e-12)
    assert nsw > 0


def test_window_bubble_rejected_swap():
    S0, _ = _rejecting_schur()
    sel = np.arange(12) >= 8
    Tj, Qj, selj, dstj, nfj = jreorder._window_bubble(
        jnp.asarray(S0), jnp.asarray(sel), 0, 12, 12)
    Tt, Qt, selt, dstt, nft, _ = treorder._window_bubble(from_numpy(S0), sel, 0, 12, 12)
    assert nft == int(nfj) >= 1 and dstt == int(dstj)
    np.testing.assert_array_equal(selt, np.asarray(selj))
    np.testing.assert_allclose(to_numpy(Tt), np.asarray(Tj), rtol=0,
                               atol=1e-12 * np.linalg.norm(S0))


def test_window_bubble_batch_cpu_is_per_window():
    wins = [_bubble_window(16, s) for s in (3, 5, 6)]
    Tws = from_numpy(np.stack([w[0] for w in wins]))
    sels = np.stack([w[1] for w in wins])
    out = treorder.window_bubble_batch(Tws, sels, [0, 1, 0], [16, 16, 4],
                                       [16, 15, 16])
    for g, (dst0, lim, wl) in enumerate(((0, 16, 16), (1, 16, 15), (0, 4, 16))):
        one = treorder._window_bubble(Tws[g], sels[g], dst0, lim, wl)
        assert torch.equal(out[0][g], one[0]) and torch.equal(out[1][g], one[1])
        np.testing.assert_array_equal(out[2][g], one[2])
        assert (out[3][g], out[4][g], out[5][g]) == one[3:]
