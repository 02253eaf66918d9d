"""Kernel E1's blocked schedule, modelled in plain PyTorch
(``starneig_tpu_torch.testing.backsolve_blocked``), against the JAX
package's batched backsolve ``starneig_tpu.ops.eigenvectors._backsolve_all``
(CPU).

The model runs the kernel's order: groups of eigenvalues sorted by pos,
row blocks from each group's top down, the far product of a block before
its near chain, a rescale carried to the block's precomputed right-hand
sides.  Only the summation order differs from JAX's row loop, so the
unit-norm vectors agree within 1e-12 elementwise and the close flags are
equal, on ``tests/test_torch_eigenvectors.py``'s cases, at the kernel's
block (64 rows, 8 eigenvalues) and at small blocks that cut these small
matrices into many row blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops.eigenvectors import _backsolve_all as jbacksolve
from starneig_tpu.ops.small_schur import small_schur as jsmall
from starneig_tpu.testing import random_hessenberg
from starneig_tpu_torch.ops import eigenvectors as ev
from starneig_tpu_torch.testing import backsolve_blocked as bb
from starneig_tpu_torch.testing import generators

torch.set_num_threads(1)


def _schur(n, seed):
    H = random_hessenberg(n, seed=seed)
    S, _Q, info = jsmall(jnp.array(H), jnp.eye(n), n)
    assert int(info) == 0
    return np.asarray(S)


CASES = {
    "all_selected": lambda: (_schur(32, 1), np.ones(32, bool)),
    "subset_with_pairs": lambda: (_schur(40, 2), np.random.default_rng(41).random(40) < 0.3),
    "graded": generators.graded_schur,
    "close_eigenvalues": lambda: generators.close_schur(False),
    "distinct_eigenvalues": lambda: generators.close_schur(True),
    "growth": generators.growth_schur,
}


def _inputs(S_np, sel):
    S = torch.as_tensor(np.array(S_np))
    pos, pair, lr, li = (list(x) for x in zip(*ev._selected_blocks(S, sel)))
    lam_r, lam_i = (torch.tensor(v, dtype=S.dtype) for v in (lr, li))
    return S, pos, pair, lam_r, lam_i


def _jax(S, pos, pair, lam_r, lam_i):
    m = len(pos)
    xr, xi, close = jbacksolve(jnp.asarray(S.numpy()), jnp.asarray(lam_r.numpy()),
                               jnp.asarray(lam_i.numpy()), jnp.asarray(pos),
                               jnp.asarray(pair), jnp.ones(m, bool))
    return np.asarray(xr), np.asarray(xi), np.asarray(close)


def _model(S, pos, pair, lam_r, lam_i, nb, group):
    kind, smin, omega, smlnum, xr, xi = ev._backsolve_inputs(S, lam_r, lam_i, pos, pair)
    close = bb.backsolve_blocked(S, lam_r, lam_i, pos, pair, kind, smin, omega, smlnum,
                                 xr, xi, nb=nb, group=group)
    gr, gi = ev._normalize(xr, xi)
    return gr.numpy(), gi.numpy(), close.numpy(), kind


@pytest.mark.parametrize("nb,group", [(bb.NB, bb.GROUP), (5, 8), (4, 3), (2, 1)])
@pytest.mark.parametrize("case", list(CASES))
def test_blocked_matches_jax(case, nb, group):
    S_np, sel = CASES[case]()
    S, pos, pair, lam_r, lam_i = _inputs(S_np, sel)
    jr, ji, jc = _jax(S, pos, pair, lam_r, lam_i)
    mr, mi, mc, _kind = _model(S, pos, pair, lam_r, lam_i, nb, group)
    np.testing.assert_array_equal(mc, jc)
    assert np.isfinite(mr).all() and np.isfinite(mi).all()
    np.testing.assert_allclose(mr, jr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mi, ji, rtol=0, atol=1e-12)
    if case == "close_eigenvalues":
        assert mc.any()


def test_blocked_rescale_fires(monkeypatch):
    """growth: the model scales its vectors and the right-hand sides still
    to come (fac < 1) inside a row block, and still matches JAX."""
    facs = []
    solve = bb._solve_row

    def spy(*args):
        out = solve(*args)
        facs.append(float(out[0].min()))
        return out
    monkeypatch.setattr(bb, "_solve_row", spy)
    S, pos, pair, lam_r, lam_i = _inputs(*generators.growth_schur())
    jr, ji, jc = _jax(S, pos, pair, lam_r, lam_i)
    mr, mi, mc, _kind = _model(S, pos, pair, lam_r, lam_i, 8, 8)
    assert min(facs) < 1e-50
    np.testing.assert_array_equal(mc, jc)
    np.testing.assert_allclose(mr, jr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mi, ji, rtol=0, atol=1e-12)


@pytest.mark.parametrize("nb", [3, 4, 9])
def test_blocked_pair_at_block_edge(nb):
    """A 2x2 block where a row block's boundary falls: the boundary moves up
    one row, the pair is solved whole in the block below it, and the
    vectors still match JAX."""
    S, pos, pair, lam_r, lam_i = _inputs(_schur(40, 2), np.ones(40, bool))
    kind = ev._row_kinds(np.concatenate([torch.diagonal(S, -1).numpy(), [0.0]]))
    top = max(pos)
    blocks = bb.row_blocks(top, kind, nb)
    moved = [r0 for r0, r1 in blocks if r1 - r0 == nb - 1 and kind[r0 - 1] == 2]
    assert moved, f"no pair at a block edge for nb={nb}"
    assert all(kind[r0] != 2 for r0, _r1 in blocks)
    jr, ji, jc = _jax(S, pos, pair, lam_r, lam_i)
    mr, mi, mc, _kind = _model(S, pos, pair, lam_r, lam_i, nb, 8)
    np.testing.assert_array_equal(mc, jc)
    np.testing.assert_allclose(mr, jr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mi, ji, rtol=0, atol=1e-12)


def test_row_blocks_cover_rows():
    """The row blocks of a group cover rows 0 .. top - 1 once, top down, at
    most nb rows each."""
    kind = np.array([0, 1, 2, 1, 2, 0, 1, 2, 1, 2, 0, 0])
    for nb in (2, 3, 4, 64):
        blocks = bb.row_blocks(11, kind, nb)
        rows = [r for r0, r1 in blocks for r in range(r1 - 1, r0 - 1, -1)]
        assert rows == list(range(10, -1, -1))
        assert all(1 <= r1 - r0 <= nb for r0, r1 in blocks)
        assert all(kind[r0] != 2 for r0, _r1 in blocks)
