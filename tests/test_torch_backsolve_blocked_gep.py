"""Kernel E2's blocked schedule, modelled in plain PyTorch
(``starneig_tpu_torch.testing.backsolve_blocked.backsolve_blocked_gep``),
against the JAX package's batched GEP backsolve
``starneig_tpu.ops.eigenvectors._backsolve_all_gep`` (CPU).

The model runs the kernel's order: groups of eigenvalues sorted by pos,
row blocks from each group's top down, the far products of S and T of a
block combined into M x = (beta S - alpha T) x before its near chain, a
rescale carried to the block's precomputed right-hand sides, and the
twin's guarded solve (``_solve_row_gep``).  Only the summation order
differs from JAX's row loop, so the unit-norm vectors agree within 1e-12
elementwise and the close flags are equal, on
``tests/test_torch_gep_eigenvectors.py``'s twin cases (every eigenvalue, a
subset, infinite eigenvalues, a rescale, a lifted diagonal), at the
kernel's block (64 rows, 8 eigenvalues) and at small blocks that cut
these small pencils into many row blocks.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.ops.eigenvectors import _backsolve_all_gep as j_backsolve_gep
from starneig_tpu.ops.hess_triangular import hessenberg_triangular
from starneig_tpu.ops.qz import small_qz
from starneig_tpu.testing import known_spectrum_pencil, random_dense
from starneig_tpu_torch.ops import eigenvectors as ev
from starneig_tpu_torch.testing import backsolve_blocked as bb
from starneig_tpu_torch.testing import generators

torch.set_num_threads(1)

CASES = ["all", "subset", "infinite", "growth", "close"]


@functools.lru_cache(maxsize=None)
def _case(case):
    """(S, T, select): tests/test_torch_gep_eigenvectors.py:_twin_case (the
    three pencils reduced by JAX's HT and QZ, the growth and close
    pencils)."""
    if case == "growth":
        return generators.growth_pencil()
    if case == "close":
        return generators.close_pencil()
    n, seed, kw = {"all": (24, 1, {}), "subset": (32, 5, {}),
                   "infinite": (20, 9, dict(complex_ratio=0.2, inf_ratio=0.2))}[case]
    if kw:
        A, B, _alpha, _beta = known_spectrum_pencil(n, seed=seed, **kw)
    else:
        A = random_dense(n, seed=seed)
        B = random_dense(n, seed=seed + 77) + 3 * np.eye(n)
    H, T, Q, Z = hessenberg_triangular(A, B)
    S, Tt, _Q, _Z, info = small_qz(H, T, Q, Z, n)
    assert int(info) == 0
    sel = (np.random.default_rng(0).random(n) < 0.4) if case == "subset" \
        else np.ones(n, bool)
    return np.asarray(S), np.asarray(Tt), sel


def _inputs(case):
    S_np, T_np, sel = _case(case)
    S, T = torch.as_tensor(np.array(S_np)), torch.as_tensor(np.array(T_np))
    pos, pair, ar, ai, bt = (list(x) for x in zip(*ev._selected_blocks_gep(S, T, sel)))
    ar, ai, bt = (torch.tensor(v, dtype=S.dtype) for v in (ar, ai, bt))
    return S, T, ar, ai, bt, pos, pair


def _jax(S, T, ar, ai, bt, pos, pair):
    """JAX's call, padded as its eigenvectors_schur_gep pads."""
    m = len(pos)
    pad = max(8, -(-m // 8) * 8) - m
    xr, xi, close = j_backsolve_gep(
        jnp.asarray(S.numpy()), jnp.asarray(T.numpy()),
        jnp.asarray(ar.tolist() + [0.0] * pad), jnp.asarray(ai.tolist() + [0.0] * pad),
        jnp.asarray(bt.tolist() + [1.0] * pad), jnp.asarray(pos + [0] * pad, jnp.int32),
        jnp.asarray(pair + [False] * pad), jnp.asarray([True] * m + [False] * pad))
    return np.asarray(xr)[:m], np.asarray(xi)[:m], np.asarray(close)[:m]


def _model(S, T, ar, ai, bt, pos, pair, nb, group):
    kind, smin, omega, smlnum, xr, xi = ev._backsolve_inputs_gep(S, T, ar, ai, bt, pos, pair)
    close = bb.backsolve_blocked_gep(S, T, ar, ai, bt, pos, pair, kind, smin, omega, smlnum,
                                     xr, xi, nb=nb, group=group)
    gr, gi = ev._normalize(xr, xi)
    return gr.numpy(), gi.numpy(), close.numpy()


def _agree(model, jax_out):
    mr, mi, mc = model
    jr, ji, jc = jax_out
    np.testing.assert_array_equal(mc, jc)
    assert np.isfinite(mr).all() and np.isfinite(mi).all()
    np.testing.assert_allclose(mr, jr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mi, ji, rtol=0, atol=1e-12)


@pytest.mark.parametrize("nb,group", [(bb.NB, bb.GROUP), (5, 8), (4, 3), (2, 1)])
@pytest.mark.parametrize("case", CASES)
def test_blocked_gep_matches_jax(case, nb, group):
    args = _inputs(case)
    model = _model(*args, nb, group)
    _agree(model, _jax(*args))
    pair = args[-1]
    assert not any(model[1][j].any() for j in range(len(pair)) if not pair[j])  # real: xi 0
    if case == "close":
        assert model[2].any()
    if case == "infinite":
        assert bool((args[4] == 0).any())


def test_blocked_gep_rescale_fires(monkeypatch):
    """growth: the model scales its vectors and the right-hand sides still
    to come (fac < 1) inside a row block, and still matches JAX."""
    facs = []
    solve = bb._solve_row_gep

    def spy(*args):
        out = solve(*args)
        facs.append(float(out[0].min()))
        return out
    monkeypatch.setattr(bb, "_solve_row_gep", spy)
    args = _inputs("growth")
    model = _model(*args, 8, 8)
    assert min(facs) < 1e-50
    _agree(model, _jax(*args))


@pytest.mark.parametrize("nb", [3, 5, 9])
def test_blocked_gep_pair_at_block_edge(nb):
    """A 2x2 block where a row block's boundary falls: the boundary moves
    one row, the pair is solved whole in the block below it, and the
    vectors still match JAX."""
    args = _inputs("all")
    S, pos = args[0], args[5]
    kind = ev._row_kinds(np.concatenate([torch.diagonal(S, -1).numpy(), [0.0]]))
    blocks = bb.row_blocks(max(pos), kind, nb)
    moved = [r0 for r0, r1 in blocks if r1 - r0 == nb - 1 and kind[r0 - 1] == 2]
    assert moved, f"no pair at a block edge for nb={nb}"
    assert all(kind[r0] != 2 for r0, _r1 in blocks)
    _agree(_model(*args, nb, 8), _jax(*args))
