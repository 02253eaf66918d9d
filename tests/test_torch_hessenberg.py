"""The port's blocked Hessenberg reduction against the JAX package's XLA
path, on the same seeded matrices (CPU, float64).

Tolerances: one panel elementwise to 1e-12 (a few dozen dependent
matrix-vector products); a whole reduction elementwise to 1e-11 ||A||
(the trailing GEMMs sum in another order than XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.config import HessenbergConf as JConf
from starneig_tpu.ops import hessenberg as jhess
from starneig_tpu_torch.config import HessenbergConf
from starneig_tpu_torch.convert import conf_from_jax, from_numpy, to_numpy
from starneig_tpu_torch.ops import hessenberg as thess

torch.set_num_threads(1)


@pytest.mark.parametrize("k,t0", [(0, 0), (16, 8)])
def test_panel(k, t0):
    n, nb = 64, 16
    A = np.random.default_rng(k).standard_normal((n, n))
    want = jhess._panel(jnp.asarray(A), k, nb, t0, jnp.int32(n))
    got = thess._panel(from_numpy(A), k, nb, t0, n)
    for name, g, w in zip("VTYP", got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                   atol=1e-12, err_msg=name)


# (n, k, nb, t0, end): a width that is no multiple of 32; an end inside
# the panel (columns from end - 1 on are not reduced); a trailing bucket
# t0 > 0 with a panel of 24
PANEL_CASES = {"nb24": (64, 0, 24, 0, None), "end_inside": (64, 16, 16, 8, 26),
               "t0": (80, 40, 24, 32, None)}


@pytest.mark.parametrize("case", list(PANEL_CASES))
def test_panel_cases(case):
    n, k, nb, t0, end = PANEL_CASES[case]
    A = np.random.default_rng(n + k).standard_normal((n, n))
    want = jhess._panel(jnp.asarray(A), k, nb, t0, jnp.int32(n if end is None else end))
    got = thess._panel(from_numpy(A), k, nb, t0, end)
    for name, g, w in zip("VTYP", got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                   atol=1e-12, err_msg=name)
    if end is not None:
        # the columns past the range keep their corrected values: tau = 0
        tau = np.diagonal(to_numpy(got[1]))
        assert (tau[end - 1 - k:] == 0).all() and (tau[:end - 1 - k] != 0).all()


def test_panel_overlap_is_noop():
    """The overlapping last panel (k = n - nb, hessenberg's k_eff) re-reduces
    columns that earlier panels reduced: their reflectors are degenerate
    (tau = 0, v = e_{c+1}), they add nothing to T and Y, and their panel
    values come back bit for bit."""
    n, nb = 64, 24
    A = from_numpy(np.random.default_rng(11).standard_normal((n, n)))
    Q = torch.eye(n, dtype=torch.float64)
    for k in (0, nb):
        thess._apply_panel(A, Q, *thess._panel(A, k, nb, 0, n), k, 0)
    k, done = n - nb, 2 * nb - (n - nb)       # columns 40..47 already reduced
    A_np = to_numpy(A)
    want = jhess._panel(jnp.asarray(A_np), k, nb, 0, jnp.int32(n))
    V, T, Y, P = map(to_numpy, thess._panel(A, k, nb, 0, n))
    for name, g, w in zip("VTYP", (V, T, Y, P), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-12, err_msg=name)
    assert (T[:, :done] == 0).all() and (T[:done] == 0).all()
    assert (Y[:, :done] == 0).all()
    np.testing.assert_array_equal(V[:, :done], np.eye(n)[:, k + 1:k + 1 + done])
    np.testing.assert_array_equal(P[:, :done], A_np[:, k:k + done])


@pytest.mark.parametrize("end", [None, 90])
def test_hessenberg(end):
    n = 150
    A = np.random.default_rng(7).standard_normal((n, n))
    conf = JConf(panel_width=16)          # several panels and t0 buckets
    Hj, Qj = map(np.asarray, jhess.hessenberg(jnp.asarray(A), conf=conf,
                                              end=end))
    Ht, Qt = map(to_numpy, thess.hessenberg(from_numpy(A),
                                            conf=conf_from_jax(conf), end=end))
    na = np.linalg.norm(A)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-11 * na)
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-11)
    # exact structure of the reduced columns, and a similarity
    lim = n if end is None else end - 2
    assert np.abs(np.tril(Ht[:, :lim], -2)).max() == 0.0
    u = np.finfo(np.float64).eps / 2
    assert np.linalg.norm(Qt @ Ht @ Qt.T - A) / na / u < 500


def test_hessenberg_begin_and_initial_q():
    # a partial range [begin, end) on a matrix already reduced in its
    # leading columns, accumulated onto a given Q
    n = 96
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n))
    A[20:, :19] = 0.0                     # Hessenberg in columns < begin
    Q0, _ = np.linalg.qr(rng.standard_normal((n, n)))
    conf = JConf(panel_width=16)
    Hj, Qj = map(np.asarray, jhess.hessenberg(
        jnp.asarray(A), jnp.asarray(Q0), conf=conf, begin=19, end=80))
    Ht, Qt = map(to_numpy, thess.hessenberg(
        from_numpy(A), from_numpy(Q0), conf=conf_from_jax(conf), begin=19,
        end=80))
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-11 * np.linalg.norm(A))
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-11)


def test_hessenberg_wide_panel():
    # a panel wider than n / 2: the second panel overlaps the first
    # (k_eff = n - nb), re-reducing its last columns as an exact no-op
    n = 40
    A = np.random.default_rng(5).standard_normal((n, n))
    conf = JConf(panel_width=24)
    Hj, Qj = map(np.asarray, jhess.hessenberg(jnp.asarray(A), conf=conf))
    Ht, Qt = map(to_numpy, thess.hessenberg(from_numpy(A), conf=conf_from_jax(conf)))
    na = np.linalg.norm(A)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-11 * na)
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-11)
    assert np.abs(np.tril(Ht, -2)).max() == 0.0
    u = np.finfo(np.float64).eps / 2
    assert np.linalg.norm(Qt @ Ht @ Qt.T - A) / na / u < 500


# panel_plan (kernel H1's layout of the frozen A[t0:, cs0:]) at the main
# path's panels: n = 4000's first and its k = t0 = 2016 panel (nb = 288),
# and n = 10,000's first and a middle one (nb = 464), on 132 blocks
PLAN_CASES = [(4000, 0, 288, 0), (4000, 2016, 288, 2016), (10000, 0, 464, 0),
              (10000, 4640, 464, 4624), (4000, 3712, 288, 3528)]


@pytest.mark.parametrize("n,k,nb,t0", PLAN_CASES)
def test_panel_plan(n, k, nb, t0):
    """Each slab's resident columns, v and the scratch fit in 227 KB; the
    resident and streamed columns cover A[t0:, cs0:] exactly once, at even
    column bounds; all of v from cs0 is staged at these sizes."""
    gh = thess.gpu_hess
    plan = gh.panel_plan(n, k, nb, t0, 132)
    rows = n - t0
    assert plan.rpb * 132 >= rows
    assert plan.smem_bytes <= gh.H100_SMEM == 227 * 1024
    ws = plan.res_cols + (plan.res_cols & 1)
    assert plan.smem_bytes == 8 * (gh._fixed_doubles(n - plan.vs, nb, plan.rpb) + plan.rpb * ws)
    assert plan.cs0 == (k + 1) & ~1 == plan.vs
    assert plan.cs0 <= plan.gend <= n and plan.gend % 2 == 0
    assert plan.gend == n - plan.res_cols
    parts = (plan.resident_bytes, plan.streamed_bytes)
    assert min(parts) >= 0 and sum(parts) == 8 * rows * (n - plan.cs0)
    assert plan.streamed_bytes == 8 * rows * (plan.gend - plan.cs0)
    assert plan.res_cols > 0


@pytest.mark.parametrize("n,k,t0", [(4000, 2160, 2160), (4000, 2448, 2016), (1848, 0, 0),
                                    (1000, 0, 0), (300, 8, 0)])
def test_panel_plan_on_chip(n, k, t0):
    """Up to n - cs0 of about 1,850 columns (nb = 288, 132 blocks) the
    whole trailing block stays in shared memory beside v: nothing is
    streamed; above it, some is."""
    gh = thess.gpu_hess
    plan = gh.panel_plan(n, k, 288, t0, 132)
    assert plan.streamed_bytes == 0 and plan.gend == plan.cs0
    assert plan.resident_bytes == 8 * (n - t0) * (n - plan.cs0)
    assert gh.panel_plan(4000, 2016, 288, 2016, 132).streamed_bytes > 0
    assert gh.panel_plan(1850, 0, 288, 0, 132).streamed_bytes > 0


def test_panel_plan_caps():
    """A small shared-memory budget pushes the plan's columns to the
    stream, and a smaller one v's left entries to L2; a budget that holds
    not even the scratch is refused."""
    gh = thess.gpu_hess
    full = gh.panel_plan(1000, 0, 288, 0, 132)
    assert full.streamed_bytes == 0 and full.res_cols == 1000 and full.vs == 0
    small = gh.panel_plan(1000, 0, 288, 0, 132, smem_budget=40_000)
    assert 0 < small.res_cols < 1000 and small.streamed_bytes > 0 and small.vs == 0
    assert small.smem_bytes <= 40_000
    odd = gh.panel_plan(999, 0, 24, 0, 132, smem_budget=30_000)
    assert odd.gend % 2 == 0 and odd.smem_bytes <= 30_000
    assert odd.resident_bytes + odd.streamed_bytes == 8 * 999 * 999
    part = gh.panel_plan(1000, 0, 288, 0, 132, smem_budget=12_000)
    assert part.res_cols == 0 and part.gend == 1000 and 0 < part.vs < 1000
    assert part.smem_bytes <= 12_000 and part.streamed_bytes == 8 * 1000 * 1000
    with pytest.raises(ValueError, match="panel_plan"):
        gh.panel_plan(4000, 0, 288, 0, 132, smem_budget=3_000)


@pytest.mark.parametrize("n", [30000, 40000])
def test_panel_plan_large_n(n):
    """Past n of about 27,000 all of v no longer fits a block's shared
    memory beside the scratch: the plan stages v's right-most entries
    (v's others come from L2), keeps no columns and still fits, at the
    auto panel width of hessenberg's first panel."""
    gh = thess.gpu_hess
    nb = HessenbergConf().resolve(n).panel_width
    plan = gh.panel_plan(n, 0, nb, 0, 132)
    assert plan.smem_bytes <= gh.H100_SMEM
    assert plan.res_cols == 0 and plan.gend == n and plan.streamed_bytes == 8 * n * n
    assert 0 < plan.vs < n and plan.vs % 2 == 0
    # the staged entries fill what the scratch leaves, to a pair
    assert gh.H100_SMEM - plan.smem_bytes < 16
