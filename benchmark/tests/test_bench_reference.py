"""The generators repeat per seed; the judge passes a correct planted result
and fails a perturbed one."""

import math

import numpy as np
import pytest
import torch

from harness import spec
from reference import generators, judge

LIMITS = spec.config("gep_known_n2000")["limits"]
SEP_LIMITS = spec.config("sep_random_n4000")["limits"]


def _orthogonal(n, seed):
    g = torch.Generator().manual_seed(seed)
    return generators.random_orthogonal(n, g, "cpu")


@pytest.mark.parametrize("name", ["sep_random_n4000", "gep_known_n2000"])
def test_generators_repeat_per_seed(name):
    conf = dict(spec.config(name), n=30)
    a = generators.make_inputs(conf, generators.problem_seed(2 ** 40 + 3, 5), "cpu")
    b = generators.make_inputs(conf, generators.problem_seed(2 ** 40 + 3, 5), "cpu")
    c = generators.make_inputs(conf, generators.problem_seed(2 ** 40 + 3, 6), "cpu")
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert a[k].dtype == torch.float64 and a[k].shape == (30, 30)
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])


def test_problem_seeds_distinct():
    seeds = {generators.problem_seed(s, k) for s in (0, 1, 2 ** 31 + 5, 2 ** 62)
             for k in range(-1, 50)}
    assert len(seeds) == 4 * 51
    assert all(0 <= s < 2 ** 63 for s in seeds)


def test_planted_pencil():
    conf = dict(spec.config("gep_known_n2000"), n=200)
    g = torch.Generator().manual_seed(11)
    S, T, alpha, beta = generators.schur_pencil(conf, g, "cpu")
    start = generators.block_pattern(np.zeros(4), 0.5)
    assert start.tolist() == [True, False, True, False]
    a, b, st = judge.block_eigenvalues(S, T)
    al, be = alpha.numpy(), beta.numpy()
    d = np.abs(a * be - al * b) / np.sqrt((np.abs(a) ** 2 + b ** 2) * (np.abs(al) ** 2 + be ** 2))
    assert d.max() < 1e-14
    assert 0 < int((beta == 0).sum()) < 60 and 40 < int(st.sum()) < 100
    assert judge.structure_gep(S, T) == 0.0


def _sep_case(n=24, seed=3):
    conf = dict(spec.config("gep_known_n2000"), n=n, inf_ratio=0.0)
    S, _T, _a, _b = generators.schur_pencil(conf, torch.Generator().manual_seed(seed), "cpu")
    Q = _orthogonal(n, seed + 1)
    er, ei = [torch.as_tensor(x) for x in (lambda a: (a.real, a.imag))(
        judge.block_eigenvalues(S)[0])]
    return {"A": Q @ S @ Q.T}, {"S": S, "Q": Q, "eig_real": er, "eig_imag": ei, "info": 0}


def test_judge_passes_planted_sep():
    inputs, out = _sep_case()
    nums = judge.judge("sep", inputs, out)
    assert judge.failures(nums, SEP_LIMITS) == []
    assert nums["structure"] == 0.0 and nums["eigenvalue_u"] < 10


@pytest.mark.parametrize("fault,fails", [
    ("entry", "residual_u"), ("below", "structure"), ("eigenvalue", "eigenvalue_u"),
    ("q", "orthogonality_u"), ("info", "info"), ("nan", "residual_u")])
def test_judge_fails_perturbed_sep(fault, fails):
    inputs, out = _sep_case()
    if fault == "entry":
        out["S"][0, -1] += 1e-9
    elif fault == "below":
        out["S"][-1, 0] = 1e-300
    elif fault == "eigenvalue":
        out["eig_real"][3] += 1e-6           # a float32 rounding of it
    elif fault == "q":
        out["Q"] = out["Q"] * (1 + 1e-10)
    elif fault == "info":
        out["info"] = 5
    else:
        out["S"][2, 5] = math.nan
    assert fails in judge.failures(judge.judge("sep", inputs, out), SEP_LIMITS)


def _gep_chain_case(n=30, m=12, seed=4):
    """A generalized Schur pair whose leading m rows hold exactly the
    eigenvalues with beta > 0 and Re > 0 (selection 'finite_right_half'),
    a complex pair on each side of m, with the leading block's eigenvectors
    from numpy."""
    rng = np.random.default_rng(seed)
    S = np.triu(rng.standard_normal((n, n))) / np.sqrt(n)
    T = np.triu(rng.standard_normal((n, n))) / np.sqrt(n)
    d = np.abs(rng.standard_normal(n)) + 0.5
    np.fill_diagonal(S, np.where(np.arange(n) < m, d, -d))
    np.fill_diagonal(T, np.abs(rng.standard_normal(n)) + 0.5)
    for r, re in ((2, 1.0), (20, -1.0)):
        S[r:r + 2, r:r + 2] = [[re, 2.0], [-0.5, re]]
        T[r:r + 2, r:r + 2] = np.eye(2)
    w, V = np.linalg.eig(np.linalg.solve(T[:m, :m], S[:m, :m]))
    S, T = torch.as_tensor(S), torch.as_tensor(T)
    a, b, start = judge.block_eigenvalues(S, T)
    Y = np.zeros((n, m))
    i = 0
    while i < m:
        j = int(np.argmin(np.abs(w - a[i] / b[i])))
        Y[:m, i] = V[:, j].real
        if start[i]:
            Y[:m, i + 1] = V[:, j].imag
            i += 2
        else:
            i += 1
    Q, Z = _orthogonal(n, seed + 1), _orthogonal(n, seed + 2)
    inputs = {"A": Q @ S @ Z.T, "B": Q @ T @ Z.T}
    return inputs, {"S": S, "T": T, "Q": Q, "Z": Z, "m": m, "info": 0, "reorder_info": 0,
                    "X": Z @ torch.as_tensor(Y)}


def test_judge_passes_planted_gep_chain():
    inputs, out = _gep_chain_case()
    nums = judge.judge("gep", inputs, out, "finite_right_half")
    assert judge.failures(nums, LIMITS) == [], nums
    assert out["m"] > 4


@pytest.mark.parametrize("fault,fails", [
    ("m", "misplaced"), ("x", "eigenvector_u"), ("t", "structure"), ("b", "residual_u")])
def test_judge_fails_perturbed_gep_chain(fault, fails):
    inputs, out = _gep_chain_case()
    if fault == "m":
        out["m"] -= 1
    elif fault == "x":
        out["X"][0, 0] += 1e-6
    elif fault == "t":
        out["T"][5, 2] = 1e-20
    else:
        inputs["B"] = inputs["B"] * (1 + 1e-12)
    assert fails in judge.failures(judge.judge("gep", inputs, out, "finite_right_half"),
                                   LIMITS)


def test_band_leaves_rounding_undecided():
    """Re(lambda) within rounding of 0, and an eigenvalue so large that it
    is an infinite one rounding left finite, may sit on either side of m;
    an infinite eigenvalue, its beta 0 or a rounding of 0, may not sit
    inside it."""
    alpha = np.array([1.0, 1e-12 + 1j, -1e-12 + 1j, 2.0, -1.0, 2.0, 2.0], complex)
    beta = np.array([1.0, 1.0, 1.0, 1e-8, 1.0, 1e-18, 0.0])
    start = np.zeros(7, bool)
    for m in (1, 2, 3, 4):
        assert judge.misplaced(alpha, beta, start, m, "finite_right_half", 1.0, 1.0) == 0
    assert judge.misplaced(alpha, beta, start, 0, "finite_right_half", 1.0, 1.0) == 1
    assert judge.misplaced(alpha, beta, start, 5, "finite_right_half", 1.0, 1.0) == 1
    assert judge.misplaced(alpha, beta, start, 7, "finite_right_half", 1.0, 1.0) == 3
    # the size is read in the pencil's own scale
    assert judge.misplaced(alpha, beta, start, 0, "finite_right_half", 1.0, 1e-6) == 2


@pytest.mark.parametrize("beta", [0.0, 1e-18])
@pytest.mark.parametrize("row", [3, 25])
def test_infinite_row_judged_by_place(beta, row):
    """A planted pencil with one infinite eigenvalue whose alpha has Re > 0:
    correct below the leading m = 12 rows, misplaced inside them."""
    n, m = 30, 12
    rng = np.random.default_rng(9)
    S = np.triu(rng.standard_normal((n, n))) / np.sqrt(n)
    T = np.triu(rng.standard_normal((n, n))) / np.sqrt(n)
    d = np.abs(rng.standard_normal(n)) + 0.5
    np.fill_diagonal(S, np.where(np.arange(n) < m, d, -d))
    np.fill_diagonal(T, np.abs(rng.standard_normal(n)) + 0.5)
    S[row, row], T[row, row] = d[row], beta
    S, T = torch.as_tensor(S), torch.as_tensor(T)
    Q, Z = _orthogonal(n, 10), _orthogonal(n, 11)
    inputs = {"A": Q @ S @ Z.T, "B": Q @ T @ Z.T}
    out = {"S": S, "T": T, "Q": Q, "Z": Z, "m": m, "info": 0, "reorder_info": 0}
    nums = judge.judge("gep", inputs, out, "finite_right_half")
    assert judge.failures(nums, LIMITS) == ([] if row >= m else ["misplaced"]), nums


def test_infinite_eigenvalue_backward_error():
    S = torch.tensor([[2.0, 1.0], [0.0, 3.0]], dtype=torch.float64)
    T = torch.tensor([[0.0, 1.0], [0.0, 1.5]], dtype=torch.float64)
    start = np.zeros(2, bool)
    assert judge.eigenvalue_error(S, T, start, np.array([2.0, 3.0]), np.array([0.0, 1.5])) == 0
    assert judge.eigenvalue_error(S, T, start, np.array([2.0, 3.0]), np.array([1e-6, 1.5])) > 1e6
