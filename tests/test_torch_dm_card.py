"""The port's DM layer on the card: gloo ranks sharing one CUDA device.

These tests need a CUDA device and nvcc; without a card every test skips
(the kernels have no CPU mode).  They import no JAX, so they run where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_dm_card.py

``sep_dm`` at n=1,200 on 2 ranks: hessenberg, schur, reorder_schur and
eigenvectors on column shards, held to the
reference's gates (info 0, residual and orthogonality < 500 u, exact
standardized Schur form before and after the reordering, the leading
block exactly the eigenvalues with Re > 0, eigenvector residuals < 1e-10),
to the single-process ``sep.schur`` on the card (spectrum within 1e-10
max|lambda|), and to the owner rule: rank 0 launched every kernel of the
path, rank 1 only B1 (on its own columns in the sharded Hessenberg
reduction) and E1 where it solved rows of a selected vector (each rank
that did launched E1 once), and both ranks held the same V and T in every
panel.  Each padded Schur shard holds the columns ``dm_core.pad_cuts``
gives its rank.

``gep_dm`` at n=1,200 on 2 ranks (``known_spectrum_pencil(1200, 0.3, 0.1,
seed 0)``): hessenberg_triangular, schur, reorder_schur and eigenvectors
on column shards, select from the diagonals, held to the same gates, to
the single-process ``gep.schur`` of the chain's HT form on the card
(spectrum within 1e-10 chordal, rounds within 2), to the owner rule (rank
0 launched every window kernel; every rank G1 on its own columns, and E2 where it solved
rows of a selected vector), and with no ``DistrMatrix.full`` call in any
stage and each rank's peak memory there below its shards plus two whole
n x n float64 matrices.
"""

import numpy as np
import pytest
import torch

from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing.dm import run_ranks

U = np.finfo(np.float64).eps
GATE = 500.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def test_sep_dm_chain_two_ranks(cuda):
    from starneig_tpu_torch.api import sep
    n = 1200
    A = np.random.default_rng(1200).standard_normal((n, n))
    r, cnt = run_ranks("starneig_tpu_torch.testing.dm:sep_chain", 2,
                       (A, "positive_real"), device=str(cuda), timeout_s=600)
    assert r["info"] == r["rinfo"] == r["xinfo"] == 0
    for S, Q in ((r["S"], r["Q"]), (r["S2"], r["Q2"])):
        assert hooks.residual_sep(A, S, Q) < GATE
        assert hooks.orthogonality(Q) < GATE
        assert hooks.schur_form_error(torch.as_tensor(S)) == 0.0
    m = r["m"]
    assert m == r["selected"] == int((r["er"] > 0).sum())
    lead_ok, rest = hooks.selected_leading(r["S2"], m, lambda lam: lam.real > 0)
    assert lead_ok and rest == 0
    _S, _Q, er, ei, info = sep.schur(*sep.hessenberg(A, device=cuda), device=cuda)
    single = er.cpu().numpy() + 1j * ei.cpu().numpy()
    assert hooks.eigenvalue_error(r["er"] + 1j * r["ei"], single) * U < 1e-10
    X = r["X"]
    assert X.shape == (n, m)
    assert hooks.eigenvector_residual_sep(A, r["S2"], X, m) < 1e-10
    NP, cuts = cnt[0]["stats"]["schur"]["NP"], cnt[0]["stats"]["schur"]["cuts"]
    for r, c in enumerate(cnt):
        assert c["backend"] == "gloo" and c["device"] == str(cuda)
        assert c["stats"]["schur"]["shard_shape"] == (NP, cuts[r + 1] - cuts[r])
    for k in ("hess_gemv", "francis", "train_hops", "aed_deflate", "recondense",
              "reorder_bubble"):
        assert cnt[0]["launches"][k] > 0, k
    assert cnt[1]["launches"]["hess_gemv"] > 0, cnt[1]["launches"]
    assert not any(v for k, v in cnt[1]["launches"].items()
                   if k not in ("hess_gemv", "eig_backsolve")), cnt[1]["launches"]
    for c in cnt:
        solved = c["stages"]["eigenvectors"]["stats"]["eig_vectors"] > 0
        assert c["launches"]["eig_backsolve"] == int(solved), (c["rank"], c["launches"])
        assert c["stages"]["eigenvectors"]["full_calls"] == 0
    assert len({c["stats"]["hessenberg"]["vt_sha256"] for c in cnt}) == 1


def test_gep_dm_chain_two_ranks(cuda):
    from starneig_tpu_torch.api import gep
    from starneig_tpu_torch.testing.dm import finite_right_half
    from starneig_tpu_torch.testing.generators import known_spectrum_pencil
    n = 1200
    A, B, _a, _b = known_spectrum_pencil(n, complex_ratio=0.3, inf_ratio=0.1, seed=0)
    torch.cuda.empty_cache()
    r, cnt = run_ranks("starneig_tpu_torch.testing.dm:gep_chain", 2,
                       (A, B, "finite_right_half"), device=str(cuda), timeout_s=900)
    assert r["info"] == 0 and r["rinfo"] == 0
    for stage in ("schur", "reorder"):
        M = r[stage]
        ra, rb, oq, oz, fs, ft = hooks.gep_gates(A, B, M["S"], M["T"], M["Q"], M["Z"])
        assert max(ra, rb, oq, oz) < GATE and fs == 0.0 and ft == 0.0, (stage, ra, rb)
    lead_ok, rest = hooks.selected_leading(r["reorder"]["S"], r["m"], finite_right_half,
                                           T=r["reorder"]["T"])
    assert lead_ok and rest == 0 and r["m"] == r["selected"]
    assert hooks.eigenvector_residual_gep(A, B, r["reorder"]["S"], r["reorder"]["T"],
                                          r["X"], np.arange(n) < r["m"]) < 1e-10
    # the single-process QZ of the chain's own HT form (the HT on shards
    # agrees with the single-process one to rounding, and this pencil's B
    # is singular: its spectrum moves by far more than 1e-10 under rounding)
    st = {}
    out = gep.schur(*(torch.as_tensor(r["ht"][k], device=cuda) for k in "STQZ"), stats=st,
                    device=cuda)
    sm = [x.cpu().numpy() for x in out[4:7]]
    assert hooks.chordal_eigenvalue_error(r["ar"], r["ai"], r["bt"], sm[0] + 1j * sm[1],
                                          sm[2]) * U < 1e-10
    assert abs(r["rounds"] - st["rounds"]) <= 2, (r["rounds"], st["rounds"])
    for k in ("ht_cascade", "ht_recondense", "qz_window", "qz_sweep", "aed_deflate_gep",
              "inf_chase", "reorder_bubble_gep"):
        assert cnt[0]["launches"][k] > 0, k
    assert cnt[1]["launches"]["ht_cascade"] > 0, cnt[1]["launches"]
    assert not any(v for k, v in cnt[1]["launches"].items()
                   if k not in ("ht_cascade", "eig_backsolve_gep")), cnt[1]["launches"]
    for c in cnt:
        solved = c["stages"]["eigenvectors"]["stats"]["eig_vectors"] > 0
        assert c["launches"]["eig_backsolve_gep"] == int(solved), (c["rank"], c["launches"])
        for stage in ("hessenberg_triangular", "schur", "select", "reorder", "eigenvectors"):
            rec = c["stages"][stage]
            assert rec["full_calls"] == 0, stage
            assert rec["peak_bytes"] < rec["shard_bytes"] + 2 * 8 * n * n, (stage, rec)
