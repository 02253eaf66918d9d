"""The port's DM layer on the card: gloo ranks sharing one CUDA device.

These tests need a CUDA device and nvcc; without a card every test skips
(the kernels have no CPU mode).  They import no JAX, so they run where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_dm_card.py

``sep_dm`` at n=1,200 on 2 ranks: hessenberg (rank 0), schur and
reorder_schur on column shards, eigenvectors (rank 0), held to the
reference's gates (info 0, residual and orthogonality < 500 u, exact
standardized Schur form before and after the reordering, the leading
block exactly the eigenvalues with Re > 0, eigenvector residuals < 1e-10),
to the single-process ``sep.schur`` on the card (spectrum within 1e-10
max|lambda|), and to the owner rule: rank 0 launched every kernel of the
path, rank 1 none.
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
    er2, ei2 = (t.numpy() for t in sep.eigenvalues(r["S2"], device="cpu"))
    assert (er2[:m] > 0).all()
    _S, _Q, er, ei, info = sep.schur(*sep.hessenberg(A, device=cuda), device=cuda)
    single = er.cpu().numpy() + 1j * ei.cpu().numpy()
    assert hooks.eigenvalue_error(r["er"] + 1j * r["ei"], single) * U < 1e-10
    X = r["X"]
    assert X.shape == (n, m)
    lam = er2[:m] + 1j * ei2[:m]
    j = 0
    while j < m:
        pair = ei2[j] != 0
        x = X[:, j] + 1j * X[:, j + 1] if pair else X[:, j]
        lj = er2[j] + 1j * abs(ei2[j]) if pair else lam[j]
        res = np.linalg.norm(A @ x - lj * x) / (np.linalg.norm(A) * np.linalg.norm(x))
        assert res < 1e-10, (j, res)
        j += 2 if pair else 1
    NP = cnt[0]["stats"]["schur"]["NP"]
    for c in cnt:
        assert c["backend"] == "gloo" and c["device"] == str(cuda)
        assert c["stats"]["schur"]["shard_shape"] == (NP, NP // 2)
    for k in ("hess_gemv", "francis", "train_hops", "aed_deflate", "recondense",
              "reorder_bubble"):
        assert cnt[0]["launches"][k] > 0, k
    assert not any(cnt[1]["launches"].values()), cnt[1]["launches"]
