"""The entry points of ``starneig_tpu_torch.api.sep`` run on the CUDA card
unless the caller names another device.

Without a card, a call that leaves ``device`` to its default raises
``RuntimeError`` and nothing falls back to the CPU; the same call with
``device="cpu"`` runs the plain versions.  Whether a card is present is
decided inside each test.
"""

import numpy as np
import pytest
import torch

from starneig_tpu_torch import kernels
from starneig_tpu_torch.api import sep
from starneig_tpu_torch.errors import Error

torch.set_num_threads(1)

N = 24
ENTRY_POINTS = ["hessenberg", "schur", "reorder_schur", "eigenvectors",
                "eigenvalues", "reduce"]


def _pred(lam):
    return lam.real > 0


@pytest.fixture(scope="module")
def inputs():
    """A seeded matrix, its Hessenberg and Schur forms (computed on the
    CPU) and a selection, all as host arrays."""
    A = np.random.default_rng(7).standard_normal((N, N))
    H, Q = sep.hessenberg(A, device="cpu")
    S, Q2, _er, _ei, info = sep.schur(H, Q, device="cpu")
    assert int(info) == 0
    sel = sep.select(S, _pred)
    return dict(A=A, H=H.numpy(), Q=Q.numpy(), S=S.numpy(), Q2=Q2.numpy(),
                sel=sel)


def _call(name, d, **kw):
    """Entry point ``name`` on the inputs d (numpy arrays: the entry point
    moves them to its device)."""
    if name == "hessenberg":
        return sep.hessenberg(d["A"], **kw)
    if name == "schur":
        return sep.schur(d["H"], d["Q"], **kw)
    if name == "reorder_schur":
        return sep.reorder_schur(d["S"], d["Q2"], d["sel"], **kw)
    if name == "eigenvectors":
        return sep.eigenvectors(d["S"], d["Q2"], np.arange(N) < 2, **kw)
    if name == "eigenvalues":
        return sep.eigenvalues(d["S"], **kw)
    return sep.reduce(d["A"], _pred, **kw)


def _devices(out):
    return {t.device.type for t in out if isinstance(t, torch.Tensor) and t.dim() > 0}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_default_device_is_the_card(inputs, name):
    if torch.cuda.is_available():
        assert _devices(_call(name, inputs)) == {"cuda"}
        return
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _call(name, inputs)
    assert kernels.LAUNCHES == before and kernels._lib is None


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_cpu_on_request(inputs, name):
    out = _call(name, inputs, device="cpu")
    assert _devices(out) == {"cpu"}
    assert all(t.dtype == torch.float64 for t in out
               if isinstance(t, torch.Tensor) and t.is_floating_point())
    if name in ("schur", "reorder_schur", "eigenvectors", "reduce"):
        assert int(out[-1]) == Error.SUCCESS


def test_inputs_are_not_modified(inputs):
    A = torch.as_tensor(inputs["A"].copy())
    A0 = A.clone()
    H, Q = sep.hessenberg(A, device="cpu")
    assert torch.equal(A, A0) and H.dtype == torch.float64
    # a float32 input is promoted, not aliased
    H32, _ = sep.hessenberg(A.float(), device="cpu")
    assert H32.dtype == torch.float64
