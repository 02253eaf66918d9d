"""The GEP kernels G1-G6 and E2 against their plain PyTorch twins, on the card.

Every test needs a CUDA device and nvcc and skips without one (the CPU
suite holds the plain twins to the JAX package).  On the card,
``python -m pytest --noconftest tests/test_torch_gep_kernels.py`` builds
the kernels and runs them.  The plain twins run on CPU copies of the same
inputs.  Tolerances are stated per test: a kernel and its twin run the same
operations, differing in summation order and fused multiply-adds, except
the window QZ solve, whose deflation order may change over thousands of
steps and which is therefore held to its contract.
"""

import numpy as np
import pytest
import torch

from starneig_tpu_torch import kernels
from starneig_tpu_torch.api import gep
from starneig_tpu_torch.ops import eigenvectors as ev
from starneig_tpu_torch.ops import gpu_eig, gpu_gep, gpu_reorder
from starneig_tpu_torch.ops.eigvals import extract_eigenvalues_gen
from starneig_tpu_torch.ops.hess_triangular import (_ht_generate, _ht_reduce,
                                                    _ht_slivers, _rot_offset,
                                                    blocks, sliver_len)
from starneig_tpu_torch.ops.qz import _small_qz_plain
from starneig_tpu_torch.ops.qz_driver import (_aed_deflate_gep,
                                              _aed_recondense_gep, _inf_chase_kernel,
                                              _qz_sweep, _qz_train, _qz_train_hop)
from starneig_tpu_torch.ops.reorder import _window_bubble_gep
from starneig_tpu_torch.testing import hooks
from starneig_tpu_torch.testing import generators
from starneig_tpu_torch.testing.generators import (inf_push_window, known_spectrum_pencil,
                                                   planted_pencil_windows,
                                                   planted_spike_reject, qz_train_hops,
                                                   qz_train_pencil)
from starneig_tpu_torch.testing.generators import planted_schur_pair as schur_pair

U = np.finfo(np.float64).eps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _maxrel(a, b, ref):
    return float((a.cpu() - b.cpu()).abs().max()) / float(ref.abs().max())


def test_ht_cascade_full(cuda):
    """G1 (blocked) at n=192 against the unblocked _ht_reduce: the same
    rotations, 1e-11 max|M| (rounding of ~18,000 dependent steps); four
    kernels a cascade and a sliver launch a block of 32 cascades."""
    n = 192
    rng = np.random.default_rng(192)
    A = torch.as_tensor(rng.standard_normal((n, n)))
    B = torch.triu(torch.as_tensor(rng.standard_normal((n, n))))
    eye = torch.eye(n, dtype=torch.float64)
    n0 = kernels.LAUNCHES["ht_cascade"]
    got = gpu_gep.ht_cascade(*(M.to(cuda) for M in (A, B, eye, eye)))
    assert kernels.LAUNCHES["ht_cascade"] == n0 + 4 * (n - 2) + len(blocks(n, 32))
    want = _ht_reduce(A, B, eye, eye)
    for g, w in zip(got, want):
        assert _maxrel(g, w, w) <= 1e-11
    assert hooks.hessenberg_structure_error(got[0]) == 0.0
    assert hooks.triangular_structure_error(got[1]) == 0.0


@pytest.mark.parametrize("n", [192, 517])
def test_ht_generate(cuda, n):
    """G1's generation kernel against _ht_generate on the same pencil, the
    first block and (from the plain state after it) the second: A, B and
    the rotation log within 1e-11 max|M| (the kernel's band takes its
    last column by dot products where the twin sweeps)."""
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((n, n)))
    B = torch.triu(torch.as_tensor(rng.standard_normal((n, n))))
    rot = A.new_zeros((_rot_offset(n, n - 2), 4))
    for J0, J1 in blocks(n, 32)[:2]:
        Ag, Bg, rg = A.to(cuda), B.to(cuda), rot.to(cuda)
        gpu_gep.ht_generate(Ag, Bg, rg, J0, J1)
        _ht_generate(A, B, rot, J0, J1)
        assert _maxrel(Ag, A, A) <= 1e-11 and _maxrel(Bg, B, B) <= 1e-11
        assert _maxrel(rg, rot, rot) <= 1e-11


@pytest.mark.parametrize("n,J1", [(7300, 2), (13500, 1)])
def test_ht_generate_wide(cuda, n, J1):
    """G1's generation kernel at widths where column-sized shared-memory
    buffers would not fit a block's 227 KB (4 n doubles from n = 7,265,
    2 n + 2,112 from n = 13,473; the kernels' shared memory is fixed): the
    first cascades against _ht_generate on the same pencil, A, B and their
    log within 1e-11 max|M|."""
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((n, n)))
    B = torch.triu(torch.as_tensor(rng.standard_normal((n, n))))
    rot = A.new_zeros((_rot_offset(n, J1), 4))
    Ag, Bg, rg = A.to(cuda), B.to(cuda), rot.to(cuda)
    gpu_gep.ht_generate(Ag, Bg, rg, 0, J1)
    _ht_generate(A, B, rot, 0, J1)
    assert _maxrel(rg, rot, rot) <= 1e-11
    assert _maxrel(Ag, A, A) <= 1e-11 and _maxrel(Bg, B, B) <= 1e-11


def test_ht_slivers(cuda):
    """G1's sliver kernel against _ht_slivers on the same log (n=517, the
    first block, a middle one and the last, short one): the factors
    within 1e-13."""
    n = 517
    rng = np.random.default_rng(5)
    ang = rng.uniform(0, 2 * np.pi, (_rot_offset(n, n - 2), 2))
    rot = torch.as_tensor(np.stack([np.cos(ang[:, 0]), np.sin(ang[:, 0]),
                                    np.cos(ang[:, 1]), np.sin(ang[:, 1])], 1))
    L = sliver_len(32)
    for J0, J1 in [blocks(n, 32)[i] for i in (0, 7, -1)]:
        got = gpu_gep.ht_slivers(rot.to(cuda), n, J0, J1, L)
        want = _ht_slivers(rot, n, J0, J1, L)
        assert got.shape == want.shape
        assert float((got.cpu() - want).abs().max()) <= 1e-13


def _recondense_case(WA):
    S, T, Q, Z = schur_pair(WA, WA, WA)
    return S, T, Q, Z, 0.37


@pytest.mark.parametrize("kb", ["0", "1", "2", "3", "10", "WA-4", "WA"])
@pytest.mark.parametrize("WA", [84, 162, 322])
def test_ht_recondense(cuda, WA, kb):
    """G1's window mode (a chain and a replay launch) against
    _aed_recondense_gep: at kbot <= 10 within 1e-12 max|M|; at kbot = WA - 4
    and WA, where the re-reduction of a random
    window is ill-conditioned (one ulp of input moves the JAX result by O(1)
    from kbot ~ 25 on), by contract: similarity within 1e-13 WA, the
    Hessenberg-triangular structure exact, the spike tail below 1e-14 WA,
    beta within 1e-13 of sigma |s| ||Q[0, :kbot]||; kbot = 0 leaves the
    window unchanged with beta = 0.  WA = 84, 162, 322: the AED windows of
    the n=512, 2000 and 4000 geometries."""
    kbot = {"WA-4": WA - 4, "WA": WA}.get(kb) or int(kb)
    S, T, Q, Z, s = _recondense_case(WA)
    args = [torch.as_tensor(x) for x in (S, T, Q, Z)]
    n0 = kernels.LAUNCHES["ht_recondense"]
    got = gpu_gep.ht_recondense(*(x.to(cuda) for x in args), s, kbot)
    assert kernels.LAUNCHES["ht_recondense"] == n0 + (2 if kbot >= 2 else 1)
    if kbot == 0:
        for g, x in zip(got[:4], args):
            assert torch.equal(g.cpu(), x)
        assert float(got[4]) == 0.0
    if kbot <= 10:
        want = _aed_recondense_gep(*args, s, kbot)
        for g, w in zip(got[:4], want[:4]):
            assert _maxrel(g, w, w) <= 1e-12
        assert abs(float(got[4]) - float(want[4])) <= 1e-13
    _recondense_contract(S, T, Q, Z, s, kbot, got)


def _recondense_contract(S, T, Q, Z, s, kbot, got):
    WA = S.shape[0]
    S2, T2, Q2, Z2 = (x.cpu().numpy() for x in got[:4])
    Ul, Vr = Q.T @ Q2, Z.T @ Z2
    assert np.linalg.norm(Ul.T @ S @ Vr - S2) <= 1e-13 * WA * np.linalg.norm(S)
    assert np.linalg.norm(Ul.T @ T @ Vr - T2) <= 1e-13 * WA * np.linalg.norm(T)
    assert np.abs(np.tril(S2[:kbot, :kbot], -2)).max(initial=0.0) == 0.0
    assert np.abs(np.tril(T2[:kbot, :kbot], -1)).max(initial=0.0) == 0.0
    assert np.abs(s * Q2[0, 1:kbot]).max(initial=0.0) <= 1e-14 * WA
    x0 = s * Q[0, :kbot]
    nz = np.flatnonzero(x0)
    sigma = np.sign(x0[nz[0]]) if len(nz) else 1.0
    assert abs(float(got[4]) - sigma * np.linalg.norm(x0)) <= 1e-13


def test_ht_recondense_802(cuda):
    """G1's window mode at WA = 802 (the n=10,000 geometry; T's block in
    global memory) at kbot = WA - 4, by the contract alone."""
    WA = 802
    S, T, Q, Z, s = _recondense_case(WA)
    got = gpu_gep.ht_recondense(*(torch.as_tensor(x).to(cuda) for x in (S, T, Q, Z)), s,
                                WA - 4)
    _recondense_contract(S, T, Q, Z, s, WA - 4, got)


@pytest.mark.parametrize("kb", ["10", "WA-4"])
def test_ht_recondense_1000(cuda, kb):
    """G1's window mode at WA = 1000 (past kbot = 854, where 32 replay
    vectors no longer fit a block's shared memory: 26 a block here): at
    kbot = 10 within 1e-12 max|M| of _aed_recondense_gep, at kbot = WA - 4
    by the contract alone."""
    WA = 1000
    kbot = WA - 4 if kb == "WA-4" else int(kb)
    S, T, Q, Z, s = _recondense_case(WA)
    args = [torch.as_tensor(x) for x in (S, T, Q, Z)]
    got = gpu_gep.ht_recondense(*(x.to(cuda) for x in args), s, kbot)
    if kbot <= 10:
        want = _aed_recondense_gep(*args, s, kbot)
        for g, w in zip(got[:4], want[:4]):
            assert _maxrel(g, w, w) <= 1e-12
    _recondense_contract(S, T, Q, Z, s, kbot, got)


@pytest.mark.parametrize("cap", ["global", "vectors"])
@pytest.mark.parametrize("kb", ["10", "WA-4"])
@pytest.mark.parametrize("WA", [84, 162])
def test_ht_recondense_layouts(cuda, WA, kb, cap):
    """G1's window mode with its shared memory capped (smem_cap), so that
    a small window runs the layouts of a large kbot: "global" keeps the
    chain's vectors, T's block and the replay's vectors and rotations in
    global memory (past kbot ~ 9,680), "vectors" the chain's vectors in
    shared memory and T's block in global memory, the replay 2 or 3
    vectors a block.  The same arithmetic: bit-equal to the uncapped
    launch, and held as test_ht_recondense holds it."""
    kbot = WA - 4 if kb == "WA-4" else int(kb)
    S, T, Q, Z, s = _recondense_case(WA)
    args = [torch.as_tensor(x) for x in (S, T, Q, Z)]
    x = [a.to(cuda) for a in args]
    want = gpu_gep.ht_recondense(*x, s, kbot)
    got = gpu_gep.ht_recondense(*x, s, kbot, smem_cap=8 if cap == "global" else 40 * kbot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if kbot <= 10:
        plain = _aed_recondense_gep(*args, s, kbot)
        for g, w in zip(got[:4], plain[:4]):
            assert _maxrel(g, w, w) <= 1e-12
    _recondense_contract(S, T, Q, Z, s, kbot, got)


def _ht_window(w, seed, ninf=0):
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((w, w)), -1)
    T = np.triu(rng.standard_normal((w, w))) + 3 * np.eye(w)
    # non-adjacent zeros: an adjacent pair (a Jordan block at infinity) may
    # surface as a huge finite eigenvalue, as with LAPACK's dhgeqz
    for j in range(5, w - 5, max((w - 10) // max(ninf, 1), 2))[:ninf]:
        T[j, j] = 0.0
    return H, T


def _qz_contract(H, T, out):
    S, Tt, Q, Z, info = out
    ra, rb = hooks.residual_gep(H, T, S, Tt, Q, Z)
    return (int(info), ra, rb, hooks.orthogonality(Q), hooks.orthogonality(Z),
            hooks.schur_structure_error(S), hooks.triangular_structure_error(Tt))


def _zero_betas(Tt):
    d = torch.diagonal(Tt).abs().cpu()
    return int((d <= 1e-12 * d.max()).sum())


@pytest.mark.parametrize("w,ninf", [(84, 0), (162, 0), (84, 8), (322, 0)])
def test_qz_window(cuda, w, ninf):
    """G2 against _small_qz_plain by contract: equal info, residuals and
    orthogonality < 500 u on both, exact structure, every planted infinity
    back with |beta| <= 1e-12 max|beta| on both, and the two spectra within
    1e-10 (chordal).  Rounding may change the deflation order and whether
    an infinite eigenvalue is detected (T-diagonal entries at rounding
    level against u max|T|; chip_ab.py qzinf), so exact zeros are not
    compared.  w=322 is the GEP n=4000 path's AED window."""
    H, T = _ht_window(w, w + ninf, ninf)
    th = U / 2 * np.linalg.norm(H)
    tt = U / 2 * np.linalg.norm(T)
    eye = torch.eye(w, dtype=torch.float64)
    Ht, Tt = torch.as_tensor(H), torch.as_tensor(T)
    got = gpu_gep.qz_window(Ht.to(cuda), Tt.to(cuda), eye.to(cuda), eye.to(cuda), w, th, tt)
    want = _small_qz_plain(Ht, Tt, eye, eye, w, th, tt)
    ck, cp = _qz_contract(H, T, got), _qz_contract(H, T, want)
    assert ck[0] == cp[0] == 0
    assert max(ck[1:5]) < 500 and max(cp[1:5]) < 500
    assert ck[5:] == (0.0, 0.0) and cp[5:] == (0.0, 0.0)
    assert min(_zero_betas(got[1]), _zero_betas(want[1])) >= ninf
    ar, ai, bt = extract_eigenvalues_gen(want[0], want[1])
    chordal = hooks.chordal_eigenvalue_error(
        *extract_eigenvalues_gen(got[0], got[1]), (ar + 1j * ai).numpy(), bt.numpy())
    assert chordal * U < 1e-10


def test_qz_sweep_train(cuda):
    """G3 through the driver's windowed sweep: one train at n=512 (B=12)
    against the plain twin's, 1e-11 relative."""
    n, B, l, ihi = 512, 12, 0, 512
    P = 6 * B + 6
    NP = n + 2 * P
    rng = np.random.default_rng(512)
    S = np.zeros((NP, NP))
    T = np.zeros((NP, NP))
    S[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n)), -1)
    T[P:P + n, P:P + n] = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    Q = np.zeros((n, NP))
    Q[:, P:P + n] = np.eye(n)
    sh = rng.standard_normal((B, 4))
    sh[:, 3] = -sh[:, 1]
    cpu = [torch.as_tensor(x.copy()) for x in (S, T, Q, Q)]
    dev = [x.to(cuda) for x in cpu]
    n0 = kernels.LAUNCHES["qz_sweep"]
    _qz_sweep(*dev, P + l, P + ihi, torch.as_tensor(sh).to(cuda), B)
    assert kernels.LAUNCHES["qz_sweep"] > n0
    _qz_sweep(*cpu, P + l, P + ihi, torch.as_tensor(sh), B)
    for g, w in zip(dev, cpu):
        assert _maxrel(g, w, w) <= 1e-11


@pytest.mark.parametrize("hop", ["intro", "middle", "last", "subdiag"])
@pytest.mark.parametrize("B", [1, 3, 12, 13])
def test_qz_sweep_hop(cuda, B, hop):
    """G3 on one hop of a train as the driver's sweep cuts it (the
    introduction hop, a middle hop, the last hop where use3 turns false,
    and an introduction hop with S[l_rel, l_rel - 1] != 0, which takes the
    full ranges) against _qz_train_hop on the CPU, 1e-12 max|M| (the same
    operations, other fused multiply-adds)."""
    hops, sh = qz_train_hops({1: 40, 3: 60}.get(B, 100), B, 7 + B)
    Sw, Tw, l_rel, ihi_rel, s0 = hops[{"middle": len(hops) // 2, "last": -1}.get(hop, 0)]
    if hop == "subdiag":
        Sw = Sw.clone()
        Sw[l_rel, l_rel - 1] = 0.7
    want = _qz_train_hop(Sw, Tw, sh, l_rel, ihi_rel, s0, B, 3 * B)
    n0 = kernels.LAUNCHES["qz_sweep"]
    got = gpu_gep.qz_sweep(Sw.to(cuda), Tw.to(cuda), sh.to(cuda), l_rel, ihi_rel, s0, B,
                           3 * B)
    assert kernels.LAUNCHES["qz_sweep"] == n0 + 1
    for g, w in zip(got, want):
        assert _maxrel(g, w, w) <= 1e-12


# (B, n, l, ihi, S[l, l-1]): whole segments at each B (B = 13 is G3's
# kMaxB), an inner segment (l > 0, ihi < n), one shorter than a window
# (WC = 76) and an introduction where S[l, l-1] != 0 (the full ranges)
QZ_TRAIN_CASES = {"B1": (1, 40, 0, 40, 0.0), "B3": (3, 60, 0, 60, 0.0),
                  "B12": (12, 200, 0, 200, 0.0), "B13": (13, 200, 0, 200, 0.0),
                  "inner": (12, 200, 37, 170, 0.0), "short": (12, 200, 50, 70, 0.0),
                  "subdiag": (12, 200, 37, 170, 0.7)}


@pytest.mark.parametrize("case", list(QZ_TRAIN_CASES))
def test_qz_train(cuda, case):
    """G3's train mode (_qz_train: one qz_train and one qz_train_far launch,
    no qz_sweep) against the hop loop _qz_sweep on the CPU (the plain twin a
    hop, the strips by torch products): S, T, Q and Z within 1e-12 max|M|
    (the same operations, other orders of sums); the hops the chase
    published and those the loop ran both the train's."""
    B, n, l, ihi, sub = QZ_TRAIN_CASES[case]
    S, T, Q, Z, sh, P = qz_train_pencil(n, B, 25 + B, l, ihi)
    if l > 0:
        S[P + l, P + l - 1] = sub
    cpu = [torch.as_tensor(x) for x in (S, T, Q, Z)]
    dev = [x.to(cuda) for x in cpu]
    sh = torch.as_tensor(sh)
    before = {k: kernels.LAUNCHES[k] for k in ("qz_train", "qz_train_far", "qz_sweep")}
    hops = _qz_train(*dev, P + l, P + ihi, sh.to(cuda), B)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - v for k, v in before.items()} == dict(
        qz_train=1, qz_train_far=1, qz_sweep=0)
    assert int(hops) == _qz_sweep(*cpu, P + l, P + ihi, sh, B) == gpu_gep.sweep_hops(
        P + l, P + ihi, B)
    for g, w in zip(dev, cpu):
        assert _maxrel(g, w, w) <= 1e-12


def test_qz_schur_train_path(cuda):
    """qz_schur at n=512 on the card runs every train in train launches
    (train_hops == sweep_hops, the hops the chases published, as many as
    round_log's trains have; no G3 hop launch), each train's segment
    decoupled at its bottom (hooks.train_bottoms), under the QZ gates
    (residuals and orthogonality < 500 u, exact structure), its eigenvalues
    within chordal 1e-10 of the CPU run's on the same HT form.  The pencil is
    Gaussian: its eigenvalues are well conditioned (the port's CPU run and
    LAPACK's agree to 7e-15 chordal), where known_spectrum_pencil's at this
    n move by ~1e-8 under rounding."""
    from starneig_tpu_torch.ops.qz_driver import qz_schur
    n = 512
    rng = np.random.default_rng(512)
    A, B = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    H, T, Q, Z = (M.cpu() for M in gep.hessenberg_triangular(A, B))
    st_c, st_d = {}, {}
    want = qz_schur(H, T, Q, Z, stats=st_c)
    before = {k: kernels.LAUNCHES[k] for k in ("qz_train", "qz_train_far", "qz_sweep")}
    with hooks.train_bottoms() as bottoms:
        got = qz_schur(*(M.to(cuda) for M in (H, T, Q, Z)), stats=st_d)
    d = {k: kernels.LAUNCHES[k] - v for k, v in before.items()}
    assert int(got[7]) == 0 == int(want[7])
    ntr = sum(r[2] for r in st_d["round_log"])
    assert st_d["train_hops"] == st_d["sweep_hops"] == sum(
        t * gpu_gep.sweep_hops(l, i, st_d["B"]) for l, i, t, _s in st_d["round_log"]) > 0
    assert st_c["train_hops"] == 0
    assert d == dict(qz_train=ntr, qz_train_far=ntr, qz_sweep=0)
    assert len(bottoms) == ntr and all(v == 0.0 for _l, _i, v in bottoms)
    S, Tt, Qf, Zf = (M.cpu() for M in got[:4])
    ra, rb = hooks.residual_gep(A, B, S, Tt, Qf, Zf)
    assert ra < 500 and rb < 500
    assert hooks.orthogonality(Qf) < 500 and hooks.orthogonality(Zf) < 500
    assert hooks.schur_structure_error(S) == 0.0
    assert hooks.triangular_structure_error(Tt) == 0.0
    ar, ai, bt = (x.cpu() for x in got[4:7])
    chordal = hooks.chordal_eigenvalue_error(ar, ai, bt, (want[4] + 1j * want[5]).numpy(),
                                             want[6].numpy())
    assert chordal * U < 1e-10


# the spike: some bottom blocks deflate, the others move up (thresh is
# u/2 ||S||_F, which grows with WA); WA=322 is the GEP n=4000 path's window
@pytest.mark.parametrize("WA,s", [(84, 1e-13), (162, 1.5e-13), (322, 2.7e-13)])
def test_aed_deflate_gep(cuda, WA, s):
    """G4 against _aed_deflate_gep: kbot, fail and the step count equal; the
    matrices within 1e-11 relative (the same swaps, other rounding)."""
    S, T, Q, Z = schur_pair(WA, WA - 2, WA + 1)
    thresh = U / 2 * np.linalg.norm(S)
    args = [torch.as_tensor(x) for x in (S, T, Q, Z)]
    got = gpu_gep.aed_deflate_gep(*(x.to(cuda) for x in args), s, WA - 2, thresh)
    want = _aed_deflate_gep(*args, s, WA - 2, thresh)
    assert [int(x) for x in got[4:]] == [int(x) for x in want[4:]]
    assert 0 < int(want[4]) < WA - 2 and int(want[6]) > WA
    for g, w in zip(got[:4], want[:4]):
        assert _maxrel(g, w, w) <= 1e-11


@pytest.mark.parametrize("WA,gap", [(84, 20), (162, 40)])
def test_aed_deflate_gep_reject(cuda, WA, gap):
    """G4 on a window whose first move is rejected after `gap` accepted
    swaps (planted_spike_reject; at gap 40 in the move's second segment of
    the engine's 28 swaps): fail = 1 and (kbot, fail, steps) equal to
    _aed_deflate_gep's, the matrices within 1e-11 relative."""
    S, T, Q, Z = planted_spike_reject(WA, gap, WA + gap)
    thresh = U / 2 * np.linalg.norm(S)
    args = [torch.as_tensor(x) for x in (S, T, Q, Z)]
    got = gpu_gep.aed_deflate_gep(*(x.to(cuda) for x in args), 1.0, WA, thresh)
    want = _aed_deflate_gep(*args, 1.0, WA, thresh)
    assert [int(x) for x in got[4:]] == [int(x) for x in want[4:]]
    assert int(want[5]) == 1 and int(want[6]) == gap + 2
    for g, w in zip(got[:4], want[:4]):
        assert _maxrel(g, w, w) <= 1e-11


def test_gep_schur_inf_rich(cuda):
    """api.gep.schur on the card on tests/test_qz_driver.py's n=512
    infinite-rich HT pencil (51 exact T-diagonal zeros, seed 21), under that
    test's gates: 5000 u, exact structure, >= 90% of the infinities back
    with |beta| <= 1e-12 max|beta|; every GEP kernel launched."""
    n = 512
    rng = np.random.default_rng(21)
    H0 = np.triu(rng.standard_normal((n, n)), -1)
    T0 = np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)
    inf_pos = rng.choice(np.arange(1, n - 1), size=n // 10, replace=False)
    for j in inf_pos:
        T0[j, j] = 0.0
    kernels.reset_launches()
    stats = {}
    S, Tt, Q, Z, ar, ai, bt, info = gep.schur(H0, T0, stats=stats)
    assert int(info) == 0
    ra, rb = hooks.residual_gep(H0, T0, S, Tt, Q, Z)
    assert ra < 5000 and rb < 5000
    assert hooks.orthogonality(Q) < 5000 and hooks.orthogonality(Z) < 5000
    assert hooks.schur_structure_error(S) == 0.0
    assert hooks.triangular_structure_error(Tt) == 0.0
    bt = bt.cpu().numpy()
    assert int((np.abs(bt) <= 1e-12 * np.abs(bt).max()).sum()) >= int(0.9 * len(inf_pos))
    assert stats["inf_rounds"] > 0 and stats["recondense_calls"] > 0
    for k in ("qz_window", "qz_train", "qz_train_far", "aed_deflate_gep", "ht_recondense",
              "inf_chase"):
        assert kernels.LAUNCHES[k] > 0, k
    assert kernels.LAUNCHES["qz_sweep"] == 0


@pytest.mark.parametrize("Wb,jrel,mrel,lrel", [(96, 1, 96, -1), (84, 0, 84, 0),
                                               (96, 7, 60, 7), (96, 95, 96, -1),
                                               (96, 1, 37, -1), (24, 3, 20, 5)])
def test_inf_chase(cuda, Wb, jrel, mrel, lrel):
    """G5 against _inf_chase_kernel: the same rotations, 1e-12 max|M|; the
    zero moved to mrel - 1 exactly, H Hessenberg and T triangular exactly.
    The push's windows (chip_smoke.INF_CASES), a window with no step (jrel =
    mrel - 1), the last, short window of a push (mrel = 37 < Wb), and a
    reflection skipped inside the chase (lrel > jrel: the full ranges)."""
    H, T = (torch.as_tensor(x) for x in inf_push_window(Wb, Wb + jrel, jrel, lrel))
    n0 = kernels.LAUNCHES["inf_chase"]
    got = gpu_gep.inf_chase(H.to(cuda), T.to(cuda), jrel, mrel, lrel)
    assert kernels.LAUNCHES["inf_chase"] == n0 + 1
    want = _inf_chase_kernel(H, T, jrel, mrel, lrel)
    for g, w in zip(got, want):
        assert _maxrel(g, w, w) <= 1e-12
    Tg = got[1].cpu()
    assert float(Tg[mrel - 1, mrel - 1]) == 0.0
    assert hooks.triangular_structure_error(Tg) == 0.0
    if lrel <= jrel:   # a reflection skipped inside the chase leaves H's fill (the twin's too)
        assert hooks.hessenberg_structure_error(got[0]) == 0.0


@pytest.mark.parametrize("W,lims", [(16, ([0, 1, 0], [16, 16, 5], [16, 15, 16])),
                                    (128, ([0, 1], [128, 40], [128, 127]))])
def test_window_bubble_gep(cuda, W, lims):
    """G6 against _window_bubble_gep on planted pencil windows (2x2 blocks,
    exact T-diagonal zeros, a rejected swap in window 0, frozen rows and an
    insertion limit): selection, dst, rejected swaps, steps and swaps
    equal; the matrices within 1e-11 max|M| (the same swaps, other
    rounding)."""
    G = len(lims[0])
    Ss, Ts, sels = planted_pencil_windows(G, W, W + 3)
    Sd, Td = (torch.as_tensor(x).to(cuda) for x in (Ss, Ts))
    n0 = kernels.LAUNCHES["reorder_bubble_gep"]
    hk = {}
    got = gpu_reorder.window_bubble_gep(Sd, Td, sels, *lims, host=hk)
    assert kernels.LAUNCHES["reorder_bubble_gep"] == n0 + 1
    assert got[6][0] >= 1                     # the planted swap is rejected
    for g in range(G):
        hp = {}
        want = _window_bubble_gep(torch.as_tensor(Ss[g]), torch.as_tensor(Ts[g]), sels[g],
                                  lims[0][g], lims[1][g], lims[2][g], host=hp)
        assert (got[5][g], got[6][g], got[7][g], hk["steps"][g]) == \
            (want[5], want[6], want[7], hp["steps"])
        np.testing.assert_array_equal(got[4][g], want[4])
        np.testing.assert_array_equal(hk["subdiag"][g] != 0, hp["subdiag"] != 0)
        assert np.abs(hk["subdiag"][g] - hp["subdiag"]).max() <= 1e-11 * np.abs(Ss[g]).max()
        for k in range(4):
            assert _maxrel(got[k][g], want[k], want[k]) <= 1e-11


def _bubble_edge_windows(W):
    """Three planted pencil windows (planted_pencil_windows) with the
    selections the engine's edges need: window 0 its singular pair (the
    swap of rows 8:10 past 6:8 is rejected) and its deepest 2x2 block,
    whose move takes more swaps than a segment holds (28) from W = 64 on,
    so it crosses segment boundaries as a 2x2 block; window 1 only its
    infinite eigenvalues (T's exact diagonal zeros) and one 2x2 block
    below them; window 2 the generator's random selection."""
    Ss, Ts, sels = planted_pencil_windows(3, W, W + 11)
    pairs = list(range(1, W - 2, 5))
    infs = [j for j in range(3, W, 7) if j not in {r for p in pairs for r in (p, p + 1)}]
    sels[0][:] = False
    sels[0][8:10] = True
    sels[0][pairs[-1]:pairs[-1] + 2] = True
    sels[1][:] = False
    sels[1][infs] = True
    sels[1][pairs[-1]:pairs[-1] + 2] = True
    return Ss, Ts, sels, len(infs)


@pytest.mark.parametrize("W", [24, 64, 128])
def test_window_bubble_gep_edges(cuda, W):
    """G6's engine at its edges (_bubble_edge_windows: a rejected swap, a
    2x2 block moving across segment boundaries, infinite eigenvalues moving
    up, frozen rows and an insertion offset in window 2) against
    _window_bubble_gep: every integer output (dst, rejected swaps, steps,
    swaps, the selection, which subdiagonal entries are nonzero) equal, the
    matrices within 1e-11 max|M| (the same swaps in the same order, other
    fused multiply-adds); window 1's infinite eigenvalues lead with T's
    diagonal at rounding level."""
    Ss, Ts, sels, ninf = _bubble_edge_windows(W)
    lims = ([0, 0, 1], [W, W, W], [W, W, W - 1])
    Sd, Td = (torch.as_tensor(x).to(cuda) for x in (Ss, Ts))
    hk = {}
    got = gpu_reorder.window_bubble_gep(Sd, Td, sels, *lims, host=hk)
    assert got[6][0] >= 1
    for g in range(3):
        hp = {}
        want = _window_bubble_gep(torch.as_tensor(Ss[g]), torch.as_tensor(Ts[g]), sels[g],
                                  lims[0][g], lims[1][g], lims[2][g], host=hp)
        assert (got[5][g], got[6][g], got[7][g], hk["steps"][g]) == \
            (want[5], want[6], want[7], hp["steps"])
        np.testing.assert_array_equal(got[4][g], want[4])
        np.testing.assert_array_equal(hk["subdiag"][g] != 0, hp["subdiag"] != 0)
        for k in range(4):
            assert _maxrel(got[k][g], want[k], want[k]) <= 1e-11
    T1 = got[1][1].cpu().numpy()
    tiny = np.abs(np.diag(T1)) <= 1e-14 * np.abs(T1).max()
    assert tiny[:ninf].all() and tiny.sum() >= ninf


def test_gep_reorder_eigenvectors(cuda):
    """The GEP chain past QZ on the card at n=300 (a pencil with 10%
    planted infinite eigenvalues): select (finite, Re > 0) -> reorder_schur
    -> eigenvectors, under the smoke's gates: the leading rows hold the
    selected eigenvalues, 500 u, exact structure, eigenvector residuals
    < 1e-10; G6 launched."""
    n = 300
    A, B, _al, _be = known_spectrum_pencil(n, complex_ratio=0.3, inf_ratio=0.1, seed=3)
    H, T, Q, Z = gep.hessenberg_triangular(A, B)
    S, Tt, Q, Z, *_ar, info = gep.schur(H, T, Q, Z)
    assert int(info) == 0
    sel = gep.select(S, Tt, lambda a, b: b != 0 and (a / b).real > 0)
    kernels.reset_launches()
    S2, T2, Q2, Z2, m, rinfo = gep.reorder_schur(S, Tt, Q, Z, sel)
    assert kernels.LAUNCHES["reorder_bubble_gep"] > 0
    assert int(rinfo) == 0 and m == int(sel.sum())
    ra, rb = hooks.residual_gep(A, B, S2, T2, Q2, Z2)
    assert max(ra, rb, hooks.orthogonality(Q2), hooks.orthogonality(Z2)) < 500
    assert hooks.schur_structure_error(S2) == 0.0
    assert hooks.triangular_structure_error(T2) == 0.0
    ar, ai, bt = (x.cpu().numpy() for x in extract_eigenvalues_gen(S2, T2))
    assert (bt[:m] != 0).all() and (ar[:m] / bt[:m] > 0).all()
    lead = np.arange(n) < m
    X, xinfo = gep.eigenvectors(S2, T2, Q2, Z2, lead)
    assert X.shape == (n, m) and bool(torch.isfinite(X).all())
    assert hooks.eigenvector_residual_gep(A, B, S2, T2, X, lead) < 1e-10


def _evec_gep_case(case, cuda):
    """(A, B, S, T, Z, select) on the card: tests/test_torch_gep_eigenvectors.py's
    twin cases (the three pencils reduced by the port on the CPU, the
    growth and close pencils with A, B = S, T and Z = I), the close pencil
    with nothing selected, or the n=1000
    GEP_BENCH mix through the port's HT and QZ on the card with the finite
    right half selected."""
    if case in ("growth", "close", "none"):
        S, T, sel = (generators.growth_pencil if case == "growth" else generators.close_pencil)()
        S, T = (torch.as_tensor(M, device=cuda) for M in (S, T))
        sel = sel & (case != "none")
        return S, T, S, T, torch.eye(S.shape[0], dtype=S.dtype, device=cuda), sel
    n, seed, kw = {"all": (24, 1, {}), "subset": (32, 5, {}),
                   "infinite": (20, 9, dict(complex_ratio=0.2, inf_ratio=0.2)),
                   "n1000": (1000, 1000, dict(complex_ratio=0.3, inf_ratio=0.1))}[case]
    if kw:
        A, B, _alpha, _beta = known_spectrum_pencil(n, seed=seed, **kw)
    else:
        A = generators.random_dense(n, seed=seed)
        B = generators.random_dense(n, seed=seed + 77) + 3 * np.eye(n)
    dev = cuda if n > 64 else "cpu"
    S, T, _Q, Z, *_e, info = gep.schur(*gep.hessenberg_triangular(A, B, device=dev),
                                       device=dev)
    assert int(info) == 0
    if case == "n1000":
        sel = gep.select(S, T, lambda a, b: b != 0 and (a / b).real > 0)
    elif case == "subset":
        sel = np.random.default_rng(0).random(n) < 0.4
    else:
        sel = np.ones(n, bool)
    A, B, S, T, Z = (torch.as_tensor(M).to(cuda) for M in (A, B, S, T, Z))
    return A, B, S, T, Z, sel


@pytest.mark.parametrize("case", ["all", "subset", "infinite", "growth", "close", "n1000",
                                  "none"])
def test_eig_backsolve_gep(cuda, case):
    """E2 against the plain GEP row loop on the card: the normalized
    vectors within 1e-12 (the dots sum in another order), the close flags
    equal, two launches bit-equal; eigenvectors_schur_gep launches E2
    exactly once, its vectors under the chain's residual bound; with
    nothing selected (m = 0) neither the wrapper nor the entry point
    launches."""
    A, B, S, T, Z, sel = _evec_gep_case(case, cuda)
    n0 = kernels.LAUNCHES["eig_backsolve_gep"]
    entries = ev._selected_blocks_gep(S, T, sel)
    if not entries:
        n = S.shape[0]
        e = S.new_zeros(0)
        close = gpu_eig.backsolve_gep(S, T, e, e, e, [], [], ev._row_kinds(np.zeros(n)), e,
                                      1.0, 1e-300, S.new_zeros((0, n)), S.new_zeros((0, n)))
        X, info = ev.eigenvectors_schur_gep(S, T, Z, Z, sel)
        assert close.shape == (0,) and X.shape == (n, 0) and int(info) == 0
        assert kernels.LAUNCHES["eig_backsolve_gep"] == n0
        return
    pos, pair, ar, ai, bt = (list(x) for x in zip(*entries))
    ar, ai, bt = (torch.tensor(v, dtype=S.dtype, device=cuda) for v in (ar, ai, bt))
    kind, smin, omega, smlnum, xr, xi = ev._backsolve_inputs_gep(S, T, ar, ai, bt, pos, pair)
    runs = []
    for _ in range(2):
        xrk, xik = xr.clone(), xi.clone()
        ck = gpu_eig.backsolve_gep(S, T, ar, ai, bt, pos, pair, kind, smin, omega, smlnum,
                                   xrk, xik)
        runs.append((xrk, xik, ck))
    assert kernels.LAUNCHES["eig_backsolve_gep"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    cp = ev._backsolve_rows_gep(S, T, ar, ai, bt, pos, pair, kind, smin, omega, smlnum,
                                xr, xi)
    xrk, xik, ck = runs[0]
    assert torch.equal(ck, cp)
    if case == "close":
        assert bool(ck.any())
    for g, w in zip(ev._normalize(xrk, xik), ev._normalize(xr, xi)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-12
    real = ~torch.as_tensor(np.asarray(pair), device=cuda)
    assert not bool(xik[real].any())          # a real eigenvalue's xi stays zero
    X, info = ev.eigenvectors_schur_gep(S, T, Z, Z, sel)
    assert kernels.LAUNCHES["eig_backsolve_gep"] == n0 + 3
    assert bool(torch.isfinite(X).all())
    if case == "n1000":
        assert hooks.eigenvector_residual_gep(A, B, S, T, X, sel) < 1e-10


def _e2_against_twin(S, T, sel, cuda):
    """E2 on the pencil (S, T) (numpy, copied to the card) for the selected
    eigenvalues against the plain row loop on the card: two launches
    bit-equal, the close flags equal, the normalized vectors within 1e-12
    (the sums run in another order).  Returns (pos, pair, bt, kind)."""
    S, T = (torch.as_tensor(M, device=cuda) for M in (S, T))
    pos, pair, ar, ai, bt = (list(x) for x in zip(*ev._selected_blocks_gep(S, T, sel)))
    ar, ai, bt = (torch.tensor(v, dtype=S.dtype, device=cuda) for v in (ar, ai, bt))
    kind, smin, omega, smlnum, xr, xi = ev._backsolve_inputs_gep(S, T, ar, ai, bt, pos, pair)
    n0 = kernels.LAUNCHES["eig_backsolve_gep"]
    runs = []
    for _ in range(2):
        xrk, xik = xr.clone(), xi.clone()
        runs.append((xrk, xik, gpu_eig.backsolve_gep(S, T, ar, ai, bt, pos, pair, kind, smin,
                                                     omega, smlnum, xrk, xik)))
    assert kernels.LAUNCHES["eig_backsolve_gep"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    cp = ev._backsolve_rows_gep(S, T, ar, ai, bt, pos, pair, kind, smin, omega, smlnum, xr, xi)
    xrk, xik, ck = runs[0]
    assert torch.equal(ck, cp)
    for g, w in zip(ev._normalize(xrk, xik), ev._normalize(xr, xi)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-12
    return pos, pair, bt, kind


def test_eig_backsolve_gep_block_edges(cuda):
    """E2 where a group's rows span at least 9 of the kernel's row blocks
    (64 rows), 2x2 blocks sit at block edges (the boundary moves a row) and
    infinite eigenvalues are among those selected: a generalized Schur form
    built directly (generators.schur_pencil, n = 700, 30% pairs, 10%
    infinite), every eigenvalue selected, against the plain row loop."""
    from starneig_tpu_torch.testing import backsolve_blocked as bb
    S, T, _alpha, _beta = generators.schur_pencil(700, 0.3, 0.0, 0.1, seed=700)
    pos, pair, bt, kind = _e2_against_twin(S, T, np.ones(700, bool), cuda)
    order = np.argsort(-np.asarray(pos), kind="stable")
    tops = [max(pos[i] for i in order[g:g + bb.GROUP]) for g in range(0, len(pos), bb.GROUP)]
    blocks = [blk for top in tops for blk in bb.row_blocks(top, kind)]
    assert max(len(bb.row_blocks(top, kind)) for top in tops) >= 9
    assert any(r0 > 0 and kind[r0 - 1] == 2 for r0, _r1 in blocks)   # a moved boundary
    assert sum(pair) > 100 and bool((bt == 0).any())                  # pairs, infinities


def test_eig_backsolve_gep_large_n(cuda):
    """E2 at n = 6,000, where its shared memory is the same as at any n:
    the eigenvalues of generators.schur_pencil's last 12 rows (10, 3 of
    them pairs), a chain over 6,000 rows in 95 row blocks, against the
    plain row loop."""
    n = 6000
    S, T, _alpha, _beta = generators.schur_pencil(n, 0.3, 0.0, 0.1, seed=n)
    sel = np.arange(n) >= n - 12
    pos, pair, _bt, _kind = _e2_against_twin(S, T, sel, cuda)
    assert min(pos) >= n - 13 and sum(pair) > 0     # a pair may start a row above

