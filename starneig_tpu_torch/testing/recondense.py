"""The stages of kernel G1's window mode (the GEP AED recondense,
``kernels/csrc/ht_recondense.cu``) in plain PyTorch, for the tests.

They run the same rotations as ``ops/qz_driver.py:_aed_recondense_gep``
(the window mode's plain twin and oracle, which the CPU path runs) in the
kernel's order of arithmetic.  A cascade's left rotations come from suffix
norms of its column at once; all of them are applied before its right
rotations (which commute with them); Q, Z and the parts of S and T outside
the leading block, which take only left or only right rotations, replay a
log of (c, s, cr, sr) a pair afterwards.  The log's rows: cascade m (m = 0
the spike, m = j + 1 for column j) from :func:`log_off` (kbot, m), the pair
at row k at kbot - 1 - k.
"""

from __future__ import annotations

import math

import torch

from starneig_tpu_torch.ops.hess_triangular import _givens, rot_cols, rot_rows


def log_off(kbot: int, m: int) -> int:
    """The log's first row of cascade m."""
    return m * (kbot - 1) - m * (m - 1) // 2


def suffix_left_rotations(x):
    """The left rotations of one cascade from x (a cascade's column below
    the diagonal, or the spike), all at once: the entry the chain carries
    into row r is sigma_r ||x[r:]|| (sigma_r the sign of the first nonzero
    of x[r:]), from suffix sums of squares scaled by max|x|.  Returns
    ([(c, s) of the rotation at r = 1 .. len(x) - 1], the entry carried to
    row 0)."""
    xs = x.tolist()
    mx = max((abs(v) for v in xs), default=0.0)
    sc = mx if mx != 0.0 else 1.0
    acc, sgn, g = 0.0, 0, [0.0] * len(xs)
    for r in range(len(xs) - 1, -1, -1):
        v = xs[r] / sc
        acc += v * v
        if xs[r] != 0.0:
            sgn = 1 if xs[r] > 0.0 else -1
        g[r] = -sc * math.sqrt(acc) if sgn < 0 else sc * math.sqrt(acc)
    return [_givens(xs[r - 1], g[r]) for r in range(1, len(xs))], g[0]


def recondense_chain(S, T, x0, kbot: int):
    """Stage 1 of kernel G1's window mode, the chain: the spike x0 (kbot
    entries) chased and the cascade run on the leading kbot block of the
    CPU tensors S and T, in place, T's lower triangle there zeroed (T's
    block upper triangular on entry).  Each cascade j (j = -1 the spike):
    its left rotations from x (suffix_left_rotations), column j planted;
    the left rotations on S's columns and T's rows; the right chain on T's
    rows j+1 .. k, the fill planted; the right rotations on S's rows and
    T's rows 0 .. j.  Returns (the log (kbot (kbot - 1) / 2, 4), beta)."""
    log = S.new_zeros((kbot * (kbot - 1) // 2, 4))
    beta = x0[0].clone()
    for m in range(kbot - 1):
        j, off = m - 1, log_off(kbot, m)
        kmin, lo = j + 2, max(j + 1, 0)
        rots, y0 = suffix_left_rotations(x0[:kbot] if j < 0 else S[j + 1:kbot, j])
        for r, cs in enumerate(rots, 1):
            log[off + kbot - 2 - j - r, :2] = log.new_tensor(cs)
        if j < 0:
            beta = S.new_tensor(y0)
        else:
            S[j + 1, j] = y0
            S[j + 2:kbot, j] = 0.0
        for k in range(kbot - 1, kmin - 1, -1):
            c, s_ = log[off + kbot - 1 - k, :2].tolist()
            rot_rows(S[:, lo:kbot], k, c, s_)
            rot_rows(T[:, k - 1:kbot], k, c, s_)
        for k in range(kbot - 1, kmin - 1, -1):
            cr, sr = _givens(float(T[k, k]), float(T[k, k - 1]))
            rot_cols(T[lo:k + 1], k, cr, -sr)
            T[k, k - 1] = 0.0
            log[off + kbot - 1 - k, 2:] = log.new_tensor((cr, sr))
        for k in range(kbot - 1, kmin - 1, -1):
            cr, sr = log[off + kbot - 1 - k, 2:].tolist()
            rot_cols(S[:kbot], k, cr, -sr)
            rot_cols(T[:lo], k, cr, -sr)
    T[:kbot, :kbot] = torch.triu(T[:kbot, :kbot])
    return log, beta


def recondense_replay(S, T, Q, Z, log, kbot: int):
    """Stage 2 of kernel G1's window mode, in place on CPU tensors: the
    log's left rotations on Q's columns and on the rows of S[:, kbot:] and
    T[:, kbot:], its right rotations on Z's columns and on the columns of
    S[kbot:] and T[kbot:], in the cascade order."""
    for m in range(kbot - 1):
        off = log_off(kbot, m)
        for k in range(kbot - 1, m, -1):
            c, s_, cr, sr = log[off + kbot - 1 - k].tolist()
            rot_cols(Q, k, c, s_)
            rot_rows(S[:, kbot:], k, c, s_)
            rot_rows(T[:, kbot:], k, c, s_)
            rot_cols(Z, k, cr, -sr)
            rot_cols(S[kbot:], k, cr, -sr)
            rot_cols(T[kbot:], k, cr, -sr)


def aed_recondense_split(Sw, Tw, Qw, Zw, s: float, kbot: int):
    """Kernel G1's window mode in plain PyTorch, stage for stage
    (:func:`recondense_chain`, then :func:`recondense_replay`): the
    recondense of :func:`~starneig_tpu_torch.ops.qz_driver._aed_recondense_gep` (the oracle) in the kernel's
    order of arithmetic.  Returns (Sw, Tw, Qw, Zw, beta)."""
    S, T, Q, Z = (M.clone() for M in (Sw, Tw, Qw, Zw))
    if kbot == 0:
        return S, T, Q, Z, S.new_zeros(())
    x0 = s * Q[0, :kbot]
    if kbot == 1:
        return S, T, Q, Z, x0[0].clone()
    log, beta = recondense_chain(S, T, x0, kbot)
    recondense_replay(S, T, Q, Z, log, kbot)
    return S, T, Q, Z, beta
