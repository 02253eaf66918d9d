"""Eigenvalue reordering of a real Schur form (SEP): selected eigenvalues
move to the leading block.

Port of the SEP part of ``starneig_tpu/ops/reorder.py``.  Selected 1x1/2x2
blocks bubble to the top of fixed-size diagonal windows by adjacent swaps
(:func:`_window_bubble`, the JAX package's scan/swap state machine); the
off-window rows and columns and Q then take each window's transform as
GEMMs (:func:`_apply_window`, :func:`_apply_windows_batch`).  The
sequential chain :func:`reorder_schur` chains windows bottom to top; the
wave-parallel :func:`reorder_schur_parallel` lays a grid of disjoint
windows over the unsorted part and bubbles all of them at once.

Windows are padded to W + 4 rows and columns so that the 4x4 slices near
the bottom edge never clamp, and a window whose edge falls inside a 2x2
block freezes the straddling half (rows < dst0 at the top, rows >= wlim at
the bottom).  A rejected (ill-conditioned) swap deselects the stuck block
and both routines report ``PARTIAL_REORDERING``; the output is always a valid
Schur form with the selection updated.

The selection and every integer that places a window live on the host;
each batch of windows reads the device once (its selections and counters).
:func:`window_bubble_batch` runs the kernel
(``kernels/csrc/reorder_bubble.cu``, through
:func:`starneig_tpu_torch.ops.gpu_reorder.window_bubble`) for CUDA tensors
and loops :func:`_window_bubble` over the windows for CPU tensors.

The generalized (pencil) variant, :func:`reorder_schur_gep`, runs the same
sequential chain on a generalized Schur form (S, T) with left and right
window transforms and dtgex2 swaps (``ops/swaps_gep.py``);
:func:`window_bubble_gep_batch` runs kernel G6
(``kernels/csrc/reorder_bubble_gep.cu``, through
:func:`starneig_tpu_torch.ops.gpu_reorder.window_bubble_gep`) for CUDA
tensors and :func:`_window_bubble_gep` for CPU tensors.  Each of its
windows reads the device once: the selection, the counters and the
window's subdiagonal in one transfer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from starneig_tpu_torch.config import ReorderConf
from starneig_tpu_torch.errors import Error
from starneig_tpu_torch.ops import gpu_reorder
from starneig_tpu_torch.ops.schur import DenseExtent
from starneig_tpu_torch.ops.swaps import swap_adjacent
from starneig_tpu_torch.ops.swaps_gep import swap_adjacent_gep
from starneig_tpu_torch.tools.trace import trace_span


# ---------------------------------------------------------------------------
# window bubble
# ---------------------------------------------------------------------------

def _window_bubble(Tw, sel, dst0: int, dst_limit: int, wlim: int):
    """Bubble selected blocks to the top of one window: the plain twin of
    the bubble kernel.

    Args:
      Tw: (W, W) quasi-triangular window (a diagonal block of S).
      sel: (W,) bool numpy selection, 2x2-block aligned.
      dst0: first row of the insertion region (rows < dst0 are frozen).
      dst_limit: stop once the insertion point reaches this row.
      wlim: rows >= wlim are frozen.

    Returns:
      (Tw', Qw, sel', dst, nfail, nswaps): the window, its transform
      (Tw' = Qw^T Tw Qw), the selection, the next insertion row, the
      rejected swaps and the swaps run.
    """
    W = Tw.shape[0]
    WP = W + 4
    Tp = Tw.new_zeros((WP, WP))
    Tp[:W, :W] = Tw
    Qp = Tw.new_zeros((W, WP))
    Qp[:, :W] = torch.eye(W, dtype=Tw.dtype, device=Tw.device)
    # padded: the 4-entry slices near the bottom edge must not clamp
    sp = np.concatenate([np.asarray(sel, bool), np.zeros(4, bool)])
    sub = torch.diagonal(Tp, -1).cpu().numpy().copy()    # host copy, (WP-1,)

    def block_start(i):
        return i == 0 or sub[i - 1] == 0.0

    def bsize(i):
        return 2 if i + 1 < W and sub[i] != 0.0 else 1

    dst, src, nfail, steps, nswaps, done = dst0, -1, 0, 0, 0, False
    while not done and steps < 4 * W * W:
        if src < 0:
            cand = [i for i in range(max(dst, 0), min(wlim, W))
                    if sp[i] and block_start(i)]
            s = cand[0] if cand else W
            done = s >= W or dst >= dst_limit
            at_dst = s == dst and not done
            if at_dst:
                dst += bsize(min(s, W - 1))
            src = -1 if (done or at_dst) else s
        else:
            a = src - 2 if (src >= 2 and not block_start(src - 1)) else src - 1
            p, q = src - a, bsize(src)
            # a < 0 only when dst0 splits a 2x2 block, which the reorder
            # routines never do; the slices then start at 0 and stay in bounds
            c = max(a, 0)
            Qs, Dh, accept = swap_adjacent(Tp[c:c + 4, c:c + 4].clone(), p, q)
            Tp[c:c + 4] = Qs.T @ Tp[c:c + 4]
            Tp[:, c:c + 4] = Tp[:, c:c + 4] @ Qs
            Tp[c:c + 4, c:c + 4] = Dh
            Qp[:, c:c + 4] = Qp[:, c:c + 4] @ Qs
            old = sp[c:c + 4].copy()
            i4 = np.arange(4)
            if accept:
                sp[c:c + 4] = np.where(i4 < q, True, np.where(i4 < p + q, False, old))
                # the swap changes no subdiagonal entry outside its block
                sub[c:c + 3] = torch.diagonal(Tp[c:c + 4, c:c + 4], -1).cpu().numpy()
                src = a
                if src == dst:
                    dst, src = dst + q, -1
            else:
                sp[c:c + 4] = np.where((i4 >= p) & (i4 < p + q), False, old)
                src, nfail = -1, nfail + 1
            nswaps += 1
        steps += 1
    return Tp[:W, :W], Qp[:, :W], sp[:W], dst, nfail, nswaps


def window_bubble_batch(Tws, sels, dst0s, dst_limits, wlims):
    """Bubble G windows: the kernel for a CUDA tensor, :func:`_window_bubble`
    per window for a CPU tensor.

    ``Tws`` (G, W, W); ``sels`` (G, W) bool numpy; the rest host int
    sequences of length G.  Returns (Tws', Qws, sels', dsts, nfails,
    nswaps): tensors for the first two, numpy arrays for the rest.
    """
    if Tws.is_cuda:
        return gpu_reorder.window_bubble(Tws, sels, dst0s, dst_limits, wlims)
    outs = [_window_bubble(Tws[g], sels[g], int(dst0s[g]), int(dst_limits[g]),
                           int(wlims[g])) for g in range(Tws.shape[0])]
    Tw, Qw, sel, dst, nfail, nsw = zip(*outs)
    return (torch.stack(Tw), torch.stack(Qw), np.stack(sel),
            np.asarray(dst), np.asarray(nfail), np.asarray(nsw))


def _gather_windows(S, ws, W: int):
    """(G, W, W) copies of the diagonal blocks of S at the starts ``ws``."""
    idx = torch.as_tensor(ws, device=S.device)[:, None] \
        + torch.arange(W, device=S.device)
    return S[idx[:, :, None], idx[:, None, :]]


# ---------------------------------------------------------------------------
# off-window updates (plain GEMMs, as the JAX package left them to XLA)
# ---------------------------------------------------------------------------

def _apply_window(S, Q, Tw, Qw, ws: int):
    """S <- diag(I, Qw, I)^T S diag(I, Qw, I) with the window planted,
    Q <- Q diag(I, Qw, I); in place."""
    W = Tw.shape[0]
    S[ws:ws + W] = Qw.T @ S[ws:ws + W]
    S[:, ws:ws + W] = S[:, ws:ws + W] @ Qw
    S[ws:ws + W, ws:ws + W] = Tw
    Q[:, ws:ws + W] = Q[:, ws:ws + W] @ Qw


def _apply_windows_batch(S, Q, Tws, Qws, ws):
    """Apply G disjoint window transforms, in place: batched row strips,
    then batched column strips, then the window plants.  Disjoint windows
    make the similarity transforms commute, so rows-then-columns is exact."""
    W = Tws.shape[1]
    idx = torch.as_tensor(ws, device=S.device)[:, None] \
        + torch.arange(W, device=S.device)                  # (G, W)
    S[idx] = torch.bmm(Qws.transpose(1, 2), S[idx])
    S[:, idx] = torch.bmm(S[:, idx].permute(1, 0, 2), Qws).permute(1, 0, 2)
    S[idx[:, :, None], idx[:, None, :]] = Tws
    Q[:, idx] = torch.bmm(Q[:, idx].permute(1, 0, 2), Qws).permute(1, 0, 2)


# ---------------------------------------------------------------------------
# host loops
# ---------------------------------------------------------------------------

def _align_select(subdiag: np.ndarray, select: np.ndarray) -> np.ndarray:
    """Make the selection 2x2-block atomic (reference: helpers.c:46-159)."""
    sel = select.copy()
    n = len(sel)
    i = 0
    while i < n - 1:
        if subdiag[i] != 0:  # block [i, i+1]
            v = bool(sel[i] or sel[i + 1])
            sel[i] = sel[i + 1] = v
            i += 2
        else:
            i += 1
    return sel


def _prefix_len(subdiag: np.ndarray, sel: np.ndarray) -> int:
    """Rows m such that sel[0:m] is a full leading run of selected blocks."""
    n = len(sel)
    m = 0
    while m < n and sel[m]:
        m += 2 if (m < n - 1 and subdiag[m] != 0) else 1
    return m


def _subdiag(S) -> np.ndarray:
    """S's subdiagonal on the host, with a trailing 0."""
    return np.concatenate([torch.diagonal(S, -1).cpu().numpy(), [0.0]])


def _as_host_bool(select) -> np.ndarray:
    if torch.is_tensor(select):
        select = select.cpu().numpy()
    return np.asarray(select, bool).copy()


def _resolve_window(n: int, sel: np.ndarray, conf: Optional[ReorderConf]):
    ratio = float(sel.sum()) / max(n, 1)
    rconf = (conf or ReorderConf()).resolve(n, workers=1, select_ratio=ratio)
    return rconf, min(rconf.window_size, n)


def _count(stats, **kw):
    if stats is not None:
        for k, v in kw.items():
            stats[k] = stats.get(k, 0) + int(v)


def reorder_schur(S, Q, select, conf: Optional[ReorderConf] = None,
                  stats: Optional[dict] = None):
    """Reorder a real Schur form so selected eigenvalues lead: the
    sequential window chain (``starneig_SEP_SM_ReorderSchur``, reference
    sep_sm.h:89-157).

    Args:
      S: (n, n) real Schur form; Q: (n, n) orthogonal accumulation matrix
        (neither is modified).
      select: (n,) bool array or tensor; 2x2 blocks are selected
        atomically (a pair is selected if either entry is).
      conf: optional ReorderConf; -1 fields auto-resolve.
      stats: optional dict; receives the counts ``windows``, ``swaps`` and
        ``failed_swaps`` (added to what it holds).

    Returns:
      (S, Q, num_selected, info): the reordered pair, the rows of the
      leading selected block, and Error.SUCCESS or PARTIAL_REORDERING.
    """
    S = S.clone()
    Q = Q.clone()
    n = S.shape[0]
    subdiag = _subdiag(S)
    sel = _align_select(subdiag, _as_host_bool(select))
    rconf, W = _resolve_window(n, sel, conf)
    # values moved per window pass: the reference's values_per_chain knob
    # (expert.h:727-733) bounds how many selected rows a window carries
    cap = W if W >= n else max(2, min(rconf.values_per_chain, W // 2))
    total_fail = 0

    while True:
        m = _prefix_len(subdiag, sel)
        below = np.nonzero(sel[m:n])[0]
        if below.size == 0:
            break
        lowest = m + int(below[-1])
        bsz = 2 if subdiag[lowest] != 0 else 1
        if subdiag[lowest - 1] != 0 and lowest > 0:
            lowest, bsz = lowest - 1, 2  # landed on the second row of a pair
        ws = min(max(m, lowest + bsz - W), n - W)
        while True:
            wlo = 1 if (ws > 0 and subdiag[ws - 1] != 0) else 0
            wlim = W - 1 if (ws + W < n and subdiag[ws + W - 1] != 0) else W
            Tw2, Qw, sel_w2, dst, nfail, nsw = window_bubble_batch(
                S[ws:ws + W, ws:ws + W][None], sel[None, ws:ws + W], [wlo],
                [min(wlo + cap, W)], [wlim])
            total_fail += int(nfail[0])
            _count(stats, windows=1, swaps=nsw[0], failed_swaps=nfail[0])
            _apply_window(S, Q, Tw2[0], Qw[0], ws)
            sel[ws:ws + W] = sel_w2[0]
            subdiag[ws:ws + W - 1] = torch.diagonal(Tw2[0], -1).cpu().numpy()
            if ws <= m:
                break
            carried = int(dst[0]) - wlo
            ws = max(m, ws + wlo + carried - W)

    m = _prefix_len(_subdiag(S), sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    return S, Q, m, info


def reorder_schur_parallel(S, Q, select, conf: Optional[ReorderConf] = None,
                           stats: Optional[dict] = None):
    """Wave-parallel reordering: disjoint windows bubble simultaneously.

    Each pass lays a grid of disjoint windows over [m, n), alternating the
    grid offset by W/2 between passes so values cross window edges, runs
    the bubble on all of them in one batch and applies the window
    transforms as batched GEMMs.  Falls back to :func:`reorder_schur` when
    n < 2W, and for stragglers after 8 (n / (W/2) + 2) passes.  Same
    contract as :func:`reorder_schur`; ``stats`` also receives ``passes``.
    """
    S = S.clone()
    Q = Q.clone()
    n = S.shape[0]
    subdiag = _subdiag(S)
    sel = _align_select(subdiag, _as_host_bool(select))
    _rconf, W = _resolve_window(n, sel, conf)
    if n < 2 * W:
        return reorder_schur(S, Q, sel, conf, stats=stats)

    total_fail = 0
    offset_toggle = 0
    guard = 0
    while True:
        m = _prefix_len(subdiag, sel)
        if not sel[m:n].any():
            break
        guard += 1
        if guard > 8 * (n // max(W // 2, 1) + 2):
            # fall back to the sequential chain for stragglers
            S, Q, m, info2 = reorder_schur(S, Q, sel, conf, stats=stats)
            total_fail += int(info2 == Error.PARTIAL_REORDERING)
            sel[:] = False
            sel[:m] = True
            subdiag = _subdiag(S)
            break
        _count(stats, passes=1)
        # grid of disjoint windows covering [m, n)
        start = m + (offset_toggle * (W // 2))
        offset_toggle ^= 1
        ws_list = []
        w0 = start
        while w0 + W <= n:
            ws_list.append(w0)
            w0 += W
        if not ws_list or (n - (ws_list[-1] + W)) > 0:
            last = n - W
            if not ws_list or last > ws_list[-1]:
                ws_list.append(last)  # may overlap its neighbour: it goes
                # in a second batch to keep each batch disjoint
        tail_overlap = len(ws_list) >= 2 and ws_list[-1] < ws_list[-2] + W
        main_ws = ws_list[:-1] if tail_overlap else ws_list
        batches = [main_ws] + ([[ws_list[-1]]] if tail_overlap else [])
        for group in batches:
            if not group:
                continue
            wlo = [1 if (w0 > 0 and subdiag[w0 - 1] != 0) else 0 for w0 in group]
            wlim = [W - 1 if (w0 + W < n and subdiag[w0 + W - 1] != 0) else W
                    for w0 in group]
            Tws = _gather_windows(S, group, W)
            sels = np.stack([sel[w0:w0 + W] for w0 in group])
            Tw2, Qw2, sel2, _dsts, nfails, nsw = window_bubble_batch(
                Tws, sels, wlo, wlim, wlim)
            total_fail += int(nfails.sum())
            _count(stats, windows=len(group), swaps=nsw.sum(),
                   failed_swaps=nfails.sum())
            _apply_windows_batch(S, Q, Tw2, Qw2, group)
            for g, w0 in enumerate(group):
                sel[w0:w0 + W] = sel2[g]
            subdiag = _subdiag(S)

    m = _prefix_len(_subdiag(S), sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    return S, Q, m, info


# ===========================================================================
# generalized (pencil) variant: the SEP chain with left and right window
# transforms and dtgex2 swaps (JAX starneig_tpu/ops/reorder.py:329-505;
# reference GEP reorder, reorder/lapack.c:114)
# ===========================================================================

def _window_bubble_gep(Sw, Tw, sel, dst0: int, dst_limit: int, wlim: int,
                       host: Optional[dict] = None):
    """Bubble selected blocks of a pencil window to its top: the plain twin
    of kernel G6 (JAX ``_gep_bubble_scan``/``_gep_bubble_swap``).

    Args:
      Sw, Tw: (W, W) window of a generalized Schur form (Sw
        quasi-triangular, Tw upper triangular).
      sel, dst0, dst_limit, wlim: as :func:`_window_bubble`.
      host: optional dict; receives ``steps`` (scans plus swaps) and
        ``subdiag`` (the result's subdiagonal, a numpy array).

    Returns:
      (Sw', Tw', Qw, Zw, sel', dst, nfail, nswaps): Sw' = Qw^T Sw Zw,
      Tw' = Qw^T Tw Zw, the selection, the next insertion row, the rejected
      swaps and the swaps run.  A rejected swap deselects the block that
      was moving.
    """
    W = Sw.shape[0]
    WP = W + 4
    Sp = Sw.new_zeros((WP, WP))
    Sp[:W, :W] = Sw
    Tp = Sw.new_zeros((WP, WP))
    Tp[:W, :W] = Tw
    Qp = Sw.new_zeros((W, WP))
    Qp[:, :W] = torch.eye(W, dtype=Sw.dtype, device=Sw.device)
    Zp = Qp.clone()
    sp = np.concatenate([np.asarray(sel, bool), np.zeros(4, bool)])
    sub = torch.diagonal(Sp, -1).cpu().numpy().copy()    # host copy, (WP-1,)

    def block_start(i):
        return i == 0 or sub[i - 1] == 0.0

    def bsize(i):
        return 2 if i + 1 < W and sub[i] != 0.0 else 1

    dst, src, nfail, steps, nswaps, done = dst0, -1, 0, 0, 0, False
    while not done and steps < 4 * W * W:
        if src < 0:
            cand = [i for i in range(max(dst, 0), min(wlim, W))
                    if sp[i] and block_start(i)]
            s = cand[0] if cand else W
            done = s >= W or dst >= dst_limit
            at_dst = s == dst and not done
            if at_dst:
                dst += bsize(min(s, W - 1))
            src = -1 if (done or at_dst) else s
        else:
            a = src - 2 if (src >= 2 and not block_start(src - 1)) else src - 1
            p, q = src - a, bsize(src)
            c = max(a, 0)       # a < 0 only when dst0 splits a 2x2 block
            Qs, Zs, Ah, Bh, accept = swap_adjacent_gep(
                Sp[c:c + 4, c:c + 4].clone(), Tp[c:c + 4, c:c + 4].clone(), p, q)
            old = sp[c:c + 4].copy()
            i4 = np.arange(4)
            if accept:
                for M in (Sp, Tp):
                    M[c:c + 4] = Qs.T @ M[c:c + 4]
                    M[:, c:c + 4] = M[:, c:c + 4] @ Zs
                Sp[c:c + 4, c:c + 4] = Ah
                Tp[c:c + 4, c:c + 4] = Bh
                Qp[:, c:c + 4] = Qp[:, c:c + 4] @ Qs
                Zp[:, c:c + 4] = Zp[:, c:c + 4] @ Zs
                sp[c:c + 4] = np.where(i4 < q, True, np.where(i4 < p + q, False, old))
                # the swap changes no subdiagonal entry outside its block
                sub[c:c + 3] = torch.diagonal(Ah, -1).cpu().numpy()
                src = a
                if src == dst:
                    dst, src = dst + q, -1
            else:
                sp[c:c + 4] = np.where((i4 >= p) & (i4 < p + q), False, old)
                src, nfail = -1, nfail + 1
            nswaps += 1
        steps += 1
    if host is not None:
        host.update(steps=steps, subdiag=sub[:W - 1].copy())
    return (Sp[:W, :W], Tp[:W, :W], Qp[:, :W], Zp[:, :W], sp[:W], dst, nfail,
            nswaps)


def window_bubble_gep_batch(Sws, Tws, sels, dst0s, dst_limits, wlims,
                            host: Optional[dict] = None):
    """Bubble G pencil windows: kernel G6 for a CUDA tensor,
    :func:`_window_bubble_gep` per window for a CPU tensor.

    ``Sws``, ``Tws`` (G, W, W); ``sels`` (G, W) bool numpy; the rest host
    int sequences of length G.  ``host``, if a dict, receives ``steps`` (G,)
    and ``subdiag`` (G, W - 1) numpy arrays.  Returns (Sws', Tws', Qws,
    Zws, sels', dsts, nfails, nswaps): tensors for the first four, numpy
    arrays for the rest.
    """
    if Sws.is_cuda:
        return gpu_reorder.window_bubble_gep(Sws, Tws, sels, dst0s, dst_limits,
                                             wlims, host=host)
    outs, hosts = [], []
    for g in range(Sws.shape[0]):
        hosts.append({})
        outs.append(_window_bubble_gep(Sws[g], Tws[g], sels[g], int(dst0s[g]),
                                       int(dst_limits[g]), int(wlims[g]),
                                       host=hosts[-1]))
    if host is not None:
        host.update(steps=np.asarray([h["steps"] for h in hosts]),
                    subdiag=np.stack([h["subdiag"] for h in hosts]))
    Sw, Tw, Qw, Zw, sel, dst, nfail, nsw = zip(*outs)
    return (torch.stack(Sw), torch.stack(Tw), torch.stack(Qw), torch.stack(Zw),
            np.stack(sel), np.asarray(dst), np.asarray(nfail), np.asarray(nsw))


def _apply_window_gep(S, T, Q, Z, Sw, Tw, Qw, Zw, ws: int, ext=DenseExtent):
    """S <- diag(I, Qw, I)^T S diag(I, Zw, I), likewise T, with the windows
    planted; Q <- Q diag(I, Qw, I), Z <- Z diag(I, Zw, I); in place,
    through ``ext``."""
    W = Sw.shape[0]
    for M in (S, T):
        ext.mul_rows(M, ws, W, Qw)
    ext.mul_cols_pencil((S, T, Q, Z), ws, W, (Zw, Zw, Qw, Zw))
    ext.set_block(S, Sw, ws, ws)
    ext.set_block(T, Tw, ws, ws)


def reorder_schur_gep(S, T, Q, Z, select, conf: Optional[ReorderConf] = None,
                      stats: Optional[dict] = None):
    """Reorder a generalized real Schur form so selected eigenvalues lead:
    the sequential window chain (``starneig_GEP_SM_ReorderSchur``,
    reference gep_sm.h:162-235).

    Args:
      S, T: (n, n) generalized Schur form (S quasi-triangular, T upper
        triangular); Q, Z: (n, n) orthogonal (none is modified).
      select: (n,) bool array or tensor; 2x2 blocks are selected atomically.
      conf: optional ReorderConf; -1 fields auto-resolve.
      stats: optional dict; receives the counts ``windows``, ``swaps`` and
        ``failed_swaps`` (added to what it holds).

    Returns:
      (S, T, Q, Z, num_selected, info): the reordered pencil and
      transforms, the rows of the leading selected block, and
      Error.SUCCESS or PARTIAL_REORDERING.
    """
    S, T, Q, Z = (M.clone() for M in (S, T, Q, Z))
    m, info = reorder_gep_(S, T, Q, Z, select, conf=conf, stats=stats)
    return S, T, Q, Z, m, info


def reorder_gep_(S, T, Q, Z, select, conf: Optional[ReorderConf] = None,
                 stats: Optional[dict] = None, ext=DenseExtent):
    """The window chain of :func:`reorder_schur_gep` in place on (S, T, Q,
    Z), every access through ``ext``: each window pair is read with one
    pencil gather, G6 runs in ``ext.window`` (the owner's, on a sharded
    extent, with the window's subdiagonal that it reports for the host's
    plan), and the window transforms go through ``ext``; each window is the
    span ``reorder.window`` (``tools/trace.py``).  ``stats``, if a dict,
    receives the window size ``W`` and the counts.  Returns (num_selected,
    info)."""
    n = S.shape[0]

    def host_subdiag():
        return ext.diagonals((S,), 0, n)[0, 1].cpu().numpy()

    subdiag = host_subdiag()
    sel = _align_select(subdiag, _as_host_bool(select))
    rconf, W = _resolve_window(n, sel, conf)
    cap = W if W >= n else max(2, min(rconf.values_per_chain, W // 2))
    total_fail = 0
    if stats is not None:
        stats["W"] = W

    while True:
        m = _prefix_len(subdiag, sel)
        below = np.nonzero(sel[m:n])[0]
        if below.size == 0:
            break
        lowest = m + int(below[-1])
        bsz = 2 if subdiag[lowest] != 0 else 1
        if lowest > 0 and subdiag[lowest - 1] != 0:
            lowest, bsz = lowest - 1, 2
        ws = min(max(m, lowest + bsz - W), n - W)
        while True:
            wlo = 1 if (ws > 0 and subdiag[ws - 1] != 0) else 0
            wlim = W - 1 if (ws + W < n and subdiag[ws + W - 1] != 0) else W

            def bubble(Sw, Tw, ws=ws, wlo=wlo, wlim=wlim):
                host = {}
                out = window_bubble_gep_batch(
                    Sw[None], Tw[None], sel[None, ws:ws + W], [wlo],
                    [min(wlo + cap, W)], [wlim], host=host)
                return (*out, host["subdiag"])

            with trace_span("reorder.window", (ws, ws, W, W)):
                Sw2, Tw2, Qw, Zw, sel_w2, dst, nfail, nsw, hsub = ext.window(
                    bubble, *ext.get_blocks((S, T), ws, ws, W, W))
                total_fail += int(nfail[0])
                _count(stats, windows=1, swaps=nsw[0], failed_swaps=nfail[0])
                _apply_window_gep(S, T, Q, Z, Sw2[0], Tw2[0], Qw[0], Zw[0], ws, ext)
                sel[ws:ws + W] = sel_w2[0]
                subdiag[ws:ws + W - 1] = hsub[0]
            if ws <= m:
                break
            carried = int(dst[0]) - wlo
            ws = max(m, ws + wlo + carried - W)

    m = _prefix_len(host_subdiag(), sel)
    info = Error.PARTIAL_REORDERING if total_fail else Error.SUCCESS
    return m, info
