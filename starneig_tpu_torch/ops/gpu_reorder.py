"""Wrappers of the reordering's window-bubble kernels (SEP, and G6 for
pencils).

``kernels/csrc/reorder_bubble.cu`` runs the scan/swap state machine of
:func:`starneig_tpu_torch.ops.reorder._window_bubble` with one thread
block per window, in fp64, the windows in global memory / L2.  The JAX
package has no Pallas kernel here: it ran the bubble as one vmapped XLA
while-loop.  The wrapper launches the kernel on CUDA tensors and raises on
any other; :func:`starneig_tpu_torch.ops.reorder.window_bubble_batch`
dispatches on the device.  ``kernels/csrc/reorder_bubble_gep.cu`` (G6) runs
the pencil version, :func:`starneig_tpu_torch.ops.reorder._window_bubble_gep`
(JAX: the XLA while-loop ``_run_gep_bubble``); its dispatcher is
:func:`starneig_tpu_torch.ops.reorder.window_bubble_gep_batch`.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import Optional

from starneig_tpu_torch import kernels


def window_bubble(Tws, sels, dst0s, dst_limits, wlims):
    """Bubble the selected blocks of G windows to their tops on the card.

    ``Tws`` (G, W, W) CUDA float64; ``sels`` (G, W) bool numpy; ``dst0s``,
    ``dst_limits``, ``wlims`` host int sequences of length G.  Returns
    (Tws', Qws, sels', dsts, nfails, nswaps): tensors for the windows and
    their transforms, numpy arrays for the rest (one device read).
    """
    G, W = Tws.shape[0], Tws.shape[1]
    WP = W + 4
    dev = Tws.device
    Tp = Tws.new_zeros((G, WP, WP))
    Tp[:, :W, :W] = Tws
    Qp = Tws.new_zeros((G, W, WP))
    Qp[:, :, :W] = torch.eye(W, dtype=Tws.dtype, device=dev)
    sel = np.zeros((G, W + 4), np.int32)
    sel[:, :W] = np.asarray(sels, bool)
    state = np.zeros((G, 4), np.int32)
    state[:, 0], state[:, 1], state[:, 2] = dst0s, dst_limits, wlims
    sel_d = torch.from_numpy(sel).to(dev)
    state_d = torch.from_numpy(state).to(dev)
    kernels.require_cuda_f64("window_bubble", Tp, Qp)
    lib = kernels.lib()
    kernels.LAUNCHES["reorder_bubble"] += 1
    kernels.check(lib.reorder_bubble(Tp.data_ptr(), Qp.data_ptr(),
                                     sel_d.data_ptr(), state_d.data_ptr(), G, W,
                                     kernels.stream_ptr(Tws)), "reorder_bubble")
    host = torch.cat([sel_d, state_d], 1).cpu().numpy()
    sel_out, st = host[:, :W].astype(bool), host[:, W + 4:]
    return (Tp[:, :W, :W].contiguous(), Qp[:, :, :W].contiguous(), sel_out,
            st[:, 0], st[:, 1], st[:, 3])


def window_bubble_gep(Sws, Tws, sels, dst0s, dst_limits, wlims,
                      host: Optional[dict] = None):
    """Kernel G6: bubble the selected blocks of G pencil windows to their
    tops on the card, one block a window.

    ``Sws``, ``Tws`` (G, W, W) CUDA float64; ``sels`` (G, W) bool numpy;
    ``dst0s``, ``dst_limits``, ``wlims`` host int sequences of length G.
    The kernel takes padded (W+4)^2 S and T, W x (W+4) Q and Z, int flags
    and ``state = {dst0, dst_limit, wlim, 0}``, which comes back as
    ``{dst, nfail, steps, swaps}``.  ``host``, if a dict, receives ``steps``
    (G,) and ``subdiag`` (G, W - 1), read in the same transfer as the
    selections and counters (one device read).  Returns (Sws', Tws', Qws,
    Zws, sels', dsts, nfails, nswaps).
    """
    G, W = Sws.shape[0], Sws.shape[1]
    WP = W + 4
    dev = Sws.device
    Sp = Sws.new_zeros((G, WP, WP))
    Sp[:, :W, :W] = Sws
    Tp = Sws.new_zeros((G, WP, WP))
    Tp[:, :W, :W] = Tws
    Qp = Sws.new_zeros((G, W, WP))
    Qp[:, :, :W] = torch.eye(W, dtype=Sws.dtype, device=dev)
    Zp = Qp.clone()
    sel = np.zeros((G, W + 4), np.int32)
    sel[:, :W] = np.asarray(sels, bool)
    state = np.zeros((G, 4), np.int32)
    state[:, 0], state[:, 1], state[:, 2] = dst0s, dst_limits, wlims
    sel_d = torch.from_numpy(sel).to(dev)
    state_d = torch.from_numpy(state).to(dev)
    kernels.require_cuda_f64("window_bubble_gep", Sp, Tp, Qp, Zp)
    lib = kernels.lib()
    kernels.LAUNCHES["reorder_bubble_gep"] += 1
    kernels.check(lib.reorder_bubble_gep(Sp.data_ptr(), Tp.data_ptr(), Qp.data_ptr(),
                                         Zp.data_ptr(), sel_d.data_ptr(),
                                         state_d.data_ptr(), G, W,
                                         kernels.stream_ptr(Sws)), "reorder_bubble_gep")
    sub = torch.diagonal(Sp[:, :W, :W], -1, dim1=1, dim2=2)
    h = torch.cat([sel_d.to(Sp.dtype), state_d.to(Sp.dtype), sub], 1).cpu().numpy()
    st = h[:, WP:WP + 4].astype(np.int64)
    if host is not None:
        host.update(steps=st[:, 2], subdiag=h[:, WP + 4:])
    return (Sp[:, :W, :W].contiguous(), Tp[:, :W, :W].contiguous(),
            Qp[:, :, :W].contiguous(), Zp[:, :, :W].contiguous(),
            h[:, :W] != 0, st[:, 0], st[:, 1], st[:, 3])
