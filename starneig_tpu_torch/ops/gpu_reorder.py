"""Wrapper of the reordering's window-bubble kernel.

``kernels/csrc/reorder_bubble.cu`` runs the scan/swap state machine of
:func:`starneig_tpu_torch.ops.reorder._window_bubble` with one thread
block per window, in fp64, the windows in global memory / L2.  The JAX
package has no Pallas kernel here: it ran the bubble as one vmapped XLA
while-loop.  The wrapper launches the kernel on CUDA tensors and raises on
any other; :func:`starneig_tpu_torch.ops.reorder.window_bubble_batch`
dispatches on the device.
"""

from __future__ import annotations

import numpy as np
import torch

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
