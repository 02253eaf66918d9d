"""starneig_tpu_torch — the PyTorch/CUDA port of starneig_tpu.

A second package beside the JAX reference ``starneig_tpu``, for one
NVIDIA H100 in native fp64.  Ported so far: the single-process SEP and
GEP interfaces (``api.sep``, ``api.gep``: reduction, Schur form,
reordering, eigenvectors), the command-line program (``cli``) and the
distributed-memory interface (``node``, ``parallel``, ``api.sep_dm``,
``api.gep_dm``): one process a rank over ``torch.distributed``, the
Schur form and the reordering on column shards, the window math and the
other stages on rank 0 (``testing.dm.run_ranks`` starts such ranks).

Every function takes torch tensors and runs on their device.  The
hand-written CUDA kernels (``kernels/csrc``) build with nvcc on the first
launch on a CUDA tensor; on CPU tensors each kernel's plain PyTorch twin
runs instead.  Importing the package builds nothing and imports no JAX.
"""

from starneig_tpu_torch import config, errors

__version__ = "0.1.0"

__all__ = ["config", "errors"]
