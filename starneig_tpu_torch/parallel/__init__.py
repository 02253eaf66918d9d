"""Distributed-memory layer of the PyTorch port: process-group meshes and
sharded matrices (``starneig_tpu/parallel`` in the JAX package).

One process is one rank (``node.node_init`` over ``torch.distributed``);
a :class:`DistrMatrix` holds this rank's shard.  ``dm_hess`` runs the
Hessenberg reduction, ``dm_ht`` the Hessenberg-triangular reduction,
``dm_core`` the Schur driver and the reordering, ``dm_gep`` the QZ driver
and the generalized reordering and ``dm_eig`` both eigenvector
backsolves, each with column shards in and out; ``block_cyclic``
converts to and from ScaLAPACK's 2D-block-cyclic layout.
"""

from starneig_tpu_torch.parallel.distr import (
    make_mesh,
    DistrMatrix,
    distr_matrix_create,
    distr_matrix_from_array,
)
