"""Distributed-memory layer of the PyTorch port: process-group meshes and
sharded matrices (``starneig_tpu/parallel`` in the JAX package).

One process is one rank (``node.node_init`` over ``torch.distributed``);
a :class:`DistrMatrix` holds this rank's shard.  ``dm_core`` runs the
Schur driver and the reordering on column shards; ``block_cyclic``
converts to and from ScaLAPACK's 2D-block-cyclic layout.
"""

from starneig_tpu_torch.parallel.distr import (
    make_mesh,
    DistrMatrix,
    distr_matrix_create,
    distr_matrix_from_array,
)
