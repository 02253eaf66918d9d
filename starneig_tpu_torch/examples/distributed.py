"""Distributed solve: the DM interface over ranks of a process group.

Counterpart of ``examples/distributed.py`` (the reference's
``examples/sep_dm_full_chain.c``): 2 ranks (``testing.dm.run_ranks``:
spawned processes, gloo), each holding a column shard of the matrices;
the Hessenberg reduction, the Schur form and the reordering run on the
shards.

Run:  python -m starneig_tpu_torch.examples.distributed [n] [--device cpu]
"""

import numpy as np

from starneig_tpu_torch.examples._args import parse

RANKS = 2


def job(n: int):
    """Each rank's part; rank 0's lines are printed by :func:`main`."""
    from starneig_tpu_torch.api import sep_dm
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr_matrix_from_array
    from starneig_tpu_torch.testing import residual_sep

    mesh = default_mesh()
    lines = [f"mesh: {mesh.size} ranks"]

    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n))
    Ad = distr_matrix_from_array(A, mesh)

    Hd, Qd = sep_dm.hessenberg(Ad)
    Sd, Qd, er, ei, info = sep_dm.schur(Hd, Qd)
    lines.append(f"info = {info}")
    lines.append(f"residual = {residual_sep(A, Sd.to_array(), Qd.to_array()):.1f} u")

    select = er.cpu().numpy() > 0
    Sd, Qd, m, rinfo = sep_dm.reorder_schur(Sd, Qd, select)
    lines.append(f"reordered {m} rows to the top (info = {rinfo})")
    return lines, {}


def main(n: int = 256, device=None) -> None:
    from starneig_tpu_torch.testing.dm import run_ranks
    lines, _counters = run_ranks("starneig_tpu_torch.examples.distributed:job",
                                 RANKS, (n,), device=device, timeout_s=900.0)
    print("\n".join(lines))


if __name__ == "__main__":
    main(*parse(__doc__, 256))
