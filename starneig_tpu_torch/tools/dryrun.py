"""Multi-rank dry run of the whole SEP chain on column shards.

Counterpart of ``__graft_entry__.py:dryrun_multichip``:

    python -m starneig_tpu_torch.tools.dryrun [ranks] [--device cpu]

spawns ``ranks`` processes (default 2; ``testing.dm.run_ranks``), on the
card unless ``--device cpu`` is given, and runs at n = STARNEIG_DRYRUN_N
(default 512) ``sep_dm.hessenberg`` (the panel loop on column shards),
``schur``, ``reorder_schur`` of the left-half-plane eigenvalues (S and Q
must stay column-sharded) and ``eigenvectors`` of the leading block.  It
checks the residual and orthogonality (< 500 u) and that X is finite,
then prints one line.  The JAX file's ``entry()``, a single-chip jit
compile check, has no counterpart in eager PyTorch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

GATE_U = 500.0                   # the reference test driver's warn gate


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def chain(n: int):
    """The ranks' job: the chain at size n on A = default_rng(1)."""
    from starneig_tpu_torch.api import sep_dm
    from starneig_tpu_torch.errors import Error
    from starneig_tpu_torch.node import default_mesh
    from starneig_tpu_torch.parallel import distr_matrix_from_array
    from starneig_tpu_torch.parallel.distr import shard_range

    mesh = default_mesh()
    A = np.random.default_rng(1).standard_normal((n, n))
    Hd, Qd = sep_dm.hessenberg(distr_matrix_from_array(A, mesh))
    Sd, Qd, er, _ei, info = sep_dm.schur(Hd, Qd)
    _check(info == Error.SUCCESS, f"DM Schur did not converge (info {info})")
    S2, Q2, m, rinfo = sep_dm.reorder_schur(Sd, Qd, er.cpu().numpy() < 0)
    lo, hi = shard_range(n, mesh.size, mesh.rank)
    for M in (S2, Q2):
        _check(M.spec == "cols" and tuple(M.data.shape) == (n, hi - lo),
               f"the reordering gathered its output ({M.spec}, {tuple(M.data.shape)})")
    X, xinfo = sep_dm.eigenvectors(S2, Q2, np.arange(n) < m)
    S, Q, Xf = S2.to_array(), Q2.to_array(), X.to_array()
    u = np.finfo(np.float64).eps
    res = np.linalg.norm(Q @ S @ Q.T - A) / np.linalg.norm(A) / u
    orth = np.linalg.norm(Q @ Q.T - np.eye(n)) / np.sqrt(n) / u
    return (dict(residual_u=float(res), orthogonality_u=float(orth), nsel=int(m),
                 rinfo=int(rinfo), xinfo=int(xinfo), finite=bool(np.isfinite(Xf).all())),
            dict(shard=(n, hi - lo)))


def dryrun(n_ranks: int, device=None, n=None, timeout_s: float = 900.0) -> dict:
    """Run :func:`chain` on n_ranks ranks, check it, print one line;
    returns rank 0's result."""
    from starneig_tpu_torch.testing.dm import run_ranks

    n = int(os.environ.get("STARNEIG_DRYRUN_N", "512")) if n is None else n
    r, _cnt = run_ranks("starneig_tpu_torch.tools.dryrun:chain", n_ranks, (n,),
                        device=device, timeout_s=timeout_s)
    res, orth = r["residual_u"], r["orthogonality_u"]
    _check(res < GATE_U and orth < GATE_U, f"gates: residual {res}u, orthogonality {orth}u")
    _check(r["finite"], "eigenvectors not finite")
    print(f"dryrun_multichip({n_ranks}): full chain ok, "
          f"residual {res:.0f}u orth {orth:.0f}u nsel={r['nsel']}", flush=True)
    return r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-rank dry run of the SEP chain")
    ap.add_argument("ranks", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="every rank's device (default: the card)")
    args = ap.parse_args(argv)
    dryrun(args.ranks, device=args.device)


if __name__ == "__main__":
    main()
