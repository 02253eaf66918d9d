"""qz_chase_steps: the AED window solves' chase steps a problem of
`gep.schur` (its `stats["chase_steps"]`, kernel G2's count)."""

from harness.readers import stat_per_solve


def read(run):
    return stat_per_solve(run, "gep.schur", "chase_steps")
