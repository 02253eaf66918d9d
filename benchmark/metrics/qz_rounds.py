"""qz_rounds: QZ rounds a problem of `gep.schur` (its `stats["rounds"]`)."""

from harness.readers import stat_per_solve


def read(run):
    return stat_per_solve(run, "gep.schur", "rounds")
