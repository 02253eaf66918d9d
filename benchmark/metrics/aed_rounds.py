"""aed_rounds: AED rounds a problem of `sep.schur` (its `stats["rounds"]`)."""

from harness.readers import stat_per_solve


def read(run):
    return stat_per_solve(run, "sep.schur", "rounds")
