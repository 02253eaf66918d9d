"""schur_chase_steps: the AED window solves' chase steps a problem of
`sep.schur` (its `stats["chase_steps"]`, kernel B2's count)."""

from harness.readers import stat_per_solve


def read(run):
    return stat_per_solve(run, "sep.schur", "chase_steps")
