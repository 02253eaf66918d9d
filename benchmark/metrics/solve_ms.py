"""solve_ms: the window's wall time over the problems solved in it (ms)."""


def read(run):
    return run.window_s / run.problems * 1e3 if run.problems else None
