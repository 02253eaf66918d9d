"""solve_p95_ms: the 95th percentile (nearest rank) of the window's
problems' times, each from its first entry call to its synchronize (ms)."""

import math


def read(run):
    d = sorted(run.durations)
    return d[math.ceil(0.95 * len(d)) - 1] * 1e3 if d else None
