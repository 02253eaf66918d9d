"""roofline_pct: the least time the card could take for the work of the
window's problems (`harness/work.py`, summed step by step) over the device
time of all operations inside the problems' spans, in %.  Nothing on a
card that ``harness/peaks.json`` does not list."""

from harness.work import least_seconds


def read(run):
    if (run.trace is None or run.peak is None or not run.work
            or run.trace["in_problems_s"] <= 0):
        return None
    least = sum(least_seconds(f, b, run.peak) for f, b in run.work.values())
    return 100.0 * least / run.trace["in_problems_s"]
