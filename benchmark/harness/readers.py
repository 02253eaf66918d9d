"""Helpers the metric readers (``metrics/<name>.py``) share: each reads a
``harness.cell.Run`` and returns a number, or None where the run holds
nothing to read (that metric is then left out of the result line)."""

from __future__ import annotations


def span_ms(run, step: str):
    """Mean milliseconds of the step's spans a problem (traced runs)."""
    v = run.spans.get(step)
    return sum(v) / run.problems * 1e3 if v else None


def stat_per_solve(run, step: str, key: str):
    """The program's counter ``key`` of the step, summed over the window's
    problems, a problem."""
    v = [s[key] for s in run.stats.get(step, []) if key in s]
    return sum(v) / run.problems if v else None
