"""The traced run's device timeline: ``torch.profiler`` (CUDA activity)
over the window, reduced to busy time, idle gaps and device time by
operation.

The profiler's events and the harness's spans share one clock: kineto
stamps events in nanoseconds since the epoch, and the spans are taken with
``time.time_ns()``.  ``reduce`` works on plain tuples so that a recorded
timeline can be reduced again without a card.
"""

from __future__ import annotations

import bisect
import re


class DeviceTrace:
    """Context manager: a CUDA-activity profile of the block; ``events``
    afterwards holds its device operations as (name, start_ns, end_ns)."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        from torch.autograd import DeviceType
        evs = self._prof.profiler.kineto_results.events()
        self.events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in evs if e.device_type() == DeviceType.CUDA]
        self._prof = None
        return False


def short_name(name: str) -> str:
    """A kernel's name without its namespaces' noise and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0][:80]


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(merged, lo, hi) -> int:
    """Nanoseconds of [lo, hi) that the merged intervals cover."""
    tot = 0
    i = max(bisect.bisect_right([m[0] for m in merged], lo) - 1, 0)
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        tot += max(0, min(e, hi) - max(s, lo))
        i += 1
    return tot


def reduce(events, spans, window):
    """Reduce a window's device events.

    events: (name, start_ns, end_ns) of device operations; spans: (name,
    start_ns, end_ns) of the harness's spans, the problems' as "problem"
    and each chain step's under its step name; window: (start_ns, end_ns).

    Returns a dict: ``busy_s`` (device busy time inside the window),
    ``window_s``, ``in_problems_s`` (device busy time inside the problems'
    spans), ``device_ops`` ([name, seconds] by total device time, longest
    first) and ``idle_gaps`` ([what the host was doing, seconds]: the idle
    time inside each step's spans, and between problems, longest first).
    """
    lo, hi = window
    evs = [(n, max(s, lo), min(e, hi)) for n, s, e in events if e > lo and s < hi]
    merged = merge([(s, e) for _n, s, e in evs])
    busy = sum(e - s for s, e in merged)
    probs = merge([(s, e) for n, s, e in spans if n == "problem"])
    in_problems = sum(covered(merged, s, e) for s, e in probs)
    ops = {}
    for n, s, e in evs:
        k = short_name(n)
        ops[k] = ops.get(k, 0) + (e - s)
    steps = sorted((s, e, n) for n, s, e in spans if n != "problem")
    ends = [e for _s, e, _n in steps]
    gaps = {}

    def idle(a, b):
        """Attribute the idle interval [a, b) to the step spans over it."""
        i = bisect.bisect_right(ends, a)
        while a < b:
            if i < len(steps) and steps[i][0] < b:
                s, e, who = steps[i]
                if s > a:
                    gaps["between steps"] = gaps.get("between steps", 0) + (s - a)
                cut = min(e, b)
                gaps[who] = gaps.get(who, 0) + (cut - max(s, a))
                a, i = cut, i + 1
            else:
                gaps["between steps"] = gaps.get("between steps", 0) + (b - a)
                a = b
    cur = lo
    for s, e in merged + [[hi, hi]]:
        if s > cur:
            idle(cur, s)
        cur = max(cur, e)
    top = sorted(ops.items(), key=lambda kv: -kv[1])
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
            "in_problems_s": in_problems / 1e9,
            "device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[f"idle in {k}", v / 1e9] for k, v in idle]}
