"""Structured event tracing keyed by window coordinates.

Counterpart of ``starneig_tpu/tools/trace.py`` (the reference's event
tracer, ``src/common/trace.{c,h}``, STARNEIG_ENABLE_EVENTS): events
{label, begin, end, window rect, extra keys} are recorded on the host and
dumped to JSON for the native renderer ``native/trace_render.cpp``, whose
schema is ``{"n": N, "events": [{label, begin, end, rect: [r, c, h, w]},
...]}``.  Enable with ``enable_tracing()`` or STARNEIG_TPU_TRACE=1.

Times are the host's clock.  PyTorch returns from a call on a CUDA tensor
before the card has run it, so a span around card work ends when the host
has queued that work, not when the device finishes it; synchronize inside
the span (``torch.cuda.synchronize()``) to time the device's part.  The
drivers record no events of their own (as in the JAX package): spans are
placed by the caller.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

_EVENTS: List[dict] = []
_ENABLED = bool(int(os.environ.get("STARNEIG_TPU_TRACE", "0")))
_T0 = time.time()


def tracing_enabled() -> bool:
    return _ENABLED


def enable_tracing() -> None:
    """Start recording; clears the events recorded so far."""
    global _ENABLED, _T0
    _ENABLED = True
    _T0 = time.time()
    _EVENTS.clear()


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def trace_event(label: str, t_begin: float, t_end: float,
                rect: Optional[Tuple[int, int, int, int]] = None,
                **extra) -> None:
    """Record one event; rect = (row, col, height, width) in matrix coords."""
    if not _ENABLED:
        return
    _EVENTS.append({
        "label": label,
        "begin": t_begin - _T0,
        "end": t_end - _T0,
        "rect": list(rect) if rect is not None else None,
        **extra,
    })


@contextmanager
def trace_span(label: str, rect: Optional[Tuple[int, int, int, int]] = None,
               **extra):
    """Context manager variant (the reference's EVENT_BEGIN/END pair)."""
    if not _ENABLED:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        trace_event(label, t0, time.time(), rect, **extra)


def dump_trace(path: str = "trace.json", n: Optional[int] = None) -> str:
    """Write recorded events to JSON (the reference's trace.dat analogue)."""
    with open(path, "w") as f:
        json.dump({"n": n, "events": _EVENTS}, f)
    return path
