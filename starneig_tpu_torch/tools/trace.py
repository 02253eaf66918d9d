"""Structured event tracing keyed by window coordinates.

Counterpart of ``starneig_tpu/tools/trace.py`` (the reference's event
tracer, ``src/common/trace.{c,h}``, STARNEIG_ENABLE_EVENTS): events
{label, begin, end, window rect, extra keys} are recorded on the host and
dumped to JSON for the native renderer ``native/trace_render.cpp``, whose
schema is ``{"n": N, "events": [{label, begin, end, rect: [r, c, h, w]},
...]}``, ``begin`` and ``end`` in seconds since ``enable_tracing()``.
Enable with ``enable_tracing()`` or STARNEIG_TPU_TRACE=1.

Stamps are ``time.time_ns()``, the clock ``torch.profiler`` stamps the
device's events on (nanoseconds since the epoch): :func:`events_ns`
returns the spans on that clock, so that a span can be laid over a device
timeline.  PyTorch returns from a call on a CUDA tensor before the card has
run it, so a span records what the host was doing (queueing work, or
waiting on a device read), and the device trace shows what the card did
meanwhile; no span synchronizes.

The drivers place spans in their host loops: ``schur.scan``,
``schur.window``, ``schur.apply`` each AED round and ``schur.sweep`` each
wavefront sweep (``ops/schur.py``); ``qz.scan``, ``qz.infinite``,
``qz.window``, ``qz.apply`` each QZ round and ``qz.sweep`` each train
(``ops/qz_driver.py``); ``reorder.window`` each window of the pencil's
reordering (``ops/reorder.py``); ``ht.qr`` and ``ht.block`` in the HT
reduction (``ops/hess_triangular.py``).  With tracing off,
:func:`trace_span` returns one shared context manager that does nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

_EVENTS: List[dict] = []
_ENABLED = bool(int(os.environ.get("STARNEIG_TPU_TRACE", "0")))
_T0 = time.time_ns()


def tracing_enabled() -> bool:
    return _ENABLED


def enable_tracing() -> None:
    """Start recording; clears the events recorded so far."""
    global _ENABLED, _T0
    _ENABLED = True
    _T0 = time.time_ns()
    _EVENTS.clear()


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def _record(label, t0_ns: int, t1_ns: int, rect, extra) -> None:
    _EVENTS.append({
        "label": label,
        "begin": (t0_ns - _T0) / 1e9,
        "end": (t1_ns - _T0) / 1e9,
        "rect": list(rect) if rect is not None else None,
        **extra,
    })


def trace_event(label: str, t_begin: float, t_end: float,
                rect: Optional[Tuple[int, int, int, int]] = None,
                **extra) -> None:
    """Record one event; t_begin and t_end in seconds on ``time.time()``'s
    clock, rect = (row, col, height, width) in matrix coords."""
    if not _ENABLED:
        return
    _record(label, round(t_begin * 1e9), round(t_end * 1e9), rect, extra)


class _Span:
    """An open span: stamped on entry, recorded on exit (an exception
    passes through, the span recorded all the same)."""

    __slots__ = ("label", "rect", "extra", "t0")

    def __init__(self, label, rect, extra):
        self.label, self.rect, self.extra = label, rect, extra

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        _record(self.label, self.t0, time.time_ns(), self.rect, self.extra)
        return False


class _NoSpan:
    """The span of a disabled tracer: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def trace_span(label: str, rect: Optional[Tuple[int, int, int, int]] = None,
               **extra):
    """Context manager variant (the reference's EVENT_BEGIN/END pair).
    With tracing off it returns one shared no-op context manager: no clock
    read, nothing recorded."""
    if not _ENABLED:
        return _NO_SPAN
    return _Span(label, rect, extra)


def events_ns() -> List[Tuple[str, int, int]]:
    """The recorded events as (label, begin_ns, end_ns) on the
    ``time.time_ns()`` clock."""
    return [(e["label"], _T0 + round(e["begin"] * 1e9), _T0 + round(e["end"] * 1e9))
            for e in _EVENTS]


def dump_trace(path: str = "trace.json", n: Optional[int] = None) -> str:
    """Write recorded events to JSON (the reference's trace.dat analogue)."""
    with open(path, "w") as f:
        json.dump({"n": n, "events": _EVENTS}, f)
    return path
