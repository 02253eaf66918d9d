"""Expert configuration dataclasses.

TPU-native re-design of the reference's expert config structs
(reference: ``src/include/starneig/expert.h``): four dataclasses with the
same tunables and the same ``-1 == auto`` sentinel semantics; the auto
formulas are cloned from the reference so convergence behaviour matches
(reference: Appendix-A constants, ``src/schur/process_args.c``,
``src/hessenberg/interface.c:61-76``, ``src/reorder/interface.c:65-77``,
``src/eigenvectors/generalized/interface.c:83-84``).

TPU-specific deviations:
  * sizes are rounded to multiples of 8 lanes, window sizes to the VPU/MXU
    friendly granularity (the reference rounds to 8 as well);
  * "workers" (StarPU worker count) is replaced by the device count of the
    active mesh — on a single chip the task-DAG worker concept does not
    exist, XLA owns the schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

AUTO = -1


def _round8(x: float) -> int:
    return max(8, int(math.ceil(x / 8.0)) * 8)


class DeflationCriterion:
    """Deflation threshold styles (reference: expert.h:336-361, schur/core.c:2428-2462)."""

    NORM_STABLE = "norm-stable"  # u * ||A||_F (default)
    LAPACK = "lapack"            # classic per-entry |h| <= u*(|h11|+|h22|)


@dataclasses.dataclass
class HessenbergConf:
    """Hessenberg reduction tunables (reference: expert.h:77-90)."""

    tile_size: int = AUTO
    panel_width: int = AUTO

    def resolve(self, n: int, workers: int = 1) -> "HessenbergConf":
        c = dataclasses.replace(self)
        if c.tile_size == AUTO:
            # reference: hessenberg/interface.c:61-63
            c.tile_size = max(256, min(4096, _round8(n / math.sqrt(8.0 * max(1, workers)))))
        if c.panel_width == AUTO:
            # fitted linear model, reference: hessenberg/interface.c:73-76
            c.panel_width = max(64, _round8(0.001875596476 * n + 273.59))
        return c


@dataclasses.dataclass
class SchurConf:
    """Multishift QR/QZ tunables (reference: expert.h:198-361)."""

    iteration_limit: int = AUTO          # per segment; default 300
    tile_size: int = AUTO
    small_limit: int = AUTO              # below this, run dense small-QR directly
    aed_window_size: int = AUTO
    aed_shift_count: int = AUTO
    aed_nibble: int = AUTO               # skip sweep if AED converged > nibble% of window
    # accepted for API parity, no-op on TPU: the reference gates whether a
    # large AED runs as its own parallel task DAG (expert.h:253-265); here
    # the AED window solve is always one fused device kernel, and the TPU
    # window cap (128-lane tile) sits below the soft limit anyway
    aed_parallel_soft_limit: int = AUTO
    aed_parallel_hard_limit: int = AUTO
    window_size: int = AUTO              # bulge-chasing window ("rounded" = 2*tile)
    shifts_per_window: int = AUTO
    # accepted for API parity, no-op on TPU: off-window updates run at full
    # matrix width — one wide GEMM feeds the MXU better than any tiling
    # these knobs could express (see ops/schur.py:schur docstring)
    update_width: int = AUTO
    update_height: int = AUTO
    left_threshold: str | float = DeflationCriterion.NORM_STABLE
    right_threshold: str | float = DeflationCriterion.NORM_STABLE
    inf_threshold: str | float = DeflationCriterion.NORM_STABLE

    def resolve(self, n: int, workers: int = 1) -> "SchurConf":
        c = dataclasses.replace(self)
        if c.iteration_limit == AUTO:
            c.iteration_limit = 300  # reference: process_args.c:270-271
        if c.tile_size == AUTO:
            # reference: process_args.c:50-114 (0.02*n rounded to 8, floor 32)
            c.tile_size = max(32, _round8(0.02 * n))
        if c.small_limit == AUTO:
            # reference: max(300, 2*tile) (process_args.c:285-287) — tuned for
            # LAPACK dhseqr small solves; our jitted Francis solver favors a
            # lower crossover so AED + multishift trains handle more range
            c.small_limit = max(64, 2 * c.tile_size)
        if c.aed_window_size == AUTO:
            c.aed_window_size = _aed_staircase(n, 0.08, divide=0.7)
        if c.aed_shift_count == AUTO:
            c.aed_shift_count = _aed_staircase(n, 0.06, divide=1.0)
        # shifts come in pairs
        c.aed_shift_count = max(2, (c.aed_shift_count // 2) * 2)
        if c.aed_nibble == AUTO:
            c.aed_nibble = 40  # process_args.c:355-356
        if c.aed_parallel_soft_limit == AUTO:
            c.aed_parallel_soft_limit = 600  # process_args.c:369-399
        if c.aed_parallel_hard_limit == AUTO:
            c.aed_parallel_hard_limit = 300
        if c.window_size == AUTO:
            c.window_size = 2 * c.tile_size  # process_args.c:401-418 ("rounded")
        if c.shifts_per_window == AUTO:
            c.shifts_per_window = max(2, (c.window_size // 3 - 2) // 2 * 2)  # process_args.c:207-208
        if c.update_width == AUTO:
            c.update_width = 6 * c.tile_size  # process_args.c:212-226
        if c.update_height == AUTO:
            c.update_height = 6 * c.tile_size
        return c


@dataclasses.dataclass
class ReorderConf:
    """Eigenvalue reordering tunables (reference: expert.h:683-757)."""

    plan: str = "multi-part"             # one-part | multi-part (expert.h:439-525)
    blueprint: str = "default"           # accepted for API parity, no-op on
                                         # TPU: window placement is the wave
                                         # grid, not a task blueprint
    # small_window_*: accepted for API parity, no-op on TPU — the reference
    # switches to LAPACK dtrsen below these sizes (expert.h:713-725); the
    # vmapped bubble kernel has no small/large crossover to tune
    tile_size: int = AUTO
    window_size: int = AUTO              # "rounded" = 2*tile aligned to tiles
    values_per_chain: int = AUTO
    small_window_size: int = AUTO
    small_window_threshold: int = AUTO
    update_width: int = AUTO
    update_height: int = AUTO

    def resolve(self, n: int, workers: int = 1, select_ratio: float = 0.35) -> "ReorderConf":
        c = dataclasses.replace(self)
        if c.tile_size == AUTO:
            # reference: reorder/interface.c:65-77 — scaled by selection ratio,
            # capped by per-worker share.
            opt = _round8(max(64.0, (0.5 + select_ratio) * 0.02 * n))
            c.tile_size = max(64, min(opt, _round8(n / max(1, workers))))
        if c.window_size == AUTO:
            c.window_size = 2 * c.tile_size
        if c.values_per_chain == AUTO:
            c.values_per_chain = max(1, c.window_size // 2 - 2)
        if c.small_window_size == AUTO:
            c.small_window_size = 32
        if c.small_window_threshold == AUTO:
            c.small_window_threshold = 64
        if c.update_width == AUTO:
            c.update_width = 6 * c.tile_size
        if c.update_height == AUTO:
            c.update_height = 6 * c.tile_size
        return c


@dataclasses.dataclass
class EigenvectorsConf:
    """Eigenvector back-substitution tunables (reference: expert.h:785-792)."""

    tile_size: int = AUTO

    def resolve(self, n: int, workers: int = 1) -> "EigenvectorsConf":
        c = dataclasses.replace(self)
        if c.tile_size == AUTO:
            # reference: eigenvectors/generalized/interface.c:83-84
            c.tile_size = max(64, _round8(0.016 * n))
        return c


def _aed_staircase(n: int, frac: float, divide: float) -> int:
    """LAPACK-style staircase for AED window / shift count.

    reference: schur/process_args.c:116-162 — min values {2,4,10,interp,64,
    128,256} by problem size, then max(min_val/divide, frac*n).
    """
    if n < 30:
        mv = 2
    elif n < 60:
        mv = 4
    elif n < 150:
        mv = 10
    elif n < 590:
        # smooth interpolation 10 -> 64 (LAPACK dlaqr0's nibble table shape)
        mv = int(round(n / math.log2(n)))
    elif n < 3000:
        mv = 64
    elif n < 6000:
        mv = 128
    else:
        mv = 256
    val = max(mv / divide, frac * n)
    return max(4, int(math.ceil(val / 2.0)) * 2)
