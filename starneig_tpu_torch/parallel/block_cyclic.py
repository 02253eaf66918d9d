"""2D-block-cyclic layout interop (the reference's BLACS layer analogue).

The port's own copy of ``starneig_tpu/parallel/block_cyclic.py`` (numpy
only).  The reference interoperates with ScaLAPACK/BLACS by converting its
distributed matrices to/from 2D-block-cyclic layouts in place
(``src/mpi/blacs_matrix.c``, API ``starneig/blacs_matrix.h:88-309``).  No
BLACS world is joined here; what remains useful is host-side conversion
between global arrays and 2D-block-cyclic local blocks, so users migrating
ScaLAPACK data (or writing interop files) can move data in and out of
this framework.

Layout convention matches ScaLAPACK: process grid (P_r, P_c), block size
(mb, nb); global block (I, J) lives on process (I mod P_r, J mod P_c).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockCyclicDescr:
    """Minimal ScaLAPACK-style descriptor (array descriptor DESC_)."""

    m: int
    n: int
    mb: int
    nb: int
    prows: int
    pcols: int

    def owner(self, bi: int, bj: int) -> Tuple[int, int]:
        return bi % self.prows, bj % self.pcols


def scatter(A: np.ndarray, descr: BlockCyclicDescr
            ) -> Dict[Tuple[int, int], np.ndarray]:
    """Global array -> per-process local arrays (blacs 'copy to' direction)."""
    m, n, mb, nb = descr.m, descr.n, descr.mb, descr.nb
    locals_: Dict[Tuple[int, int], list] = {}
    nbr = -(-m // mb)
    nbc = -(-n // nb)
    # local row/col index of each global block on its owner
    for pr in range(descr.prows):
        for pc in range(descr.pcols):
            rows = [bi for bi in range(nbr) if bi % descr.prows == pr]
            cols = [bj for bj in range(nbc) if bj % descr.pcols == pc]
            lm = sum(min(mb, m - bi * mb) for bi in rows)
            ln = sum(min(nb, n - bj * nb) for bj in cols)
            loc = np.zeros((lm, ln), A.dtype)
            r0 = 0
            for bi in rows:
                h = min(mb, m - bi * mb)
                c0 = 0
                for bj in cols:
                    w = min(nb, n - bj * nb)
                    loc[r0:r0 + h, c0:c0 + w] = \
                        A[bi * mb:bi * mb + h, bj * nb:bj * nb + w]
                    c0 += w
                r0 += h
            locals_[(pr, pc)] = loc
    return locals_


def gather(locals_: Dict[Tuple[int, int], np.ndarray],
           descr: BlockCyclicDescr) -> np.ndarray:
    """Per-process local arrays -> global array ('copy from' direction)."""
    m, n, mb, nb = descr.m, descr.n, descr.mb, descr.nb
    A = np.zeros((m, n), next(iter(locals_.values())).dtype)
    nbr = -(-m // mb)
    nbc = -(-n // nb)
    for pr in range(descr.prows):
        for pc in range(descr.pcols):
            loc = locals_[(pr, pc)]
            rows = [bi for bi in range(nbr) if bi % descr.prows == pr]
            cols = [bj for bj in range(nbc) if bj % descr.pcols == pc]
            r0 = 0
            for bi in rows:
                h = min(mb, m - bi * mb)
                c0 = 0
                for bj in cols:
                    w = min(nb, n - bj * nb)
                    A[bi * mb:bi * mb + h, bj * nb:bj * nb + w] = \
                        loc[r0:r0 + h, c0:c0 + w]
                    c0 += w
                r0 += h
    return A
