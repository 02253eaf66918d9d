"""Seeded inputs for checking the reordering kernel against its plain twin
(numpy only)."""

from __future__ import annotations

import numpy as np


def planted_windows(G: int, W: int, seed: int):
    """G (W, W) quasi-triangular windows and their block-aligned selections.

    Every fifth row from row 1 starts a standardized 2x2 block (a complex
    pair), and each block is selected with probability 1/2.  Window 0 also
    holds two equal adjacent 2x2 blocks at rows 6 and 8 with the lower one
    selected: the Sylvester equation of their swap is singular, so that
    swap is rejected.  Returns (Ts (G, W, W), sels (G, W) bool).
    """
    rng = np.random.default_rng(seed)
    Ts, sels = [], []
    for g in range(G):
        T = np.triu(rng.standard_normal((W, W)))
        for p in range(1, W - 2, 5):
            T[p + 1, p] = -abs(rng.standard_normal())
            T[p, p + 1] = abs(rng.standard_normal())
            T[p + 1, p + 1] = T[p, p]
        sel = np.zeros(W, bool)
        i = 0
        while i < W:
            sz = 2 if i + 1 < W and T[i + 1, i] != 0 else 1
            sel[i:i + sz] = rng.random() < 0.5
            i += sz
        if g == 0 and W >= 10:
            for p in (6, 8):
                T[p:p + 2, p:p + 2] = [[1.0, 2.0], [-0.5, 1.0]]
            T[6:8, 8:10] = [[3.0, -1.0], [2.0, 5.0]]
            sel[6:8], sel[8:10] = False, True
        Ts.append(T)
        sels.append(sel)
    return np.stack(Ts), np.stack(sels)
