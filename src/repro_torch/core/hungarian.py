"""Hungarian method (Kuhn-Munkres, potentials variant, O(n^3)).

Used by DDSRA to solve the weighted bipartite channel-assignment problem
(26)-(29): each of the J channels must be assigned to exactly one gateway
(C3), each gateway takes at most one channel (C2). Host-side numpy, with
first-minimum ``argmin`` tie-breaks, so assignments are identical to
``repro.core.hungarian.hungarian_min``'s.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def hungarian_min(cost: np.ndarray) -> Tuple[np.ndarray, float]:
    """Min-cost assignment of rows to columns.

    cost: (R, C) with R <= C. Returns (col_of_row (R,), total_cost).
    """
    cost = np.asarray(cost, float)
    r, c = cost.shape
    assert r <= c, "rows must be <= cols (pad the caller otherwise)"
    INF = 1e30
    u = np.zeros(r + 1)
    v = np.zeros(c + 1)
    p = np.zeros(c + 1, dtype=int)      # p[col] = row matched to col (1-based)
    way = np.zeros(c + 1, dtype=int)

    for i in range(1, r + 1):
        p[0] = i
        j0 = 0
        minv = np.full(c + 1, INF)
        used = np.zeros(c + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            free = ~used[1:]                      # candidate columns 1..c
            # relax all free columns against row i0 at once
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:] = np.where(better, cur, minv[1:])
            way[1:] = np.where(better, j0, way[1:])
            # masked argmin picks the next column to add to the tree
            masked = np.where(free, minv[1:], INF)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            # update potentials (matched rows of used columns are distinct)
            used_j = np.flatnonzero(used)
            u[p[used_j]] += delta
            v[used_j] -= delta
            minv[1:] = np.where(free, minv[1:] - delta, minv[1:])
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    col_of_row = np.full(r, -1, dtype=int)
    for j in range(1, c + 1):
        if p[j] > 0:
            col_of_row[p[j] - 1] = j - 1
    total = float(cost[np.arange(r), col_of_row].sum())
    return col_of_row, total


def assign_channels(theta: np.ndarray) -> np.ndarray:
    """Solve (28): theta (M, J) costs; returns I (M, J) in {0,1}.

    Channels are rows (each channel must be used exactly once, C3); gateways
    are columns (at most one channel each, C2). Requires J <= M.
    """
    m, j = theta.shape
    assert j <= m, "need at least as many gateways as channels"
    col_of_row, _ = hungarian_min(theta.T)     # (J,) gateway per channel
    eye = np.zeros((m, j))
    for ch, gw in enumerate(col_of_row):
        eye[gw, ch] = 1.0
    return eye
