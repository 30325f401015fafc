"""Hungarian method (Kuhn-Munkres, potentials variant, O(n^3)).

Used by DDSRA to solve the weighted bipartite channel-assignment problem
(26)-(29): each of the J channels must be assigned to exactly one gateway
(C3), each gateway takes at most one channel (C2).

Two implementations of the same algorithm live here:

* :func:`hungarian_min` / :func:`assign_channels`: host-side numpy, with
  first-minimum ``argmin`` tie-breaks, so assignments are identical to
  ``repro.core.hungarian.hungarian_min``'s (the parity oracle);
* :func:`hungarian_min_t` / :func:`assign_channels_t`: the same potentials
  algorithm on tensors, batched over any leading axes (port of
  ``hungarian_min_jax`` / ``assign_channels_jax``). The two data-dependent
  loops become fixed trip counts: while row ``i`` is inserted, at most
  ``i - 1`` columns are matched, so the alternating tree grows at most
  ``i`` times and the augmenting path unrolls at most ``i`` steps. A lane
  that is done is frozen by a mask, so every lane follows the numpy
  control flow step for step (same potentials, same first-minimum
  tie-breaks, the same assignment), with no host sync: a CUDA graph can
  capture it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# batched tensor form (fixed trip counts, no host sync)
# ---------------------------------------------------------------------------


def hungarian_min_t(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`hungarian_min` on a batch: cost (..., R, C) with R <= C.

    Returns (col_of_row (..., R) int64, total_cost (...,)), each lane's
    assignment identical to the numpy oracle's on that lane's matrix."""
    *batch, r, c = cost.shape
    assert r <= c, "rows must be <= cols (pad the caller otherwise)"
    inf = 1e30
    dev, dt = cost.device, cost.dtype
    u = torch.zeros((*batch, r + 1), device=dev, dtype=dt)
    v = torch.zeros((*batch, c + 1), device=dev, dtype=dt)
    # p[col] = row matched to col (1-based), way[col] = previous column
    p = torch.zeros((*batch, c + 1), device=dev, dtype=torch.long)
    way = torch.zeros_like(p)
    cols = torch.arange(c + 1, device=dev)

    def at(x, j):                          # x[..., j] for a per-lane j
        return x.gather(-1, j[..., None]).squeeze(-1)

    for i in range(1, r + 1):
        p[..., 0] = i
        j0 = torch.zeros(batch, device=dev, dtype=torch.long)
        minv = torch.full((*batch, c), inf, device=dev, dtype=dt)
        used = torch.zeros((*batch, c + 1), device=dev, dtype=torch.bool)
        for _ in range(i):                 # grow the alternating tree
            i0 = at(p, j0)
            live = i0 != 0                 # numpy: loop until p[j0] == 0
            used = used | (live[..., None] & (cols == j0[..., None]))
            free = ~used[..., 1:]
            row = cost.gather(-2, (i0 - 1).clamp_min(0)[..., None, None]
                              .expand(*batch, 1, c)).squeeze(-2)
            cur = row - at(u, i0)[..., None] - v[..., 1:]
            better = live[..., None] & free & (cur < minv)
            minv = torch.where(better, cur, minv)
            way[..., 1:] = torch.where(better, j0[..., None], way[..., 1:])
            masked = minv.masked_fill(~free, inf)
            j1 = masked.argmin(-1)
            delta = at(masked, j1)
            # delta is finite (at most inf = 1e30), so times 0 is an exact 0
            step = (used & live[..., None]) * delta[..., None]
            # the matched rows of used columns are distinct, so each row
            # gets at most one non-zero term: the sum is exact in any order
            u = u.scatter_add(-1, p, step)
            v = v - step
            minv = torch.where(free & live[..., None], minv - delta[..., None],
                               minv)
            j0 = torch.where(live, j1 + 1, j0)
        for _ in range(i):                 # augment along the path
            live = j0 != 0
            j1 = at(way, j0)
            p = torch.where(live[..., None] & (cols == j0[..., None]),
                            at(p, j1)[..., None], p)
            j0 = torch.where(live, j1, j0)

    # p[1:][j] > 0 means column j matched to row p - 1; row r collects the
    # unmatched columns and is dropped
    rows = torch.where(p[..., 1:] > 0, p[..., 1:] - 1, r)
    col_of_row = torch.full((*batch, r + 1), -1, device=dev,
                            dtype=torch.long).scatter(
        -1, rows, cols[1:].expand(*batch, c) - 1)[..., :r]
    total = cost.gather(-1, col_of_row[..., None]).squeeze(-1).sum(-1)
    return col_of_row, total


def assign_channels_t(theta: torch.Tensor) -> torch.Tensor:
    """:func:`assign_channels` on a batch: theta (..., M, J) -> I (..., M,
    J) in {0, 1}, in theta's dtype."""
    *batch, m, j = theta.shape
    assert j <= m, "need at least as many gateways as channels"
    col_of_row, _ = hungarian_min_t(theta.transpose(-1, -2))
    return torch.zeros_like(theta).scatter(-2, col_of_row[..., None, :], 1.0)
