"""Partition-point selection (port of ``repro.core.partition``).

The paper's bisection over the DNN partition point (sub-problem 21), in a
hardware-agnostic form: given a per-layer cost vector and two tiers'
capabilities, pick the cut minimizing the bottleneck tier time. Used by
the two-stage pipeline split of the LM stack
(:mod:`repro_torch.launch.pipeline`), whose tiers are two GPU stages
joined by NVLink. Pure numpy, the reference's arithmetic and tie-break
(the largest cut among the minimal times, relative eps 1e-9) unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tier:
    """One side of the split."""
    throughput: float          # cost-units / s (e.g. FLOP/s * utilization)
    mem_capacity: float        # bytes
    energy_budget: float = np.inf
    energy_per_unit: float = 0.0


def split_time(costs: np.ndarray, l: int, bottom: Tier, top: Tier,
               boundary_bytes: np.ndarray, link_bw: float,
               objective: str = "serial") -> float:
    """Time if layers [0,l) run on `bottom` and [l,L) on `top`.

    objective='serial':     t_bottom + t_top + t_link — the paper's split
                            training (tiers alternate within an iteration).
    objective='bottleneck': max(t_bottom, t_top) + t_link — steady-state
                            pipeline throughput (GPipe over the pod axis).
    boundary_bytes[l] = activation+error traffic across a cut at l.
    """
    c = np.concatenate([[0.0], np.cumsum(costs)])
    t_b = c[l] / bottom.throughput
    t_t = (c[-1] - c[l]) / top.throughput
    t_link = boundary_bytes[l] / link_bw if link_bw > 0 else 0.0
    if objective == "bottleneck":
        return max(t_b, t_t) + t_link
    return t_b + t_t + t_link


def feasible_interval(mem: np.ndarray, bottom: Tier, top: Tier) -> Tuple[int, int]:
    """[lo, hi] cut positions satisfying both memory capacities."""
    g = np.concatenate([[0.0], np.cumsum(mem)])
    tot = g[-1]
    ok = np.where((g <= bottom.mem_capacity) & (tot - g <= top.mem_capacity))[0]
    if len(ok) == 0:
        return (1, 0)  # empty
    return int(ok.min()), int(ok.max())


def best_partition(costs: np.ndarray, mem: np.ndarray, bottom: Tier, top: Tier,
                   boundary_bytes: Optional[np.ndarray] = None,
                   link_bw: float = np.inf,
                   bisect_iters: int = 40,
                   objective: str = "serial") -> Optional[int]:
    """Bisection on the bottleneck time eta (paper's greedy for (21)).

    Returns the cut index l* in [0, L], or None if infeasible.
    The per-eta feasibility check mirrors the paper: compute the interval of
    cuts whose time <= eta, intersect with the memory interval, pick the
    largest (minimises top-tier load).
    """
    big_l = len(costs)
    if boundary_bytes is None:
        boundary_bytes = np.zeros(big_l + 1)
    lo_m, hi_m = feasible_interval(mem, bottom, top)
    if lo_m > hi_m:
        return None
    times = np.array([split_time(costs, l, bottom, top, boundary_bytes, link_bw,
                                 objective) for l in range(big_l + 1)])
    lo_eta, hi_eta = float(times.min()), float(times.max())
    eps = max(times.max(), 1e-300) * 1e-9          # relative tolerance

    def pick(eta: float) -> Optional[int]:
        ok = np.where((times <= eta + eps)
                      & (np.arange(big_l + 1) >= lo_m)
                      & (np.arange(big_l + 1) <= hi_m))[0]
        return int(ok.max()) if len(ok) else None

    best = pick(hi_eta)
    if best is None:
        return None
    for _ in range(bisect_iters):
        mid = 0.5 * (lo_eta + hi_eta)
        cand = pick(mid)
        if cand is not None:
            hi_eta, best = mid, cand
        else:
            lo_eta = mid
    return best


def brute_force_partition(costs: np.ndarray, mem: np.ndarray, bottom: Tier,
                          top: Tier, boundary_bytes: Optional[np.ndarray] = None,
                          link_bw: float = np.inf,
                          objective: str = "serial") -> Optional[int]:
    """Exact argmin, used by tests to validate the bisection."""
    big_l = len(costs)
    if boundary_bytes is None:
        boundary_bytes = np.zeros(big_l + 1)
    lo_m, hi_m = feasible_interval(mem, bottom, top)
    if lo_m > hi_m:
        return None
    ls = np.arange(lo_m, hi_m + 1)
    times = np.array([split_time(costs, l, bottom, top, boundary_bytes, link_bw,
                                 objective) for l in ls])
    # match the bisection's tie-break: largest l among minimal times
    best = times.min()
    eps = max(times.max(), 1e-300) * 1e-9
    return int(ls[np.where(times <= best + eps)[0].max()])
