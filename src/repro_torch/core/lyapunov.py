"""Lyapunov virtual queues and drift-plus-penalty (paper Sec. V-A).

``update_queues`` is the host-side (numpy) Eq. (14) update the DDSRA
scheduler applies every round; ``update_queues_t`` is its tensor twin,
used inside the batched control plane (``repro_torch.core.ddsra_batched``)
so the queue recursion stays on the device across a whole scan. The (M,)
float64 queue vector is the only state threaded between scheduling
rounds; both updates do the same f64 operations in the same order, so a
scan of the tensor update is bit-identical to the stepwise numpy loop.
"""
from __future__ import annotations

import numpy as np
import torch


def update_queues(q: np.ndarray, selected: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """Eq. (14): Q_m(t+1) = max(Q_m(t) - 1_m^t + Gamma_m, 0)."""
    return np.maximum(q - selected.astype(float) + gamma, 0.0)


def update_queues_t(q: torch.Tensor, selected: torch.Tensor,
                    gamma: torch.Tensor) -> torch.Tensor:
    """Eq. (14) on tensors (port of ``repro.core.lyapunov.
    update_queues_jax``); ``selected`` may be bool, promoted like the
    numpy update's ``astype(float)``."""
    return torch.clamp_min(q - selected.to(q.dtype) + gamma, 0.0)


def update_queues_realized(q: np.ndarray, realized: np.ndarray,
                           gamma: np.ndarray) -> np.ndarray:
    """Eq. (14) driven by *realized* (not scheduled) participation.

    Under asynchronous execution the scheduled indicator ``1_m^t`` and what
    actually happened diverge: a selected gateway whose update churned or
    was lost mid-round earned no queue relief, and a straggler's late
    update earns its relief in the round it actually *lands* at the server
    (which may be rounds after it was scheduled, and in a round where the
    gateway was not selected at all). Feeding this realized indicator into
    the queue recursion is how DDSRA reacts to churn: an unreliable
    gateway's virtual queue keeps growing past its scheduled credit, so the
    drift term re-prioritizes it. The arithmetic is identical to
    :func:`update_queues` — the contract here is *which* indicator feeds
    it.
    """
    return update_queues(q, np.asarray(realized, dtype=float), gamma)


def drift_plus_penalty(v: float, tau: float, q: np.ndarray,
                       selected: np.ndarray) -> float:
    """Objective of P2 (Eq. 17): V*tau - sum_m Q_m * 1_m."""
    return v * tau - float(np.sum(q * selected))


def queue_stability_gap(history: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """Empirical participation-rate shortfall after T rounds.

    history: (T, M) 0/1 selections. Returns Gamma_m - (1/T) sum_t 1_m^t
    (positive = constraint C11 violated so far).
    """
    rate = history.mean(axis=0)
    return gamma - rate
