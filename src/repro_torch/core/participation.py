"""Device-specific participation rate (paper Sec. IV).

Theorem 1 divergence bound:
    Phi_m = sum_n (a_mn D~_n / sum_n a_mn D~_n)
            * (sigma_n / (L_n sqrt(D~_n)) + delta_n / L_n)
            * ((beta L_n + 1)^K - 1)
Eq. (13):
    Gamma_m = min(J * (1/Phi_m) / sum_m (1/Phi_m), 1)
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataStats:
    """Per-device statistics estimated from the training process."""
    sigma: np.ndarray    # (N,) per-sample gradient variance bound
    delta: np.ndarray    # (N,) local-vs-global gradient divergence
    lipschitz: np.ndarray  # (N,) smoothness constants L_n
    d_tilde: np.ndarray  # (N,) training batch sizes


def divergence_bound(stats: DataStats, assign: np.ndarray,
                     beta: float, k_epochs: int) -> np.ndarray:
    """Phi_m per gateway. assign: (N,) device -> gateway index."""
    n = len(stats.sigma)
    m = int(assign.max()) + 1
    phi = np.zeros(m)
    for g in range(m):
        devs = np.where(assign == g)[0]
        w = stats.d_tilde[devs]
        w = w / w.sum()
        term = (stats.sigma[devs] / (stats.lipschitz[devs] * np.sqrt(stats.d_tilde[devs]))
                + stats.delta[devs] / stats.lipschitz[devs])
        growth = (beta * stats.lipschitz[devs] + 1.0) ** k_epochs - 1.0
        phi[g] = float(np.sum(w * term * growth))
    return phi


def participation_rates(phi: np.ndarray, n_channels: int) -> np.ndarray:
    """Eq. (13). Gateways with smaller divergence get larger Gamma_m."""
    inv = 1.0 / np.maximum(phi, 1e-12)
    gamma = n_channels * inv / inv.sum()
    return np.minimum(gamma, 1.0)


# ---------------------------------------------------------------------------
# online estimators (the paper "estimates by observing the model parameters")
# ---------------------------------------------------------------------------


def estimate_sigma(per_sample_grads: np.ndarray, mean_grad: np.ndarray) -> float:
    """Assumption 1: E || grad_i - grad_mean || <= sigma_n."""
    diffs = per_sample_grads - mean_grad[None]
    return float(np.mean(np.linalg.norm(diffs.reshape(len(diffs), -1), axis=1)))


def estimate_delta(local_grad: np.ndarray, global_grad: np.ndarray) -> float:
    """Assumption 2: || grad F_n - grad F || <= delta_n."""
    return float(np.linalg.norm(local_grad - global_grad))


def estimate_lipschitz(g1: np.ndarray, g2: np.ndarray,
                       w1: np.ndarray, w2: np.ndarray) -> float:
    """L_n >= ||∇F(w1) - ∇F(w2)|| / ||w1 - w2||."""
    dw = np.linalg.norm(w1 - w2)
    if dw < 1e-12:
        return 1.0
    return float(np.linalg.norm(g1 - g2) / dw)
