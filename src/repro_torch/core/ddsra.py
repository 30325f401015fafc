"""DDSRA — dynamic device scheduling and resource allocation (Algorithm 1).

Per communication round:
  1. For every (gateway m, channel j) independently ("do in parallel" in the
     paper): block-coordinate descent over DNN partition points ``l_n`` (21,
     bisection), gateway frequency split ``f^G_{m,n}`` (22, bisection) and
     transmit power ``P_m`` (23)/(24, convex water solve) -> auxiliary delay
     matrix Lambda (18).
  2. Channel assignment (26)-(29): iterate the auxiliary cap ``lambda`` with
     the Hungarian method on the composite cost Theta.
  3. Virtual queue update (14).

Host-side numpy, the port's copy of ``repro.core.ddsra``: the same
operations in the same order, so decisions and queues are bit-identical to
the reference's (``tests/test_torch_control_plane.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.hungarian import assign_channels
from repro_torch.core.lyapunov import update_queues
from repro_torch.core.network import ChannelState, Network

_PSI = 1e18     # "extremely large positive value" in (29)


@dataclasses.dataclass
class Workload:
    """Layer-level training workload (from repro_torch.core.costmodel)."""
    flops: np.ndarray        # (L,) o_l + o'_l per sample
    mem: np.ndarray          # (L,) g_l bytes (training batch already folded in)
    gamma: float             # model size, bytes
    k_iters: int             # local epochs K
    d_tilde: np.ndarray      # (N,) training batch sizes

    @property
    def n_layers(self) -> int:
        return len(self.flops)


@dataclasses.dataclass
class GatewaySolution:
    feasible: bool
    delay: float                   # Lambda_{m,j}
    l_split: np.ndarray            # per associated device
    f_gw: np.ndarray               # per associated device (Hz)
    p_tx: float
    e_dev: np.ndarray
    e_gw: float


@dataclasses.dataclass
class RoundDecision:
    """One round's schedule plus the policy's post-decision queue state.

    ``queues`` contract: it must be the Eq. (14) update of the pre-decision
    queues under the *scheduled* indicator ``selected``. Synchronous
    engines apply it verbatim. Under ``engine="async"`` realized
    participation can diverge from the schedule (churn, stragglers landing
    late), and when it does the simulation *discards* ``queues`` and redoes
    Eq. (14) from the pre-decision queues with the realized indicator
    (``lyapunov.update_queues_realized``) — a policy encoding a different
    queue law in ``queues`` would be silently overridden on exactly those
    rounds, so custom non-Eq.-(14) queue dynamics are only honored on
    synchronous engines (or fault-free async rounds).
    """
    assignment: np.ndarray         # I (M, J)
    selected: np.ndarray           # (M,) bool
    lam: np.ndarray                # (M, J) Lambda
    solutions: dict                # (m, j) -> GatewaySolution
    delay: float                   # tau(t), Eq. (10)
    queues: np.ndarray             # post-update virtual queues


# ---------------------------------------------------------------------------
# inner solvers for one (gateway, channel)
# ---------------------------------------------------------------------------


def _cum(front: np.ndarray) -> np.ndarray:
    """cumulative sums with a leading 0: cum[l] = sum of first l entries."""
    return np.concatenate([[0.0], np.cumsum(front)])


def _train_times(w: Workload, devs: np.ndarray, l: np.ndarray, f_dev: np.ndarray,
                 phi_dev: float, phi_gw: float, f_gw: np.ndarray) -> np.ndarray:
    cumf = _cum(w.flops)
    tot = cumf[-1]
    bottom = cumf[l]
    top = tot - bottom
    with np.errstate(divide="ignore"):
        t_dev = bottom / (phi_dev * f_dev)
        t_gw = np.where(top > 0, top / np.maximum(phi_gw * f_gw, 1e-9), 0.0)
    return w.k_iters * w.d_tilde[devs] * (t_dev + t_gw)


def solve_partition(w: Workload, net: Network, m: int, devs: np.ndarray,
                    f_gw: np.ndarray, st: ChannelState,
                    e_gw_budget: float, iters: int = 40) -> Optional[np.ndarray]:
    """Bisection on eta for sub-problem (21). Returns l (per device) or None."""
    cfg = net.cfg
    cumf, cumg = _cum(w.flops), _cum(w.mem)
    tot_f, tot_g = cumf[-1], cumg[-1]
    f_dev = net.f_dev[devs]
    n_loc = len(devs)
    big_l = w.n_layers

    kd = w.k_iters * w.d_tilde[devs]

    # per-device static upper bounds from C7' (memory) and C10' (energy),
    # all devices at once on the (n_loc, L+1) grid
    mem_ok = cumg <= cfg.g_dev_max                              # (L+1,)
    e_grid = (kd * cfg.v_dev / cfg.phi_dev * f_dev ** 2)[:, None] * cumf[None, :]
    ok_static = mem_ok[None, :] & (e_grid <= st.e_dev[devs][:, None])
    if not ok_static.any(axis=1).all():
        return None
    hi_static = big_l - np.argmax(ok_static[:, ::-1], axis=1)

    # per-device time at every cut, hoisted out of the bisection: (n_loc, L+1)
    t_grid = kd[:, None] * (
        cumf[None, :] / (cfg.phi_dev * f_dev)[:, None]
        + (tot_f - cumf[None, :]) / np.maximum(cfg.phi_gw * f_gw, 1e-9)[:, None])
    ls_ok_static = np.arange(big_l + 1)[None, :] <= hi_static[:, None]
    gw_e_coef = kd * cfg.v_gw / cfg.phi_gw * f_gw ** 2

    def feasible(eta: float) -> Optional[np.ndarray]:
        """Largest l per device with time <= eta (within static bounds),
        then check joint gateway constraints C8' and C9'."""
        ok = (t_grid <= eta) & ls_ok_static
        if not ok.any(axis=1).all():
            return None
        # prefer the largest l meeting eta: minimizes gateway load (C8'/C9')
        l_pick = big_l - np.argmax(ok[:, ::-1], axis=1)
        if np.sum(tot_g - cumg[l_pick]) > cfg.g_gw_max:
            return None
        if np.sum(gw_e_coef * (tot_f - cumf[l_pick])) > e_gw_budget:
            return None
        return l_pick

    lo = 0.0
    hi = float(np.max(w.k_iters * w.d_tilde[devs]) * tot_f
               / min(cfg.phi_dev * f_dev.min(), cfg.phi_gw * max(f_gw.min(), 1e-9)))
    best = feasible(hi)
    if best is None:
        return None
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        sol = feasible(mid)
        if sol is not None:
            hi, best = mid, sol
        else:
            lo = mid
    return best


def solve_frequency(w: Workload, net: Network, devs: np.ndarray, l: np.ndarray,
                    st: ChannelState, e_gw_budget: float,
                    iters: int = 40) -> Optional[np.ndarray]:
    """Bisection on theta for sub-problem (22)."""
    cfg = net.cfg
    cumf = _cum(w.flops)
    tot = cumf[-1]
    f_dev = net.f_dev[devs]
    dev_t = cumf[l] / (cfg.phi_dev * f_dev)              # per-sample device time
    gw_work = (tot - cumf[l]) / cfg.phi_gw               # cycles on gateway
    kd = w.k_iters * w.d_tilde[devs]

    if np.all(gw_work <= 0):
        return np.full(len(devs), cfg.f_gw_min / max(len(devs), 1))

    def f_of(theta: float) -> Optional[np.ndarray]:
        denom = theta / kd - dev_t
        if (denom <= 0).any():
            return None
        f = gw_work / denom
        f = np.maximum(f, 0.0)
        if f.sum() > cfg.f_gw_max:
            return None
        e = float(np.sum(kd * cfg.v_gw * gw_work * f ** 2))
        if e > e_gw_budget:
            return None
        return f

    lo = float(np.max(kd * (dev_t + gw_work / cfg.f_gw_max)))
    hi = float(np.max(kd * (dev_t + gw_work / max(cfg.f_gw_min / max(len(devs), 1), 1e3))))
    hi = max(hi, lo * 4 + 1.0)
    sol = f_of(hi)
    if sol is None:
        return None
    best = sol
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = f_of(mid)
        if s is not None:
            hi, best = mid, s
        else:
            lo = mid
    return best


def solve_power(net: Network, m: int, j: int, st: ChannelState, gamma: float,
                e_budget: float, iters: int = 60) -> float:
    """(23)/(24): largest transmit power whose upload energy fits e_budget."""
    cfg = net.cfg
    if e_budget <= 0:
        return 0.0
    if net.uplink_energy(m, j, cfg.p_max, gamma, st) <= e_budget:
        return cfg.p_max
    lo, hi = 0.0, cfg.p_max
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if net.uplink_energy(m, j, mid, gamma, st) <= e_budget:
            lo = mid
        else:
            hi = mid
    return lo


def solve_gateway(w: Workload, net: Network, m: int, j: int, st: ChannelState,
                  bcd_iters: int = 4) -> GatewaySolution:
    """Full BCD for one (m, j): returns Lambda_{m,j} and the resources."""
    cfg = net.cfg
    devs = net.devices_of(m)
    n_loc = len(devs)
    infeasible = GatewaySolution(False, np.inf, np.zeros(n_loc, int),
                                 np.zeros(n_loc), 0.0, np.zeros(n_loc), 0.0)
    if n_loc == 0:
        return infeasible

    cumf = _cum(w.flops)
    tot = cumf[-1]
    f_gw = np.full(n_loc, cfg.f_gw_max / n_loc)
    p_tx = cfg.p_max
    l = None
    for _ in range(bcd_iters):
        e_up = net.uplink_energy(m, j, p_tx, w.gamma, st)
        e_budget = st.e_gw[m] - e_up
        l_new = solve_partition(w, net, m, devs, f_gw, st, e_budget)
        if l_new is None:
            return infeasible
        l = l_new
        f_new = solve_frequency(w, net, devs, l, st, e_budget)
        if f_new is None:
            return infeasible
        f_gw = np.maximum(f_new, 1e3)
        e_tra_gw = float(np.sum(
            w.k_iters * w.d_tilde[devs] * cfg.v_gw / cfg.phi_gw
            * (tot - cumf[l]) * f_gw ** 2))
        p_tx = solve_power(net, m, j, st, w.gamma, st.e_gw[m] - e_tra_gw)
        if p_tx <= 0:
            return infeasible

    t_train = float(np.max(_train_times(w, devs, l, net.f_dev[devs],
                                        cfg.phi_dev, cfg.phi_gw, f_gw)))
    t_up = net.uplink_time(m, j, p_tx, w.gamma, st)
    t_down = net.downlink_time(m, j, w.gamma, st)
    lam = t_train + t_up + t_down                       # Eq. (18)
    e_dev = (w.k_iters * w.d_tilde[devs] * cfg.v_dev / cfg.phi_dev
             * cumf[l] * net.f_dev[devs] ** 2)
    e_gw = e_tra_gw + net.uplink_energy(m, j, p_tx, w.gamma, st)
    return GatewaySolution(True, lam, l, f_gw, p_tx, e_dev, e_gw)


# ---------------------------------------------------------------------------
# per-round DDSRA step
# ---------------------------------------------------------------------------


def ddsra_round(w: Workload, net: Network, st: ChannelState, queues: np.ndarray,
                gamma_rates: np.ndarray, v: float) -> RoundDecision:
    cfg = net.cfg
    m_gw, j_ch = cfg.n_gateways, cfg.n_channels

    lam = np.full((m_gw, j_ch), np.inf)
    sols = {}
    for m in range(m_gw):                 # "do in parallel" in Algorithm 1
        for j in range(j_ch):
            sol = solve_gateway(w, net, m, j, st)
            sols[(m, j)] = sol
            lam[m, j] = sol.delay

    # channel assignment (26)-(31): sweep the lambda cap down the frontier of
    # distinct delay values, solving the Theta assignment (28)-(29) with the
    # Hungarian method at each cap, and keep the best P3 objective. This is
    # the paper's iterative lambda/I(t) solve, run to exhaustion (M*J caps).
    finite = np.isfinite(lam)
    best_eye, best_obj = None, None
    caps = np.unique(lam[finite])[::-1] if finite.any() else []
    for cap in caps:
        theta = np.where(finite & (lam <= cap + 1e-12),
                         -queues[:, None], _PSI)
        # a feasible assignment needs >=1 allowed gateway per channel
        if (theta >= _PSI).all(axis=0).any():
            continue
        eye = assign_channels(theta)
        if (np.where(eye > 0, theta, 0.0) >= _PSI).any():
            continue                       # Hungarian forced a banned pair
        tau = float(np.where(eye > 0, lam, -np.inf).max())
        obj = v * tau - float(np.sum(queues * eye.sum(axis=1)))
        if best_obj is None or obj < best_obj - 1e-12:
            best_obj, best_eye = obj, eye

    if best_eye is None:                   # nothing feasible this round
        best_eye = np.zeros((m_gw, j_ch))
    eye = best_eye
    selected = eye.sum(axis=1) > 0
    sel_lam = np.where(eye > 0, lam, -np.inf)
    tau = float(sel_lam.max()) if selected.any() else 0.0
    new_q = update_queues(queues, selected, gamma_rates)
    return RoundDecision(eye, selected, lam, sols, tau, new_q)
