"""Batched fixed-resource baselines: their decide trajectories as scans
(port of ``repro.core.baseline_jax``).

``round_robin``, ``random`` and ``delay_driven`` fix every resource (the
Sec. VII-C baseline contract: partition point ``l = round(0.5 L)``, even
gateway-frequency split, ``p_max`` transmit power), so a round is the
feasibility check and delay of
``repro_torch.core.schedulers._fixed_resource_solution`` at the chosen
gateways. The gateway choice is data (round-robin's closed form of ``t``,
random's picks pre-drawn from the policy RNG in stepwise order) or, for
``delay_driven``, the greedy pick computed in the round from its channel
draws. The evaluation reuses the link algebra and the padded statics of
:mod:`repro_torch.core.ddsra_batched`, over the same leading lane axis,
and on CUDA each rule's round is one graph per lane count
(:class:`~repro_torch.graphs.GraphedStep`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ddsra import Workload, _cum, _train_times
from repro_torch.core.ddsra_batched import (DDSRAPlan, RoundDecisionT,
                                            _downlink_time, _mall,
                                            _uplink_time)
from repro_torch.core.lyapunov import update_queues_t
from repro_torch.core.network import ChannelStateT, Network
from repro_torch.graphs import GraphedStep, scan_rounds

class _Fixed(NamedTuple):
    """What the fixed operating point (cut ``l0``, ``f_gw_max / n_loc``,
    ``p_max``) makes of each gateway, whatever the round draws: formed on
    the host by the oracle's own arithmetic
    (``_fixed_resource_solution``), padded to (M, n_max)."""
    mem_ok: torch.Tensor    # (M,) bool: C7' and C8' at the cut
    e_dev: torch.Tensor     # (M, n_max) device training energy
    e_tra: torch.Tensor     # (M,) gateway training energy
    t_train: torch.Tensor   # (M,) slowest device's training time


def _fixed_point(w: Workload, net: Network, l0: int, n_max: int,
                 device) -> _Fixed:
    cfg = net.cfg
    cumf, cumg = _cum(w.flops), _cum(w.mem)
    tot_f, tot_g = cumf[-1], cumg[-1]
    m_gw = cfg.n_gateways
    mem_ok, e_tra, t_train = (np.zeros(m_gw, bool), np.zeros(m_gw),
                              np.full(m_gw, -np.inf))
    e_dev = np.zeros((m_gw, n_max))
    for m in range(m_gw):
        devs = net.devices_of(m)
        n_loc = len(devs)
        l = np.full(n_loc, l0, dtype=int)
        f_gw = np.full(n_loc, cfg.f_gw_max / max(n_loc, 1))
        e_dev[m, :n_loc] = (w.k_iters * w.d_tilde[devs] * cfg.v_dev
                            / cfg.phi_dev * cumf[l] * net.f_dev[devs] ** 2)
        e_tra[m] = float(np.sum(w.k_iters * w.d_tilde[devs] * cfg.v_gw
                                / cfg.phi_gw * (tot_f - cumf[l])
                                * f_gw ** 2))
        mem_ok[m] = ((cumg[l] <= cfg.g_dev_max).all()
                     and float(np.sum(tot_g - cumg[l])) <= cfg.g_gw_max)
        if n_loc:
            t_train[m] = float(np.max(_train_times(
                w, devs, l, net.f_dev[devs], cfg.phi_dev, cfg.phi_gw,
                f_gw)))

    def t(x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype).to(device)

    return _Fixed(t(mem_ok, torch.bool), t(e_dev), t(e_tra), t(t_train))


def _solve_fixed(plan: DDSRAPlan, fx: _Fixed, st: ChannelStateT):
    """Feasibility and delay of every gateway on every channel at the fixed
    operating point, for every lane: (ok, lam), each (B, M, J). The
    batched twin of ``_fixed_resource_solution``."""
    s = plan.statics
    c = s.cfg
    t_up = _uplink_time(c, s.gamma8, c.p_max, st.h_up, st.i_up)
    e_ok = _mall(fx.e_dev <= st.e_dev[:, s.dev_idx], s.invalid)   # (B, M)
    ok = (fx.mem_ok & e_ok)[..., None] & (
        (fx.e_tra[:, None] + c.p_max * t_up) <= st.e_gw[..., None])
    lam = (fx.t_train[:, None] + t_up
           + _downlink_time(c, s.gamma8, st.h_down, st.i_down))
    return ok, lam


def _delay_chosen(lam, j_ch: int):
    """The delay-driven greedy pick: each gateway's best-channel delay at
    fixed resources, the ``J`` smallest by a stable argsort (numpy's
    introselect in the host policy agrees whenever delays are distinct,
    which random channel draws make almost sure). (B, J) int64."""
    delays = lam.amin(-1)                                        # (B, M)
    return torch.sort(delays, dim=-1, stable=True).indices[:, :j_ch]


def _baseline_round(plan: DDSRAPlan, fixed, queues, gamma_rates, chosen,
                    *, l0: int) -> RoundDecisionT:
    """One fixed-resource round over every lane, ``fixed`` the round's
    ``_solve_fixed`` and ``chosen`` (B, J) the gateway on each channel:
    the twin of ``_decision_for`` and ``resolve_decision``. Infeasible
    selections fail, the trained gateways' cut scatters into the dense
    per-device vector, and Eq. (14) updates the queues."""
    s = plan.statics
    ok, lam = fixed
    ok_j = ok.gather(1, chosen[:, None]).squeeze(1)                # (B, J)
    lam_j = lam.gather(1, chosen[:, None]).squeeze(1)
    pick = chosen[..., None] == torch.arange(
        plan.n_gateways, device=chosen.device)                  # (B, J, M)
    selected = pick.any(1)
    feas_m = (pick & ok_j[..., None]).any(1)
    lam_m = lam_j[..., None].masked_fill(~pick, torch.inf).amin(1)
    trained = selected & feas_m & torch.isfinite(lam_m)
    failures = (selected & ~trained).sum(-1)
    gw_delay = lam_m.masked_fill(~trained, 0.0)
    delay = lam_m.masked_fill(~trained, -torch.inf).amax(-1).masked_fill(
        ~trained.any(-1), 0.0)
    # the scheduler-reported tau includes infeasible selections' (finite)
    # delays: _decision_for's max over the assigned pairs
    tau = lam_j.amax(-1)
    b = chosen.shape[0]
    vals = (s.valid & trained[..., None]) * l0
    l_dev = torch.zeros((b, plan.n_devices), dtype=torch.long,
                        device=chosen.device).scatter_add_(
        -1, s.dev_idx.reshape(1, -1).expand(b, -1), vals.reshape(b, -1))
    new_q = update_queues_t(queues, selected, gamma_rates)
    return RoundDecisionT(selected=selected, trained=trained, l_dev=l_dev,
                          gw_delay=gw_delay, delay=delay, tau=tau,
                          failures=failures, queues=new_q)


@dataclasses.dataclass
class BaselinePlan:
    """The fixed-resource baselines' control plane for one (Workload,
    Network) pair (port of ``repro.core.baseline_jax.BaselinePlan``).

    Gateway choice is data (the ``chosen`` round axis), so one plan serves
    every choice rule: round-robin feeds its closed-form schedule, random
    its pre-drawn picks, and ``chosen=None`` computes delay-driven's pick
    in each round."""
    ddsra: DDSRAPlan        # the statics, shared with DDSRA's plan
    l0: int                 # the baselines' fixed cut round(0.5 * L)
    fixed: _Fixed

    def __post_init__(self):
        self._chosen = GraphedStep(self._chosen_fn, "baseline")
        self._delay = GraphedStep(self._delay_fn, "baseline")

    @classmethod
    def build(cls, w: Workload, net: Network, l_frac: float = 0.5,
              device="cuda") -> "BaselinePlan":
        d = DDSRAPlan.build(w, net, device)
        l0 = int(round(l_frac * w.n_layers))
        return cls(d, l0, _fixed_point(w, net, l0, d.n_max, d.device))

    @property
    def device(self) -> torch.device:
        return self.ddsra.device

    @property
    def n_gateways(self) -> int:
        return self.ddsra.n_gateways

    def _chosen_fn(self, h_up, h_down, i_up, i_down, e_dev, e_gw, queues,
                   gamma_rates, chosen):
        st = ChannelStateT(h_up, h_down, i_up, i_down, e_dev, e_gw)
        return tuple(_baseline_round(
            self.ddsra, _solve_fixed(self.ddsra, self.fixed, st), queues,
            gamma_rates, chosen, l0=self.l0))

    def _delay_fn(self, h_up, h_down, i_up, i_down, e_dev, e_gw, queues,
                  gamma_rates):
        st = ChannelStateT(h_up, h_down, i_up, i_down, e_dev, e_gw)
        fixed = _solve_fixed(self.ddsra, self.fixed, st)
        return tuple(_baseline_round(
            self.ddsra, fixed, queues, gamma_rates,
            _delay_chosen(fixed[1], self.ddsra.n_channels), l0=self.l0))

    def scan(self, rounds: int, state_at, queues0, gamma_rates,
             chosen=None):
        """``rounds`` rounds over the lanes of ``queues0`` (B, M):
        ``state_at(t)`` gives round t's (B, ...) states, ``chosen`` is the
        (T, B, J) picks, or None for delay-driven's. Returns the stacked
        :class:`RoundDecisionT`, (T, B, ...) leaves."""
        gamma = self.ddsra._t(gamma_rates)
        if chosen is None:
            outs = scan_rounds(self._delay, rounds,
                               lambda t, q: (*state_at(t), q, gamma), queues0)
        else:
            chosen = torch.as_tensor(np.asarray(chosen, np.int64)).to(
                self.device)
            outs = scan_rounds(
                self._chosen, rounds,
                lambda t, q: (*state_at(t), q, gamma, chosen[t]), queues0)
        return RoundDecisionT(*outs)

    def decide_scan(self, states: ChannelStateT, queues, gamma_rates, v, *,
                    chosen=None) -> RoundDecisionT:
        """All rounds' decisions over ``states`` (leading round axis): the
        stacked resolved :class:`RoundDecisionT`, (rounds, ...) leaves.

        ``chosen`` is the (rounds, J) int array of gateway picks;
        ``chosen=None`` selects the delay-driven rule, whose pick is
        computed in each round from its channel draws. ``v`` is accepted
        for interface parity with :meth:`DDSRAPlan.decide_scan` but
        ignored: fixed-resource baselines have no Lyapunov trade-off."""
        del v
        states = states.map(lambda x: x.to(self.device, torch.float64))
        dec = self.scan(states.h_up.shape[0],
                        lambda t: states.map(lambda x: x[t, None]),
                        self.ddsra._t(queues)[None], gamma_rates,
                        None if chosen is None
                        else np.asarray(chosen)[:, None])
        return RoundDecisionT(*[x[:, 0] for x in dec])
