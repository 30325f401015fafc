"""Device-scheduling policies: DDSRA + the paper's four baselines (port of
``repro.core.schedulers``).

All schedulers share one interface: ``schedule(ctx) -> RoundDecision`` where
ctx carries the drawn channel state, queues and feedback (losses). Baselines
fix the partition point, transmit power and frequency split ("the baseline
schemes fix the transmit power, computation frequency and the DNN partition
point", Sec. VII-C); a baseline round *fails* for a gateway whose fixed
resources violate the energy/memory constraints. Host numpy, the same
arithmetic in the same order as the reference's, so decisions, queues and
delays are bit-identical.

Two class-level flags say what a policy can do beyond ``schedule``:

* ``traced_decide``: the policy's whole decide trajectory can run as
  batched tensor rounds on the device (``ddsra_jax`` through
  ``repro_torch.core.ddsra_batched``; the fixed-resource ``round_robin``,
  ``random`` and ``delay_driven`` through
  ``repro_torch.core.baseline_batched``), which ``Simulation.sweep``
  uses; ``plan_for`` gives the plan and ``traced_chosen`` the baselines'
  gateway picks.
* ``reads_losses``: the policy's decisions depend on training feedback
  (``ctx.losses``), so decide and train cannot be phase-separated (only
  ``loss_driven``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.ddsra import (GatewaySolution, RoundDecision, Workload,
                                    _cum, _train_times, ddsra_round)
from repro_torch.core.lyapunov import update_queues
from repro_torch.core.network import ChannelState, Network


@dataclasses.dataclass
class RoundContext:
    t: int
    workload: Workload
    net: Network
    state: ChannelState
    queues: np.ndarray
    gamma_rates: np.ndarray        # participation-rate targets
    v: float
    losses: Optional[np.ndarray] = None   # (M,) last local losses
    # (M,) updates dispatched but not yet landed at the server, per gateway
    # (None under synchronous engines, the only kind this slice has)
    inflight: Optional[np.ndarray] = None


def _fixed_resource_solution(ctx: RoundContext, m: int, j: int,
                             l_frac: float = 0.5) -> GatewaySolution:
    """Evaluate a gateway at FIXED resources (baselines)."""
    net, st, w = ctx.net, ctx.state, ctx.workload
    cfg = net.cfg
    devs = net.devices_of(m)
    n_loc = len(devs)
    big_l = w.n_layers
    l = np.full(n_loc, int(round(l_frac * big_l)), dtype=int)
    f_gw = np.full(n_loc, cfg.f_gw_max / max(n_loc, 1))
    p_tx = cfg.p_max

    cumf, cumg = _cum(w.flops), _cum(w.mem)
    tot_f, tot_g = cumf[-1], cumg[-1]
    e_dev = (w.k_iters * w.d_tilde[devs] * cfg.v_dev / cfg.phi_dev
             * cumf[l] * net.f_dev[devs] ** 2)
    e_tra_gw = float(np.sum(w.k_iters * w.d_tilde[devs] * cfg.v_gw / cfg.phi_gw
                            * (tot_f - cumf[l]) * f_gw ** 2))
    e_up = net.uplink_energy(m, j, p_tx, w.gamma, st)
    mem_dev_ok = (cumg[l] <= cfg.g_dev_max).all()
    mem_gw_ok = float(np.sum(tot_g - cumg[l])) <= cfg.g_gw_max
    ok = (mem_dev_ok and mem_gw_ok and (e_dev <= st.e_dev[devs]).all()
          and (e_tra_gw + e_up) <= st.e_gw[m])

    t_train = float(np.max(_train_times(w, devs, l, net.f_dev[devs],
                                        cfg.phi_dev, cfg.phi_gw, f_gw)))
    lam = (t_train + net.uplink_time(m, j, p_tx, w.gamma, st)
           + net.downlink_time(m, j, w.gamma, st))
    return GatewaySolution(bool(ok), lam, l, f_gw, p_tx, e_dev,
                           e_tra_gw + e_up)


def _decision_for(ctx: RoundContext, chosen: np.ndarray) -> RoundDecision:
    """Build a RoundDecision for baseline scheduler given chosen gateways."""
    net = ctx.net
    m_gw, j_ch = net.cfg.n_gateways, net.cfg.n_channels
    eye = np.zeros((m_gw, j_ch))
    lam = np.full((m_gw, j_ch), np.inf)
    sols: Dict = {}
    for j, m in enumerate(chosen[:j_ch]):
        sol = _fixed_resource_solution(ctx, int(m), j)
        sols[(int(m), j)] = sol
        lam[int(m), j] = sol.delay
        eye[int(m), j] = 1.0
    selected = eye.sum(axis=1) > 0
    tau = float(np.where(eye > 0, lam, -np.inf).max())
    new_q = update_queues(ctx.queues, selected, ctx.gamma_rates)
    return RoundDecision(eye, selected, lam, sols, tau, new_q)


# ---------------------------------------------------------------------------
# policy registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Registry entry: scheduler class + the constructor kwargs it accepts.

    ``kwargs`` names the simulation-provided values (e.g. ``seed``) threaded
    into the constructor by :func:`make_policy`, so stochastic policies get
    seeded uniformly instead of by name-matching at the call site.
    """
    name: str
    cls: Type
    kwargs: Tuple[str, ...] = ()


POLICIES: Dict[str, PolicySpec] = {}


def register_policy(name: str, *, kwargs: Sequence[str] = ()):
    """Class decorator registering a scheduling policy under ``name``.

    Registering a duplicate name raises — silent shadowing of a policy would
    corrupt every sweep that selects schedulers by name.
    """
    def deco(cls):
        if name in POLICIES:
            raise ValueError(f"policy {name!r} already registered "
                             f"(by {POLICIES[name].cls.__name__})")
        POLICIES[name] = PolicySpec(name, cls, tuple(kwargs))
        cls.name = name
        return cls
    return deco


def make_policy(name: str, **context: Any):
    """Instantiate policy ``name``, threading the registry-declared subset of
    ``context`` (e.g. ``seed=cfg.seed``) into its constructor."""
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")
    spec = POLICIES[name]
    return spec.cls(**{k: context[k] for k in spec.kwargs if k in context})


def policy_state(policy) -> Optional[dict]:
    """JSON-serializable internal state of a policy (None if stateless).

    Any policy carrying a ``numpy.random.Generator`` named ``rng`` is
    checkpointable by default; policies with richer state can override
    ``state_dict()`` / ``load_state_dict()``.
    """
    if hasattr(policy, "state_dict"):
        return policy.state_dict()
    rng = getattr(policy, "rng", None)
    if isinstance(rng, np.random.Generator):
        return {"rng": rng.bit_generator.state}
    return None


def set_policy_state(policy, state: Optional[dict]) -> None:
    if state is None:
        return
    if hasattr(policy, "load_state_dict"):
        policy.load_state_dict(state)
        return
    if "rng" in state and isinstance(getattr(policy, "rng", None),
                                     np.random.Generator):
        policy.rng.bit_generator.state = state["rng"]


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


@register_policy("ddsra")
class DDSRAScheduler:
    """The paper's Algorithm 1, host-side numpy (the parity oracle)."""

    def schedule(self, ctx: RoundContext) -> RoundDecision:
        return ddsra_round(ctx.workload, ctx.net, ctx.state, ctx.queues,
                           ctx.gamma_rates, ctx.v)


@register_policy("ddsra_jax", kwargs=("device",))
class DDSRAJaxScheduler:
    """Algorithm 1 as batched torch float64 on ``device`` (the registry
    name is the reference's, ``repro.core.schedulers.DDSRAJaxScheduler``;
    the plan is ``repro_torch.core.ddsra_batched.DDSRAPlan``): one CUDA
    graph replay a round on a card, eager tensor rounds on the CPU. Emits
    the same :class:`RoundDecision` as ``"ddsra"``: identical assignments
    and cuts, Lambda and tau within 1e-6, while capturing exactly one graph
    per network shape."""

    # the decide trajectory runs as batched rounds on the device
    traced_decide = True

    def __init__(self, device="cuda"):
        self.device = device
        self._plans: Dict[int, Tuple[Any, Any, Any]] = {}

    def plan_for(self, workload, net):
        """One DDSRAPlan per (net, workload) pair on this policy's device,
        keyed by identity (both are built once per Simulation and reused
        across rounds)."""
        from repro_torch.core.ddsra_batched import DDSRAPlan
        key = (id(net), id(workload))
        hit = self._plans.get(key)
        if hit is None or hit[0] is not net or hit[1] is not workload:
            self._plans[key] = (net, workload,
                                DDSRAPlan.build(workload, net, self.device))
        return self._plans[key][2]

    def schedule(self, ctx: RoundContext) -> RoundDecision:
        return self.plan_for(ctx.workload, ctx.net).round(
            ctx.state, ctx.queues, ctx.gamma_rates, ctx.v)


class _TracedBaseline:
    """Mixin: batched decide support for the fixed-resource baselines.

    A baseline round at fixed resources is pure data (the gateway picks)
    plus the feasibility/delay evaluation ``repro_torch.core.
    baseline_batched`` runs on tensors. Subclasses supply the picks via
    :meth:`traced_chosen`, which :meth:`BaselinePlan.decide_scan` takes as
    its round axis."""

    traced_decide = True

    def plan_for(self, workload, net, device="cuda"):
        """One BaselinePlan per (net, workload, device), keyed by identity
        (the DDSRAJaxScheduler caching contract). The baselines decide on
        the host, so the plan's device is the caller's to name."""
        from repro_torch.core.baseline_batched import BaselinePlan
        cache = getattr(self, "_plans", None)
        if cache is None:
            cache = self._plans = {}
        key = (id(net), id(workload), str(device))
        hit = cache.get(key)
        if hit is None or hit[0] is not net or hit[1] is not workload:
            cache[key] = (net, workload,
                          BaselinePlan.build(workload, net, device=device))
        return cache[key][2]

    def traced_chosen(self, t0: int, rounds: int, net: Network) -> np.ndarray:
        """(rounds, J) gateway picks for rounds ``t0 .. t0+rounds-1``."""
        raise NotImplementedError


@register_policy("random", kwargs=("seed",))
class RandomScheduler(_TracedBaseline):
    """Random Scheduling [26]: uniform J gateways per round, drawn from the
    policy's own generator (checkpointed by :func:`policy_state`)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def schedule(self, ctx: RoundContext) -> RoundDecision:
        m, j = ctx.net.cfg.n_gateways, ctx.net.cfg.n_channels
        chosen = self.rng.choice(m, size=j, replace=False)
        return _decision_for(ctx, chosen)

    def traced_chosen(self, t0: int, rounds: int, net: Network) -> np.ndarray:
        """Pre-draw every round's picks from the policy RNG: one
        ``rng.choice`` per round, exactly the stepwise draws, so the policy
        RNG state afterwards matches stepwise."""
        m, j = net.cfg.n_gateways, net.cfg.n_channels
        return np.stack([self.rng.choice(m, size=j, replace=False)
                         for _ in range(rounds)])


@register_policy("round_robin")
class RoundRobinScheduler(_TracedBaseline):
    """Round Robin [26]: consecutive groups of J gateways."""

    def schedule(self, ctx: RoundContext) -> RoundDecision:
        m, j = ctx.net.cfg.n_gateways, ctx.net.cfg.n_channels
        start = (ctx.t * j) % m
        chosen = (start + np.arange(j)) % m
        return _decision_for(ctx, chosen)

    def traced_chosen(self, t0: int, rounds: int, net: Network) -> np.ndarray:
        m, j = net.cfg.n_gateways, net.cfg.n_channels
        starts = (np.arange(t0, t0 + rounds) * j) % m
        return (starts[:, None] + np.arange(j)[None, :]) % m


@register_policy("loss_driven")
class LossDrivenScheduler:
    """Select the J gateways with the largest recent local loss."""

    # decisions depend on training feedback (ctx.losses)
    reads_losses = True

    def schedule(self, ctx: RoundContext) -> RoundDecision:
        m, j = ctx.net.cfg.n_gateways, ctx.net.cfg.n_channels
        losses = ctx.losses if ctx.losses is not None else np.zeros(m)
        chosen = np.argsort(-losses)[:j]
        return _decision_for(ctx, chosen)


@register_policy("delay_driven")
class DelayDrivenScheduler(_TracedBaseline):
    """Select the J gateways with the smallest fixed-resource delay."""

    def schedule(self, ctx: RoundContext) -> RoundDecision:
        m, j = ctx.net.cfg.n_gateways, ctx.net.cfg.n_channels
        # evaluate each gateway on its best channel at fixed resources
        delays = np.array([
            min(_fixed_resource_solution(ctx, mm, jj).delay for jj in range(j))
            for mm in range(m)])
        chosen = np.argsort(delays)[:j]
        return _decision_for(ctx, chosen)

    def traced_chosen(self, t0: int, rounds: int, net: Network) -> None:
        """The greedy pick is a function of the round's channel draws, not
        data: None tells :meth:`BaselinePlan.decide_scan` to compute it in
        each round."""
        return None


# legacy name -> class view of the registry (prefer make_policy / POLICIES)
SCHEDULERS = {name: spec.cls for name, spec in POLICIES.items()}
