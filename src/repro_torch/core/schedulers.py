"""Device-scheduling policies: the registry and DDSRA.

All schedulers share one interface: ``schedule(ctx) -> RoundDecision`` where
ctx carries the drawn channel state, queues and feedback (losses). The
paper's baselines (random, round robin, loss- and delay-driven) come in a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.ddsra import RoundDecision, Workload, ddsra_round
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
