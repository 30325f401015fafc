"""Fault injection for asynchronous FL: churn, stragglers, mid-round dropout
(port of ``repro.fl.faults``, numpy, the same draws in the same order).

Real IIoT fleets are intermittently connected: a device that the scheduler
selects may be offline when the dispatch lands (churn), may train but lose
its update on the way back (mid-round dropout), or may report late (a
straggler with a heavy-tailed extra delay). This module is the *model* of
those faults — a frozen per-scenario :class:`FaultModel` plus one
fixed-shape draw per round (:func:`draw_round_faults`) — consumed by the
buffered :class:`~repro_torch.fl.async_engine.AsyncCohortEngine`.

RNG contract: fault draws come from the simulation's **network RNG
stream** (``Simulation.net.rng``), the same stream the per-round channel
states are drawn from, so ``reset()`` replays identical faults for every
policy and ``save()``/``resume()`` restore them bit-identically. Two
invariants keep sweeps fair and parity exact:

* an **inactive** model (every rate 0) consumes **zero** draws — the
  degenerate async configuration therefore advances the network stream
  exactly like the synchronous engines;
* an **active** model always consumes the same number of draws per round
  (four fixed-shape vectors) regardless of its rates, so runs differing
  only in fault *rates* still see identical channel-state sequences.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-round device fault probabilities (the ``Scenario`` fault axes).

    ``churn``: probability a scheduled device is offline at dispatch — it
    never trains and contributes nothing. ``dropout``: probability a device
    that did train loses its update mid-round (compute spent, nothing
    lands). ``straggler_frac``/``straggler_scale``: each device straggles
    with probability ``straggler_frac``; a straggler's extra delay is an
    ``Exp(mean=straggler_scale)`` *multiplicative* factor on its gateway's
    scheduled round delay.
    """
    churn: float = 0.0
    dropout: float = 0.0
    straggler_frac: float = 0.0
    straggler_scale: float = 0.0

    def __post_init__(self):
        for name in ("churn", "dropout", "straggler_frac"):
            p = getattr(self, name)
            if not 0.0 <= p < 1.0:
                raise ValueError(f"FaultModel.{name}={p}: need 0 <= p < 1")
        if self.straggler_scale < 0.0:
            raise ValueError(
                f"FaultModel.straggler_scale={self.straggler_scale}: "
                "need >= 0")

    @property
    def active(self) -> bool:
        """True when any fault can actually fire (controls whether a round
        consumes RNG draws — see the module docstring's RNG contract)."""
        return (self.churn > 0.0 or self.dropout > 0.0
                or (self.straggler_frac > 0.0 and self.straggler_scale > 0.0))

    @classmethod
    def from_scenario(cls, sc) -> "FaultModel":
        """Build from a :class:`repro_torch.fl.sim.Scenario`'s fault axes."""
        return cls(churn=sc.churn, dropout=sc.dropout,
                   straggler_frac=sc.straggler_frac,
                   straggler_scale=sc.straggler_scale)


@dataclasses.dataclass
class RoundFaults:
    """One round's realized per-device faults.

    ``dropped[n]``: offline at dispatch (churn) — device n trains nothing.
    ``lost[n]``: trained, but the update vanished mid-round (disjoint from
    ``dropped``). ``straggle[n]``: extra multiplicative delay factor
    (``0.0`` for non-stragglers); a gateway's realized completion delay is
    its scheduled delay times ``1 + max(straggle)`` over its surviving
    devices.
    """
    dropped: np.ndarray      # (N,) bool
    lost: np.ndarray         # (N,) bool
    straggle: np.ndarray     # (N,) float >= 0

    @classmethod
    def clear(cls, n_devices: int) -> "RoundFaults":
        """The all-clear draw (what an inactive model realizes)."""
        return cls(np.zeros(n_devices, bool), np.zeros(n_devices, bool),
                   np.zeros(n_devices, float))


def draw_round_faults(rng: np.random.Generator, model: FaultModel,
                      n_devices: int) -> RoundFaults:
    """Draw one round of per-device faults from ``rng``.

    An inactive model returns :meth:`RoundFaults.clear` without touching
    ``rng``; an active model always draws exactly four ``(N,)`` vectors —
    churn gate, dropout gate, straggler gate, straggler magnitude — in that
    fixed order, so the stream advance per round is constant across fault
    rates.
    """
    if not model.active:
        return RoundFaults.clear(n_devices)
    u_churn = rng.uniform(size=n_devices)
    u_lost = rng.uniform(size=n_devices)
    u_straggle = rng.uniform(size=n_devices)
    # mean-1 magnitudes scaled afterwards: the draw itself is rate-invariant
    magnitude = rng.exponential(1.0, size=n_devices)
    dropped = u_churn < model.churn
    lost = ~dropped & (u_lost < model.dropout)
    straggling = (~dropped & (u_straggle < model.straggler_frac)
                  & (model.straggler_scale > 0.0))
    straggle = np.where(straggling, model.straggler_scale * magnitude, 0.0)
    return RoundFaults(dropped, lost, straggle)
