"""Scheduling sweeps as batched decide planes (port of the sweep half of
``repro.fl.fused_sim``).

A sweep trains nothing: each seed's channel trajectory is drawn on the host
under the ``reset(seed)`` contract (:func:`_seed_states`), and the decide
plane runs every lane of the grid at once on the simulation's device, one
CUDA graph replay a round there:

* ``policies=None``: the scenario policy must be ``ddsra_jax``; its
  ``DDSRAPlan.sweep_states`` runs seeds x V lanes;
* ``policies=[...]``: every named traced-decide policy is one lane set of
  ``repro_torch.core.policy_sweep.sweep_policies`` (the Figs. 4-6 grid).

The rest of the reference's fused module (``fused_rounds``, ``run_fused``,
the train scans, ``RoundTelemetry``, the traced data plane) is not ported
yet (ROADMAP.md M7).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import policy_sweep as ps
from repro_torch.core.baseline_batched import BaselinePlan
from repro_torch.core.network import ChannelState, ChannelStateT, stack_states
from repro_torch.core.schedulers import _TracedBaseline, make_policy


@dataclasses.dataclass
class SweepResult:
    """Outcome of a scheduling sweep (``Simulation.sweep``).

    Single-policy (``policies is None``): row (s, v) matches a stepwise
    ``reset(seeds[s])`` run of the same scenario at ``v_values[v]`` row
    for row: ``taus[s, v, t]`` is round t's delay, ``selected``/``queues``
    its participation and post-update queue state. Arrays carry (S, V, T[,
    M]) axes.

    Multi-policy (``policies`` a list of traced-decide policy names): every
    array gains a leading policy axis, (P, S, V, T[, M]); row (p, s, v)
    matches a stepwise ``reset(seeds[s])`` run with
    ``Scenario.policy=policies[p]`` at ``v_values[v]``. Fixed-resource
    baseline lanes ignore V, so their rows repeat across the V axis (the
    flat curves of Figs. 4-6)."""
    seeds: List[int]
    v_values: List[float]
    taus: np.ndarray       # ([P,] S, V, T)
    selected: np.ndarray   # ([P,] S, V, T, M) bool
    queues: np.ndarray     # ([P,] S, V, T, M)
    policies: Optional[List[str]] = None


def _seed_states(sim, seed: int, rounds: int) -> List[ChannelState]:
    """The channel trajectory a stepwise ``reset(seed)`` run would draw,
    without disturbing the live ``sim.net.rng`` stream (the scenario seed
    replays the pristine stream, any other seed reseeds it)."""
    if seed == sim.scenario.seed:
        rng = np.random.default_rng()
        rng.bit_generator.state = sim._net_rng_state0
    else:
        rng = np.random.default_rng(seed)
    saved = sim.net.rng
    sim.net.rng = rng
    try:
        return [sim.net.draw() for _ in range(rounds)]
    finally:
        sim.net.rng = saved


def _stacked_states(sim, seeds: List[int], rounds: int) -> ChannelStateT:
    """Every seed's trajectory, (S, T, ...) leaves on the sim's device."""
    per_seed = [stack_states(_seed_states(sim, s, rounds), sim.device)
                for s in seeds]
    return ChannelStateT(*[torch.stack(leaves) for leaves in zip(*per_seed)])


def _plan(sim) -> BaselinePlan:
    """The simulation's sweep plan (with its DDSRA plan), built at its
    first sweep, so later sweeps replay the graphs it captured (one per
    lane count) instead of capturing anew."""
    if sim._sweep_plan is None:
        sim._sweep_plan = BaselinePlan.build(sim.workload, sim.net,
                                             device=sim.device)
    return sim._sweep_plan


def sweep(sim, v_values, seeds=None, *, rounds: Optional[int] = None,
          policies: Optional[List[str]] = None) -> SweepResult:
    """Run a scheduling sweep on the simulation's device.

    ``policies=None`` (the classic V-sweep): the scenario policy must be
    ``ddsra_jax``; each seed's channel trajectory is drawn on the host
    under the reset(seed) contract, and ``DDSRAPlan.sweep_states`` runs
    the seeds x V lanes, all V lanes of a seed sharing its draws. (The
    plan is the simulation's own sweep plan, not the policy's: the same
    algorithm on the same workload and network.)

    ``policies=[...]`` (the Figs. 4-6 grid): every named traced-decide
    policy is one lane set over the same draws, and ``random``'s picks are
    pre-drawn per seed from the policy-RNG stream a stepwise
    ``reset(seed)`` run would consume.
    """
    T = sim.scenario.rounds if rounds is None else rounds
    seeds = [sim.scenario.seed] if seeds is None else [int(s) for s in seeds]
    v_values = [float(v) for v in v_values]

    if policies is not None:
        bad = [p for p in policies if p not in ps.POLICY_KINDS]
        if bad:
            raise ValueError(
                f"policies {bad!r} cannot ride the sweep (host-loop "
                f"decide); traced-decide policies: "
                f"{sorted(ps.POLICY_KINDS)}: use Simulation.rounds() for "
                "the rest")
        plan = _plan(sim)
        stacked = _stacked_states(sim, seeds, T)
        kinds = [ps.POLICY_KINDS[p] for p in policies]
        j_ch = sim.net.cfg.n_channels
        chosen = np.zeros((len(policies), len(seeds), T, j_ch), np.int64)
        for pi, name in enumerate(policies):
            if kinds[pi] != 1:
                continue
            for si, s in enumerate(seeds):
                # a fresh per-seed policy instance is the stepwise
                # reset(seed) contract (make_policy reseeds from run_seed)
                pol = make_policy(name, seed=s)
                chosen[pi, si] = pol.traced_chosen(0, T, sim.net)
        taus, sel, queues = ps.sweep_policies(
            plan, stacked, sim.gamma, v_values, kinds, chosen)
        return SweepResult(seeds=seeds, v_values=v_values, taus=taus,
                           selected=sel, queues=queues,
                           policies=list(policies))

    policy = sim._resolve_policy(None)
    if not getattr(policy, "traced_decide", False):
        raise ValueError(
            f"Simulation.sweep() needs a traced-decide policy; scenario "
            f"policy {sim.scenario.policy!r} decides on the host: set "
            "Scenario.policy='ddsra_jax'")
    if isinstance(policy, _TracedBaseline):
        raise ValueError(
            f"policy {sim.scenario.policy!r} has no V-sweep (fixed-resource "
            "baselines ignore V); set Scenario.policy='ddsra_jax' or pass "
            "policies=[...] to sweep them on the policy axis")
    taus, sel, queues = _plan(sim).ddsra.sweep_states(
        _stacked_states(sim, seeds, T), sim.gamma, v_values)
    return SweepResult(seeds=seeds, v_values=v_values, taus=taus,
                       selected=sel, queues=queues)
