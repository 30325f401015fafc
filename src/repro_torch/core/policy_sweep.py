"""Multi-policy sweeps: policies x seeds x V x rounds (port of
``repro.core.policy_sweep``).

The paper's headline figures (Figs. 4-6) compare DDSRA against the
fixed-resource baselines. Every traced-decide policy is a kind:

* kind 0: ``ddsra_jax``, the full Algorithm 1 round
  (:class:`repro_torch.core.ddsra_batched.DDSRAPlan`);
* kind 1: fixed-chosen baselines (``round_robin``, ``random``): gateway
  picks are data fed down the round axis (round-robin's closed form,
  random's pre-drawn per-seed policy-RNG stream);
* kind 2: ``delay_driven``: the greedy pick is computed in each round from
  its channel draws.

As in the reference, the policy axis is unrolled in Python over the static
``kinds`` tuple: each policy is one batched lane set, its rounds one graph
replay each on CUDA, and the per-policy grids are stacked at the end.
DDSRA lanes are seeds x V (all V lanes of a seed share its draws);
baseline lanes never read V, so they run one lane per seed and their rows
repeat across the V axis (the flat curves of Figs. 4-6).

Row (p, s, v) equals a stepwise ``reset(seeds[s])`` run of policy
``policies[p]`` at ``v_values[v]`` (``tests/test_torch_sweep.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baseline_batched import BaselinePlan
from repro_torch.core.ddsra_batched import _lanes
from repro_torch.core.network import ChannelStateT

# policy name -> kind. Only traced-decide policies can ride the sweep;
# host-loop rules (the ``ddsra`` oracle, ``loss_driven``) are refused by
# Simulation.sweep with a pointer to Simulation.rounds().
POLICY_KINDS = {"ddsra_jax": 0, "round_robin": 1, "random": 1,
                "delay_driven": 2}


def _grid(plan: BaselinePlan, kind: int, states: ChannelStateT, q0,
          gamma_rates, chosen_p, v_values):
    """One policy's (taus, selected, queues), numpy (S, V, T[, M]): every
    branch emits the *realized* round delay (max over trained gateways,
    0 when nobody trains), the stepwise RoundRecord.delay."""
    n_seeds, rounds = states.h_up.shape[:2]
    v_count = len(v_values)
    d = plan.ddsra
    if kind == 0:
        outs = d._scan(rounds, lambda t: _lanes(states, t, v_count),
                       d._t(q0)[None].expand(n_seeds * v_count, -1),
                       gamma_rates, d._t(v_values).repeat(n_seeds))
        dec = d.resolved(outs)
        v_lanes = v_count
    else:
        dec = plan.scan(rounds, lambda t: _lanes(states, t, 1),
                        d._t(q0)[None].expand(n_seeds, -1), gamma_rates,
                        None if kind == 2 else chosen_p.swapaxes(0, 1))
        v_lanes = 1

    def grid(x):
        x = x.reshape(rounds, n_seeds, v_lanes, *x.shape[2:]).movedim(0, 2)
        return x.expand(n_seeds, v_count, *x.shape[2:]).cpu().numpy()

    return grid(dec.delay), grid(dec.selected), grid(dec.queues)


def sweep_policies(plan: BaselinePlan, states: ChannelStateT, gamma_rates,
                   v_values, kinds, chosen, queues=None):
    """The policies x seeds x V grid: ``states`` leaves are (S, T, ...)
    stacks, ``kinds`` one kind per policy, ``chosen`` (P, S, T, J) gateway
    picks (read only by kind-1 lanes). ``plan`` carries the DDSRA plan
    too (``plan.ddsra``). Returns numpy (taus, selected, queues) shaped
    (P, S, V, T[, M])."""
    states = states.map(lambda x: x.to(plan.device, torch.float64))
    q0 = np.zeros(plan.n_gateways) if queues is None else queues
    chosen = np.asarray(chosen, np.int64)
    per_policy = [_grid(plan, int(kind), states, q0, gamma_rates, chosen[pi],
                        [float(v) for v in v_values])
                  for pi, kind in enumerate(kinds)]
    return tuple(np.stack(a) for a in zip(*per_policy))
