"""The fused round loop and scheduling sweeps (port of
``repro.fl.fused_sim``).

The stepwise ``Simulation.rounds`` loop crosses the host every round:
decide, resolve in Python, pack, train, read the losses back. The fused
loop runs a block of rounds as a decide pass, a host replay of the
packing, and a training pass with nothing read on the host:

* **Decide.** Traced policies (``ddsra_jax``, the fixed-resource
  baselines) run the whole trajectory as batched rounds on the device
  (``DDSRAPlan.decide_scan``, ``BaselinePlan.decide_scan``, one graph
  replay a round), ``random``'s picks pre-drawn from its RNG as data;
  the other policies replay the stepwise host loop.
* **Batch replay.** ``CohortEngine._pack_round`` runs for every round on
  the host, consuming ``sim.rng`` with exactly the stepwise draws, and
  each tier's (T, S_k, W_k, ...) stack is uploaded once. Under
  ``Scenario.data_plane="traced"`` only the slots' metadata is packed
  (:func:`_pack_rounds_traced`): the training pass gathers every batch
  on the device by the counter-based draws.
* **Train.** One CUDA graph of a trained round (K local epochs with their
  autograd, the two-tier FedAvg, the guards), captured once and replayed
  once a round (``repro_torch.fl.cohort.train_scan``, ``train_scan_traced``),
  threading (params, losses) on the device; an ``eval_every`` round
  replays a second graph, the test-set hit count. Under the sharded
  engine each rank uploads and trains only its own slots, and a round is
  two graphs with the FedAvg's ``all_reduce`` run eagerly between them.

Decide and train separate because no fusable policy reads training
outputs (``loss_driven``, ``reads_losses = True``, is refused), and the
channel states are drawn on the host from ``net.rng`` before the replay
touches ``sim.rng``: two generators, each consumed in stepwise order. The
records come back once, after the block, through :class:`RoundTelemetry`.

Scheduling sweeps (:func:`sweep`) train nothing: each seed's channel
trajectory is drawn on the host under the ``reset(seed)`` contract
(:func:`_seed_states`), and the decide plane runs every lane of the grid
at once on the simulation's device, one CUDA graph replay a round there:

* ``policies=None``: the scenario policy must be ``ddsra_jax``; its
  ``DDSRAPlan.sweep_states`` runs seeds x V lanes;
* ``policies=[...]``: every named traced-decide policy is one lane set of
  ``repro_torch.core.policy_sweep.sweep_policies`` (the Figs. 4-6 grid).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import policy_sweep as ps
from repro_torch.core.baseline_batched import BaselinePlan
from repro_torch.core.network import ChannelState, ChannelStateT, stack_states
from repro_torch.core.schedulers import (RoundContext, _TracedBaseline,
                                         make_policy)


class RoundTelemetry(NamedTuple):
    """Stacked per-round telemetry: one leaf per array-like
    :class:`~repro_torch.fl.sim.RoundRecord` field, each with a leading
    (rounds,) axis: how the fused loop's results cross back to the host
    once and fan out into records (:meth:`to_records`).
    ``boundary_rms`` and ``accuracy`` are not leaves (optional per-round
    host values, ragged across rounds). :meth:`from_records` and
    :meth:`to_records` round-trip exactly."""
    t: np.ndarray                  # (T,) int
    selected: np.ndarray           # (T, M) bool
    trained: np.ndarray            # (T, M) bool (records carry id lists)
    l_n: np.ndarray                # (T, N) int
    delay: np.ndarray              # (T,) float64
    cum_delay: np.ndarray          # (T,) float64
    queues: np.ndarray             # (T, M) float64
    losses: np.ndarray             # (T, M) float64
    failures: np.ndarray           # (T,) int
    aggregations: np.ndarray       # (T,) int
    staleness_mean: np.ndarray     # (T,) float64 (0.0 when no aggregation)
    staleness_max: np.ndarray      # (T,) int
    stale_discarded: np.ndarray    # (T,) int
    dropped_devices: np.ndarray    # (T,) int
    lost_devices: np.ndarray       # (T,) int
    straggler_devices: np.ndarray  # (T,) int
    buffer_fill: np.ndarray        # (T,) int
    inflight: np.ndarray           # (T,) int

    @classmethod
    def from_records(cls, records: Sequence) -> "RoundTelemetry":
        """Stack per-round records (trained id lists become the (T, M)
        bool mask; ``boundary_rms``/``accuracy`` are dropped)."""
        m_gw = len(records[0].queues)
        trained = np.zeros((len(records), m_gw), bool)
        for i, r in enumerate(records):
            trained[i, list(r.trained)] = True
        dtypes = {
            "t": int, "selected": bool, "l_n": int, "delay": np.float64,
            "cum_delay": np.float64, "queues": np.float64,
            "losses": np.float64, "failures": int, "aggregations": int,
            "staleness_mean": np.float64, "staleness_max": int,
            "stale_discarded": int, "dropped_devices": int,
            "lost_devices": int, "straggler_devices": int,
            "buffer_fill": int, "inflight": int}
        cols = {k: np.asarray([getattr(r, k) for r in records], dtype=dt)
                for k, dt in dtypes.items()}
        return cls(trained=trained, **cols)

    def to_records(self) -> List:
        """Fan the stacked leaves back out into per-round records, every
        value a host numpy array or Python scalar."""
        from repro_torch.fl.sim import RoundRecord
        out = []
        for i in range(len(np.asarray(self.t))):
            out.append(RoundRecord(
                t=int(self.t[i]),
                selected=np.asarray(self.selected[i]).copy(),
                trained=[int(m) for m in np.where(self.trained[i])[0]],
                l_n=np.asarray(self.l_n[i]).copy(),
                delay=float(self.delay[i]),
                cum_delay=float(self.cum_delay[i]),
                queues=np.asarray(self.queues[i], np.float64).copy(),
                losses=np.asarray(self.losses[i], np.float64).copy(),
                failures=int(self.failures[i]),
                aggregations=int(self.aggregations[i]),
                staleness_mean=float(self.staleness_mean[i]),
                staleness_max=int(self.staleness_max[i]),
                stale_discarded=int(self.stale_discarded[i]),
                dropped_devices=int(self.dropped_devices[i]),
                lost_devices=int(self.lost_devices[i]),
                straggler_devices=int(self.straggler_devices[i]),
                buffer_fill=int(self.buffer_fill[i]),
                inflight=int(self.inflight[i])))
        return out


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


# ---------------------------------------------------------------------------
# the fused round loop: decide, batch replay, train
# ---------------------------------------------------------------------------


def _check_fusable(sim, policy) -> None:
    """Refuse a block the fused loop cannot run, before any RNG stream is
    consumed: a policy that reads training losses, or an engine without
    a fused path (whose own error is raised)."""
    if getattr(policy, "reads_losses", False):
        raise ValueError(
            f"policy {getattr(policy, 'name', policy)!r} reads training "
            "losses (reads_losses=True): decide and train cannot be "
            "phase-separated; use Simulation.rounds()")
    if not getattr(sim.engine, "supports_fused", False):
        sim.engine.fused_train(sim, None, None, None, None, None, None,
                               None, None, None)


def _decide(sim, policy, states: List[ChannelState], t0: int):
    """The decide trajectory over pre-drawn channel states: traced
    policies as batched rounds on the device (their ``decide_scan``), the
    rest through the stepwise host loop (the same ``schedule(ctx)`` calls
    and queue handoff, so queues and the policy's RNG stay as stepwise
    leaves them). Returns host numpy (selected (T, M), trained (T, M),
    l_n (T, N), delay (T,), failures (T,), queues (T, M))."""
    sc = sim.scenario
    n_dev = sim.net.cfg.n_devices
    if getattr(policy, "traced_decide", False):
        if isinstance(policy, _TracedBaseline):
            plan = policy.plan_for(sim.workload, sim.net, device=sim.device)
        else:
            plan = policy.plan_for(sim.workload, sim.net)
        kwargs = {}
        if hasattr(policy, "traced_chosen"):
            # the baselines' gateway picks are data, drawn on the host from
            # the policy's own stream in stepwise order; delay_driven's
            # (None) is computed in each round from its channel draws
            chosen = policy.traced_chosen(t0, len(states), sim.net)
            if chosen is not None:
                kwargs["chosen"] = chosen
        dec = plan.decide_scan(stack_states(states, plan.device), sim.queues,
                               sim.gamma, sc.v, **kwargs)

        def host(x, dtype):
            return x.cpu().numpy().astype(dtype)
        return (host(dec.selected, bool), host(dec.trained, bool),
                host(dec.l_dev, int), host(dec.delay, np.float64),
                host(dec.failures, int), host(dec.queues, np.float64))

    from repro_torch.fl.sim import resolve_decision
    m_gw = sim.net.cfg.n_gateways
    T = len(states)
    selected = np.zeros((T, m_gw), bool)
    trained_mask = np.zeros((T, m_gw), bool)
    l_rounds = np.zeros((T, n_dev), int)
    delay = np.zeros(T)
    failures = np.zeros(T, int)
    queues_out = np.zeros((T, m_gw))
    queues = sim.queues
    for k, st in enumerate(states):
        ctx = RoundContext(t0 + k, sim.workload, sim.net, st, queues,
                           sim.gamma, sc.v, losses=sim.losses.copy())
        dec = policy.schedule(ctx)
        queues = dec.queues
        trained, l_n, gw_delay, fails = resolve_decision(
            dec, sim.gateways, n_dev)
        selected[k] = dec.selected
        trained_mask[k, trained] = True
        l_rounds[k] = l_n
        delay[k] = max(gw_delay.values(), default=0.0)
        failures[k] = fails
        queues_out[k] = queues
    return selected, trained_mask, l_rounds, delay, failures, queues_out


def _fixed_layout(layout, layout0):
    if layout0 is not None and layout is not layout0:
        raise RuntimeError(
            "cohort layout changed across rounds (capacity fallback); "
            "the fused scan needs fixed shapes: use Simulation.rounds()")
    return layout


def _upload(sim, stacked, sizes):
    """Per-tier tuples of numpy stacks (T, S_k, ...) to the simulation's
    device, each in one copy: only the slots this process trains
    (``_slot_blocks``: all of them but under the sharded engine)."""
    blocks = sim.engine._slot_blocks(sim, sizes)
    return tuple(tuple(torch.as_tensor(np.ascontiguousarray(a[:, blk]))
                       .to(sim.device) for a, blk in zip(tier, blocks))
                 for tier in stacked)


def _replay_batches(sim, trained_mask: np.ndarray, l_rounds: np.ndarray):
    """Pack every round through the engine's ``_pack_round`` (its layout,
    which carries the engine's shard count), consuming ``sim.rng`` with
    exactly the stepwise draws, into per-tier stacks with a leading round
    axis, uploaded to the device once.

    Returns per-tier tuples (xs, ys, masks, ls, ws, gws): tier k carries
    (T, S_k, ...) tensors. Rounds where nobody trains pack too (no draws,
    zero masks and weights), so the shapes stay fixed. Each packed array
    is written straight into row k of a preallocated host stack."""
    T = trained_mask.shape[0]
    layout0 = stacked = None
    for k in range(T):
        trained = [int(m) for m in np.where(trained_mask[k])[0]]
        _, batch, l_slot, w_slot, slot_gw = sim.engine._pack_round(
            sim, trained, l_rounds[k])
        layout0 = _fixed_layout(batch.layout, layout0)
        if trained:  # stepwise accounting only touches training rounds
            sim.padding_stats["real_samples"] += float(
                sum(t.mask.sum() for t in batch.tiers))
            sim.padding_stats["padded_samples"] += float(
                layout0.padded_samples)
        sizes = tuple(t.x.shape[0] for t in batch.tiers)
        if stacked is None:  # round 0 fixes every tier's shape
            stacked = (
                tuple(np.empty((T,) + t.x.shape, t.x.dtype)
                      for t in batch.tiers),
                tuple(np.empty((T,) + t.y.shape, t.y.dtype)
                      for t in batch.tiers),
                tuple(np.empty((T,) + t.mask.shape, np.float32)
                      for t in batch.tiers),
                tuple(np.empty((T, s), np.int64) for s in sizes),
                tuple(np.empty((T, s), np.float32) for s in sizes),
                tuple(np.empty((T, s) + np.shape(slot_gw)[1:], np.float32)
                      for s in sizes))
        xs, ys, masks, ls, ws, gws = stacked
        off = 0
        for i, t in enumerate(batch.tiers):
            xs[i][k] = t.x
            ys[i][k] = t.y
            masks[i][k] = t.mask
            ls[i][k] = l_slot[off:off + sizes[i]]
            ws[i][k] = w_slot[off:off + sizes[i]]
            gws[i][k] = slot_gw[off:off + sizes[i]]
            off += sizes[i]
    return _upload(sim, stacked, sizes)


def _pack_rounds_traced(sim, trained_mask: np.ndarray,
                        l_rounds: np.ndarray):
    """The traced data plane's batch replay: only each round's slot
    metadata (``_pack_round_meta``), no sample drawn, uploaded once.

    Returns (slot_devs, ls, ws, gws, layout): per-tier tuples of
    (T, S_k[, M]) tensors on the device (a rank's own slots under the
    sharded engine), and the fixed layout."""
    T = trained_mask.shape[0]
    layout0 = stacked = None
    for k in range(T):
        trained = [int(m) for m in np.where(trained_mask[k])[0]]
        _, layout, slot_dev, l_slot, w_slot, slot_gw, real = \
            sim.engine._pack_round_meta(sim, trained, l_rounds[k])
        layout0 = _fixed_layout(layout, layout0)
        if trained:  # stepwise accounting only touches training rounds
            sim.padding_stats["real_samples"] += float(real)
            sim.padding_stats["padded_samples"] += float(
                layout.padded_samples)
        sizes = tuple(layout.tier_slots)
        if stacked is None:
            stacked = (
                tuple(np.empty((T, s), np.int64) for s in sizes),
                tuple(np.empty((T, s), np.int64) for s in sizes),
                tuple(np.empty((T, s), np.float32) for s in sizes),
                tuple(np.empty((T, s) + np.shape(slot_gw)[1:], np.float32)
                      for s in sizes))
        sds, ls, ws, gws = stacked
        off = 0
        for i, s in enumerate(sizes):
            sds[i][k] = slot_dev[off:off + s]
            ls[i][k] = l_slot[off:off + s]
            ws[i][k] = w_slot[off:off + s]
            gws[i][k] = slot_gw[off:off + s]
            off += s
    return _upload(sim, stacked, sizes) + (layout0,)


def fused_rounds(sim, policy, *, rounds: Optional[int] = None) -> List:
    """Advance ``sim`` by (up to) ``rounds`` rounds through the fused loop
    (decide pass, batch replay, training pass) and return the
    :class:`~repro_torch.fl.sim.RoundRecord` stream the stepwise loop
    yields.

    The end state (params, losses, queues, t, delay_sum, both RNG
    streams) is the stepwise loop's, so fused and stepwise blocks
    interleave and a checkpoint taken after a fused block resumes into
    either path. The host reads the device once, when the block ends.
    """
    sc = sim.scenario
    t0 = sim.t
    T = sc.rounds - t0 if rounds is None else min(rounds, sc.rounds - t0)
    if T <= 0:
        return []
    _check_fusable(sim, policy)

    # decide: channel states from the same numpy stream as stepwise
    states = [sim.net.draw() for _ in range(T)]
    selected, trained_mask, l_rounds, delay, failures, queues = _decide(
        sim, policy, states, t0)

    # the stepwise eval_every schedule, known on the host: those rounds
    # replay the evaluation graph after the training one
    ts = t0 + np.arange(T)
    eval_mask = ((ts + 1) % sc.eval_every == 0) | (ts == sc.rounds - 1)

    if sc.data_plane == "traced":
        slot_devs, ls, ws, gws, layout = _pack_rounds_traced(
            sim, trained_mask, l_rounds)
        params, losses, loss_hist, hits = sim.engine.fused_train_traced(
            sim, sim.params, sim.losses, ts, slot_devs, ls, ws, gws,
            trained_mask, eval_mask, layout)
    else:
        xs, ys, masks, ls, ws, gws = _replay_batches(sim, trained_mask,
                                                     l_rounds)
        params, losses, loss_hist, hits = sim.engine.fused_train(
            sim, sim.params, sim.losses, xs, ys, masks, ls, ws, gws,
            trained_mask, eval_mask)
    # the block's one read of the device
    losses, loss_hist, hits = (x.cpu().numpy()
                               for x in (losses, loss_hist, hits))

    cum = sim.delay_sum + np.cumsum(np.asarray(delay, np.float64))
    tel = RoundTelemetry(
        t=ts, selected=np.asarray(selected, bool),
        trained=np.asarray(trained_mask, bool),
        l_n=np.asarray(l_rounds, int),
        delay=np.asarray(delay, np.float64), cum_delay=cum,
        queues=np.asarray(queues, np.float64),
        losses=np.asarray(loss_hist, np.float64),
        failures=np.asarray(failures, int),
        aggregations=np.asarray(trained_mask.any(axis=1), int),
        staleness_mean=np.zeros(T), staleness_max=np.zeros(T, int),
        stale_discarded=np.zeros(T, int), dropped_devices=np.zeros(T, int),
        lost_devices=np.zeros(T, int), straggler_devices=np.zeros(T, int),
        buffer_fill=np.zeros(T, int), inflight=np.zeros(T, int))
    records = tel.to_records()

    # commit the end state to the Simulation, as stepwise leaves it
    sim.params = params
    sim.losses = np.asarray(losses, np.float64)
    sim.queues = np.asarray(queues[-1], np.float64).copy()
    sim.t = t0 + T
    sim.delay_sum = float(cum[-1])

    # hit counts to the stepwise loop's accuracies (SplitModel.accuracy's
    # chunks, so the same integers)
    n_test = max(int(np.size(np.asarray(sim.ds.y_test))), 1)
    for r, h in zip(records, hits):
        if h >= 0:
            r.accuracy = float(int(h)) / n_test
    return records


# ---------------------------------------------------------------------------
# seeds x V sweeps
# ---------------------------------------------------------------------------


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
