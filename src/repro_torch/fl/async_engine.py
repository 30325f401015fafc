"""Churn-aware buffered asynchronous aggregation: the ``"async"`` engine
(port of ``repro.fl.async_engine``).

Synchronous FedAvg rounds are hostage to their slowest participant: one
straggling device stalls the whole cohort, and a churned device silently
shrinks it. :class:`AsyncCohortEngine` decouples dispatch from aggregation
the FedBuff way — scheduled gateways still train through the *same*
slot-batched cohort round as :class:`~repro_torch.fl.sim.CohortEngine`,
but their shop-floor models travel independently to the server and land in
a bounded staleness buffer. Once ``Scenario.buffer_k`` updates have arrived
the server aggregates them with staleness-discounted FedAvg weights
``d_tilde * (1 + tau)^(-staleness_alpha)`` (``tau`` = how many aggregations
happened since the update was dispatched) and advances the global model;
everything still in flight keeps flying across round boundaries.

Time is simulated: "now" is ``Simulation.delay_sum``, a gateway's update
arrives ``gw_delay[m] * (1 + max straggle factor)`` after dispatch, and a
round's realized delay is only the time the server actually waited for its
aggregation event. Faults (churn / mid-round dropout / stragglers, drawn
per round in numpy from the network RNG stream, ``repro_torch.fl.faults``)
zero individual devices out of their gateway's shop-floor average through
the completion mask (``repro_torch.fl.data.zero_slot_rows``): exact-zero
loss, exact-zero gradients, zero FedAvg weight, unchanged shapes.

The control side (fault draws, the heap of in-flight updates ordered by
(arrival, seq), staleness, realized participation) is the reference's, in
the same order, so a faulted run's records equal the reference's. A
gateway's model stays on the simulation's device while it is in flight
or parked; only ``Simulation.save`` copies it to the host, into the
reference's ``engine_*`` side-car format, so a directory written by either
package resumes in the other mid-buffer.

Two contracts anchor the subsystem:

* **Degenerate parity** — with every fault axis 0 and ``buffer_k=None``
  (the barrier: drain the round's whole dispatched cohort, then flush),
  the engine replays :class:`~repro_torch.fl.sim.CohortEngine` exactly —
  same RNG streams, same queue trajectory, params equal to the round's
  two-tier FedAvg up to float re-association.
* **Realized feedback** — the Lyapunov virtual queues are driven by which
  updates actually *landed* (``lyapunov.update_queues_realized``), not by
  what the scheduler hoped for.
"""
from __future__ import annotations

import dataclasses
import heapq
import pathlib
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.core.ddsra import RoundDecision
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl.data import zero_slot_rows
from repro_torch.fl.faults import draw_round_faults
from repro_torch.fl.sim import CohortEngine, RoundOutcome, register_engine
from repro_torch.models.convert import params_from_numpy, params_to_numpy


@dataclasses.dataclass
class BufferedUpdate:
    """One gateway's shop-floor model in flight to (or parked at) the server.

    ``version`` is the aggregation counter at dispatch time; staleness at
    aggregation is the server's counter minus it. ``arrival`` is simulated
    server-clock time; ``seq`` breaks arrival ties deterministically.
    ``weight`` is the surviving sample mass (sum of ``d_tilde`` over
    devices that actually contributed to ``model``), ``model`` the params
    on the simulation's device.
    """
    gateway: int
    version: int
    arrival: float
    seq: int
    weight: float
    model: Any = dataclasses.field(repr=False, default=None)


@register_engine("async")
class AsyncCohortEngine(CohortEngine):
    """Buffered asynchronous aggregation over the cohort round.

    Subclasses :class:`~repro_torch.fl.sim.CohortEngine` for layout,
    packing, the round itself and the statistics, and overrides only
    *when updates meet the global model*. See the module docstring for the
    semantics and the parity/feedback contracts.
    """

    supports_faults = True
    supports_fused = False   # buffered aggregation is stateful across rounds

    def __init__(self):
        # (arrival, seq, BufferedUpdate) min-heap: dispatched, not yet landed
        self._pending: List = []
        self._buffer: List[BufferedUpdate] = []   # landed, not yet aggregated
        self._version = 0                         # completed aggregations
        self._seq = 0                             # dispatch counter (ties)

    def fused_train(self, sim, params, losses0, xs, ys, masks, ls, ws, gws,
                    trained, eval_mask=None):
        """Refuse the fused loop: the in-flight heap, the staleness buffer
        and the realized-arrival clock are state across rounds that one
        graph a round cannot carry; a fused run would replay barrier
        semantics and falsify the staleness telemetry."""
        raise NotImplementedError(
            "engine 'async' has no fused scan path (buffered aggregation "
            "is stateful across rounds); use Simulation.rounds()")

    def reset(self, sim) -> None:
        """Drop every in-flight and parked update and rewind the counters:
        ``Simulation.restart()`` rewinds the clock to 0, and an update
        dispatched under the old clock must not aggregate into the next
        run."""
        self._pending = []
        self._buffer = []
        self._version = 0
        self._seq = 0

    # -- the round -------------------------------------------------------

    def run_round(self, sim, dec: RoundDecision, trained: List[int],
                  l_n: np.ndarray, gw_delay: Dict[int, float],
                  boundary: bool = False) -> RoundOutcome:
        """Dispatch the scheduled cohort, land due arrivals, maybe aggregate.

        One simulated round: draw this round's faults, train the surviving
        cohort through the cohort round, push each gateway's shop-floor
        model onto the in-flight heap with its realized arrival time, then
        pop arrivals in time order until the buffer holds ``buffer_k``
        updates (or, under the ``buffer_k=None`` barrier, until the round's
        own cohort has fully landed) and aggregate. The realized
        participation indicator covers exactly the gateways whose updates
        were aggregated this round, plus scheduled-but-infeasible gateways
        (which keep their scheduled queue credit).
        """
        sc = sim.scenario
        now = float(sim.delay_sum)
        faults = draw_round_faults(sim.net.rng, sim.faults,
                                   sim.net.cfg.n_devices)

        landed_gw = np.zeros(sim.net.cfg.n_gateways, bool)
        boundary_rms = None
        dropped = lost = stragglers = 0
        if trained:
            boundary_rms, dropped, lost, stragglers = self._dispatch(
                sim, trained, l_n, gw_delay, faults, now, boundary)

        agg_delay, aggregated, staleness, discarded = self._land_and_aggregate(
            sim, barrier=sc.buffer_k is None, buffer_k=sc.buffer_k, now=now)
        for upd in aggregated:
            landed_gw[upd.gateway] = True

        # scheduled-but-infeasible gateways keep their scheduled credit: the
        # policy already charged their queues, and no update of theirs can
        # ever land, so realized participation mirrors the schedule there.
        realized = landed_gw | (dec.selected & ~np.isin(
            np.arange(sim.net.cfg.n_gateways), list(gw_delay)))
        return RoundOutcome(
            delay=agg_delay, boundary_rms=boundary_rms, realized=realized,
            aggregations=1 if aggregated else 0,
            staleness_mean=float(np.mean(staleness)) if staleness else 0.0,
            staleness_max=int(max(staleness)) if staleness else 0,
            stale_discarded=discarded, dropped_devices=dropped,
            lost_devices=lost, straggler_devices=stragglers,
            buffer_fill=len(self._buffer), inflight=len(self._pending))

    def _dispatch(self, sim, trained: List[int], l_n: np.ndarray,
                  gw_delay: Dict[int, float], faults, now: float,
                  boundary: bool):
        """Train the surviving cohort and push per-gateway updates in flight.

        Churned devices are zeroed out of the batch entirely (no compute,
        completion mask); mid-round-lost devices train but their slot
        weight is zeroed so nothing of theirs aggregates. A gateway with no
        surviving contributor dispatches nothing.
        """
        device_ids, batch, l_slot, w_slot, slot_gw = self._pack_round(
            sim, trained, l_n)
        dead_slots = []
        for di, n in enumerate(device_ids):
            if faults.dropped[n] or faults.lost[n]:
                s = int(batch.slot_of[di])
                w_slot[s] = 0.0
                if faults.dropped[n]:
                    dead_slots.append(s)
        batch = zero_slot_rows(batch, dead_slots)

        _, gw_loss, gw_count, _, bnd, gw_models = self._fused_round(
            sim, sim.params, batch, l_slot, w_slot, slot_gw,
            with_boundary=boundary, with_gateway_models=True)
        sim.padding_stats["real_samples"] += float(
            sum(t.mask.sum() for t in batch.tiers))
        sim.padding_stats["padded_samples"] += float(
            batch.layout.padded_samples)

        gw_loss, gw_count = gw_loss.cpu().numpy(), gw_count.cpu().numpy()
        dropped = lost = stragglers = 0
        for m in trained:
            devs = [d.idx for d in sim.gateways[m].devices]
            dropped += int(np.sum(faults.dropped[devs]))
            lost += int(np.sum(faults.lost[devs]))
            surviving = [n for n in devs
                         if not (faults.dropped[n] or faults.lost[n])]
            if gw_count[m] > 0:      # someone computed: the loss is real
                sim.losses[m] = float(gw_loss[m])
            if not surviving:
                continue             # nothing of this gateway ever lands
            straggle = float(np.max(faults.straggle[surviving]))
            stragglers += int(np.sum(faults.straggle[surviving] > 0.0))
            # the gateway's own copy on the device: the other gateways'
            # models of this round are freed once they are taken
            self._pending_push(BufferedUpdate(
                gateway=m, version=self._version,
                arrival=now + gw_delay[m] * (1.0 + straggle), seq=self._seq,
                weight=float(np.sum(sim.d_tilde[surviving])),
                model=[{k: v[m].clone() for k, v in layer.items()}
                       for layer in gw_models]))

        if boundary:
            rms = np.zeros(sim.net.cfg.n_devices)
            rms[device_ids] = bnd.cpu().numpy()[batch.slot_of]
            return rms, dropped, lost, stragglers
        return None, dropped, lost, stragglers

    def _pending_push(self, upd: BufferedUpdate) -> None:
        heapq.heappush(self._pending, (upd.arrival, upd.seq, upd))
        self._seq += 1

    def _land_and_aggregate(self, sim, *, barrier: bool,
                            buffer_k: Optional[int], now: float):
        """Pop arrivals in time order, fill the buffer, aggregate at most
        one event, and return (delay, aggregated, staleness, discarded).

        Under the barrier the round's *entire* in-flight set is drained and
        flushed (the server waits for the slowest arrival). Under
        ``buffer_k`` the server waits only until the buffer reaches K,
        aggregates, and leaves the rest in flight; a round whose buffer
        never fills costs zero realized delay. Arrivals earlier than
        ``now`` land free of charge.

        The aggregation time is the max *arrival* over the whole aggregated
        batch (clamped to ``now``), so an update parked in the buffer across
        rounds (a heavy straggler landing into an under-full buffer) still
        charges its full realized delay when an aggregation finally
        consumes it.
        """
        if barrier:
            while self._pending:
                _, _, upd = heapq.heappop(self._pending)
                self._buffer.append(upd)
            if not self._buffer:
                return 0.0, [], [], 0
        else:
            while self._pending and len(self._buffer) < buffer_k:
                _, _, upd = heapq.heappop(self._pending)
                self._buffer.append(upd)
            if len(self._buffer) < buffer_k:
                return 0.0, [], [], 0       # keep waiting across rounds

        batch, self._buffer = self._buffer, []
        t_end = max([now] + [u.arrival for u in batch])
        max_stale = sim.scenario.max_staleness
        fresh = [u for u in batch
                 if max_stale is None
                 or (self._version - u.version) <= max_stale]
        discarded = len(batch) - len(fresh)
        if not fresh:
            return t_end - now, [], [], discarded
        staleness = [self._version - u.version for u in fresh]
        weights = [u.weight * (1.0 + tau) ** (-sim.scenario.staleness_alpha)
                   for u, tau in zip(fresh, staleness)]
        sim.params = cohort_lib.buffer_fedavg([u.model for u in fresh],
                                              weights)
        self._version += 1
        return t_end - now, fresh, staleness, discarded

    # -- policy/telemetry hooks -----------------------------------------

    def inflight_counts(self, sim) -> Optional[np.ndarray]:
        """(M,) dispatched-but-not-landed update counts per gateway."""
        counts = np.zeros(sim.net.cfg.n_gateways, int)
        for _, _, upd in self._pending:
            counts[upd.gateway] += 1
        return counts

    # -- checkpointing ---------------------------------------------------

    def state_dict(self, sim):
        """The heap, buffer and counters for ``Simulation.save``.

        Entries are flattened in (arrival, seq) order — the exact pop order
        — so a resumed heap replays identically; the models go to the
        ``engine_*`` side-car as one list, host copies in the reference's
        layout (``convert.params_to_numpy``), taken here on the calling
        thread.
        """
        pending = sorted(self._pending, key=lambda e: e[:2])
        ups = [u for _, _, u in pending] + list(self._buffer)
        meta = {
            "version": self._version, "seq": self._seq,
            "n_pending": len(pending),
            "updates": [{"gateway": u.gateway, "version": u.version,
                         "arrival": u.arrival, "seq": u.seq,
                         "weight": u.weight} for u in ups],
        }
        return meta, {"models": [params_to_numpy(sim.plan, u.model)
                                 for u in ups]}

    def load_state_dict(self, sim, meta: dict, path, step: int) -> None:
        """Restore what :meth:`state_dict` captured (inverse order), the
        models onto the simulation's device."""
        self._version = meta["version"]
        self._seq = meta["seq"]
        ups = meta["updates"]
        models = []
        if ups:
            like = {"models": [params_to_numpy(sim.plan, sim.params)]
                    * len(ups)}
            saved = store.load_pytree(
                pathlib.Path(path) / f"engine_{step:08d}.npz", like)
            models = [params_from_numpy(sim.plan, m, sim.device)
                      for m in saved["models"]]
        restored = [BufferedUpdate(gateway=d["gateway"], version=d["version"],
                                   arrival=d["arrival"], seq=d["seq"],
                                   weight=d["weight"], model=mdl)
                    for d, mdl in zip(ups, models)]
        n_pend = meta["n_pending"]
        self._pending = [(u.arrival, u.seq, u) for u in restored[:n_pend]]
        heapq.heapify(self._pending)
        self._buffer = list(restored[n_pend:])
