"""Composable FL simulation API: Scenario / Policy / Engine (port of
``repro.fl.sim``).

* **Scenario** — a frozen, JSON-serializable spec of everything that defines
  an experiment: network config, data distribution, model (resolved through
  ``repro_torch.models.registry.build_fl_model``), local-training
  hyperparameters and the default policy/engine names. The same fields as
  the reference's, so a scenario round-trips between the two packages.
* **Policy** — any object with ``schedule(ctx) -> RoundDecision``; named
  policies come from the registry in ``repro_torch.core.schedulers``.
* **Engine** — how a scheduled round is executed: ``CohortEngine`` (one
  slot-batched round, ``repro_torch.fl.cohort``), ``ShardedCohortEngine``
  (the same round with its slots split over the ranks of a
  ``torch.distributed`` process group, ``repro_torch.fl.shard``),
  ``AsyncCohortEngine`` (buffered asynchronous aggregation over the same
  round, with the fault axes, ``repro_torch.fl.async_engine``) or
  ``SequentialEngine`` (the per-device loop, kept as the parity
  reference). ``repro_torch.fl`` registers the sharded and async engines
  when it imports them, as the reference's package does.

On top sits :class:`Simulation`: a streaming ``rounds()`` generator yielding
one :class:`RoundRecord` per round (decision, delay, gateway losses, queue
state, optional boundary-activation RMS), ``run()`` returning the classic
:class:`FLResult`, ``reset(seed)`` restoring params, batch RNG **and**
network channel-state RNG together, and ``save()``/``Simulation.resume()``
through ``repro_torch.checkpoint.store`` for bit-identical
checkpoint-resume, in the reference's file format. The control plane
(network draws, DDSRA, queues) is the reference's numpy, drawn from the
same generators in the same order, so decisions, queues and delays are
bit-identical to ``repro``'s for the same statistics; the data plane runs in
PyTorch on ``device`` (``"cuda"`` unless the caller passes ``"cpu"``), and
so does the batched control plane of ``policy="ddsra_jax"`` and of
``sweep`` (``repro_torch.fl.fused_sim``), in float64. The fused loop
(``fused_rounds``, ``run_fused``; ``repro_torch.fl.fused_sim``) runs a
block of rounds as one decide pass and one training pass, one CUDA graph
replay a trained round, and leaves the stepwise loop's end state; under
``Scenario.data_plane="traced"`` batches are counter-based draws
(``repro_torch.fl.data.traced_batch_indices``), jax's threefry draws
reproduced bit for bit, gathered on the device.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import pathlib
import queue
import re
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import costmodel as cm
from repro_torch.core.ddsra import RoundDecision, Workload
from repro_torch.core.lyapunov import update_queues_realized
from repro_torch.core.network import Network, NetworkConfig
from repro_torch.core.participation import (DataStats, divergence_bound,
                                            participation_rates)
from repro_torch.core.schedulers import (POLICIES, RoundContext, make_policy,
                                         policy_state, set_policy_state)
from repro_torch.device import resolve_device, use_f32_numerics
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import fused_sim
from repro_torch.fl import split as split_lib
from repro_torch.fl import threefry
from repro_torch.fl.data import (CohortLayout, device_resident_stacks,
                                 make_fl_dataset, make_token_fl_dataset,
                                 sample_batch, sample_cohort_batch,
                                 sample_cohort_batch_traced)
from repro_torch.fl.faults import FaultModel
from repro_torch.fl.roles import BaseStation, Device, Gateway
from repro_torch.models import registry as model_registry
from repro_torch.models.convert import params_from_numpy, params_to_numpy


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------


# models whose Scenario(dtype="bf16") the port runs (the reference's cohort
# engine takes bf16 for any model): VGG's and the MLP's fc layers run the
# fused linear kernels' bf16 forms, the transformer's and the MoE model's
# attention and the SSM's scan the flash-attention and SSD kernels' bf16
# forms
BF16_MODELS = ("vgg", "mlp", "transformer", "moe", "ssm")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Frozen, JSON-serializable spec of one FL experiment.

    The reference's fields and defaults. The port runs every engine of
    the reference, ``data_plane="host"`` on all of them and ``"traced"``
    on the cohort engines (``"cohort"``, ``"sharded"``, ``"async"``), with
    ``dtype="f32"`` for every model and ``dtype="bf16"`` on the cohort
    engines for the models of ``BF16_MODELS``; the fault axes,
    ``buffer_k`` and the staleness knobs belong to the async engine,
    ``mesh_shape`` (the cohort mesh's rank count, ``None`` every rank) to
    the sharded one.
    """
    model: str = "vgg"                 # repro_torch.models.registry key
    width_mult: float = 0.25
    classes: int = 10
    mlp_hidden: Tuple[int, ...] = (128, 64)
    seq_len: int = 32                  # sequence length for token models
    k_iters: int = 5                   # local epochs K
    lr: float = 0.01                   # step size beta
    alpha: float = 0.05                # training data sampling ratio
    rounds: int = 50
    v: float = 0.01                    # Lyapunov control parameter
    policy: str = "ddsra"              # default scheduling policy name
    seed: int = 0
    eval_every: int = 5
    max_dataset: int = 2000
    chi: float = 1.0                   # non-IID degree
    sigma_samples: int = 8             # per-sample grads for sigma estimation
    engine: str = "cohort"             # ENGINES key
    # tiered slot widths: an int (1 = single width) or "auto"
    # (CohortLayout.auto_tiers)
    tiers: Union[int, str] = 1
    mesh_shape: Optional[Tuple[int, ...]] = None
    keep_last: Optional[int] = None
    # data-plane dtype: "f32", or "bf16" (mixed precision: bf16 rounds over
    # f32 masters; the models of BF16_MODELS)
    dtype: str = "f32"
    # "host": batches drawn from the numpy stream; "traced": counter-based
    # draws keyed by (data_key, round, device), gathered on the device
    data_plane: str = "host"
    # model-upload compression: bits per parameter priced into the DDSRA
    # upload-delay/energy terms (None = the model's native precision)
    upload_bits: Optional[float] = None
    # fault axes (engine="async" only; repro_torch.fl.faults): per-round,
    # per-device probabilities of churning offline at dispatch, of losing
    # the trained update mid-round, and of straggling by an
    # Exp(mean=straggler_scale) multiplicative delay factor
    churn: float = 0.0
    dropout: float = 0.0
    straggler_frac: float = 0.0
    straggler_scale: float = 0.0
    # buffered aggregation (engine="async"): aggregate once buffer_k
    # gateway updates have landed; None = drain the round's whole cohort
    # first (the barrier in buffered form)
    buffer_k: Optional[int] = None
    # staleness weight (1 + tau)^(-staleness_alpha); updates older than
    # max_staleness aggregation versions are discarded (None = keep)
    staleness_alpha: float = 0.5
    max_staleness: Optional[int] = None
    net: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)

    @property
    def effective_upload_bits(self) -> Optional[float]:
        """Bits per parameter the cost model prices the model upload at:
        ``upload_bits`` when set, else 16 for the bf16 data plane, else
        ``None`` — the model's native precision."""
        if self.upload_bits is not None:
            return float(self.upload_bits)
        return 16.0 if self.dtype == "bf16" else None

    def to_json(self) -> dict:
        """Serialize to a plain-JSON dict (tuples become lists)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Scenario":
        """Rebuild from :meth:`to_json` output: missing fields take their
        defaults, unknown fields (top level or ``net``) are dropped with a
        warning."""
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            warnings.warn(
                f"Scenario.from_json: ignoring unknown fields {unknown} "
                "(written by a newer version?)", stacklevel=2)
            for k in unknown:
                d.pop(k)
        net = d.pop("net", {})
        if isinstance(net, dict):
            net = dict(net)
            net_known = {f.name for f in dataclasses.fields(NetworkConfig)}
            net_unknown = sorted(set(net) - net_known)
            if net_unknown:
                warnings.warn(
                    "Scenario.from_json: ignoring unknown net fields "
                    f"{net_unknown} (written by a newer version?)",
                    stacklevel=2)
                for k in net_unknown:
                    net.pop(k)
            for k in ("f_dev_range", "dist_range"):
                if k in net:
                    net[k] = tuple(net[k])
            net = NetworkConfig(**net)
        d["mlp_hidden"] = tuple(d.get("mlp_hidden", (128, 64)))
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        return cls(net=net, **d)


# ---------------------------------------------------------------------------
# RoundRecord / FLResult
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundRecord:
    """Telemetry for one simulated round (yielded by Simulation.rounds()).

    The staleness/fault fields belong to the buffered async engine;
    synchronous engines leave them at their barrier-semantics values.
    """
    t: int
    selected: np.ndarray               # (M,) gateway participation this round
    trained: List[int]                 # gateways that actually trained
    l_n: np.ndarray                    # (N,) per-device partition points
    delay: float                       # realized round delay (time advanced)
    cum_delay: float
    queues: np.ndarray                 # (M,) virtual-queue backlog
    losses: np.ndarray                 # (M,) per-gateway local losses
    failures: int                      # resource-infeasible gateways
    boundary_rms: Optional[np.ndarray] = None
    accuracy: Optional[float] = None   # test accuracy on eval rounds
    aggregations: int = 0
    staleness_mean: float = 0.0
    staleness_max: int = 0
    stale_discarded: int = 0
    dropped_devices: int = 0
    lost_devices: int = 0
    straggler_devices: int = 0
    buffer_fill: int = 0
    inflight: int = 0


def resolve_decision(dec: RoundDecision, gateways, n_devices: int):
    """Resolve a schedule into what actually trains this round.

    For each selected gateway, look up its assigned channel's solution,
    fail it (counted) when the solve is infeasible or non-finite, and
    scatter the per-lane partition points of surviving gateways into the
    dense (N,) vector. Returns ``(trained, l_n, gw_delay, failures)``.
    """
    trained, l_n = [], np.zeros(n_devices, int)
    gw_delay: Dict[int, float] = {}
    failures = 0
    for m in np.where(dec.selected)[0]:
        j = int(np.argmax(dec.assignment[m]))
        sol = dec.solutions.get((int(m), j))
        if sol is None:
            continue
        if not sol.feasible or not np.isfinite(sol.delay):
            failures += 1     # energy/memory violation: round fails
            continue
        gw_delay[int(m)] = float(sol.delay)
        trained.append(int(m))
        for i, dev in enumerate(gateways[m].devices):
            l_n[dev.idx] = int(sol.l_split[i])
    return trained, l_n, gw_delay, failures


@dataclasses.dataclass
class FLResult:
    """Aggregate outcome of a full run (built by ``Simulation.result_of``)."""
    accuracy: List[float]
    acc_rounds: List[int]
    cum_delay: List[float]
    participation: np.ndarray          # (T, M)
    gamma_targets: np.ndarray
    losses: List[float]
    phi: np.ndarray
    failures: int


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

ENGINES: Dict[str, Type["Engine"]] = {}


def register_engine(name: str):
    """Class decorator: register an :class:`Engine` under ``name`` (the
    value a ``Scenario.engine`` field refers to). Duplicate names raise."""
    def deco(cls):
        if name in ENGINES:
            raise ValueError(f"engine {name!r} already registered")
        ENGINES[name] = cls
        cls.name = name
        return cls
    return deco


# the reference's engines that the port has not yet, by ROADMAP.md item
UNPORTED_ENGINES: Dict[str, str] = {}


def make_engine(name: str) -> "Engine":
    """Instantiate a registered engine by name (see ``ENGINES``)."""
    if name in UNPORTED_ENGINES:
        _unported(f"engine {name!r}", UNPORTED_ENGINES[name])
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}: "
                         f"expected one of {sorted(ENGINES)}")
    return ENGINES[name]()


@dataclasses.dataclass
class RoundOutcome:
    """What actually happened when an engine executed a scheduled round.

    Synchronous engines realize exactly what was scheduled (``realized``
    stays ``None``: the policy's own queue update stands); the buffered
    async engine reports realized completion instead: the time actually
    advanced (straggler tails included), which gateways' updates actually
    landed, and the staleness/fault telemetry threaded into
    :class:`RoundRecord`.
    """
    delay: float                       # realized time advanced this round
    boundary_rms: Optional[np.ndarray] = None
    # (M,) bool realized participation indicator for the Lyapunov queue
    # update (lyapunov.update_queues_realized); None = as scheduled
    realized: Optional[np.ndarray] = None
    aggregations: int = 0
    staleness_mean: float = 0.0
    staleness_max: int = 0
    stale_discarded: int = 0
    dropped_devices: int = 0
    lost_devices: int = 0
    straggler_devices: int = 0
    buffer_fill: int = 0
    inflight: int = 0


class Engine:
    """Protocol: how a scheduled round is executed on the model.

    The reference's ``Engine``, implemented by ``CohortEngine``,
    ``ShardedCohortEngine``, ``AsyncCohortEngine`` and
    ``SequentialEngine``.
    """
    name: str
    # compute dtypes this engine can run the data plane in; Simulation
    # rejects a Scenario whose ``dtype`` the chosen engine cannot honor
    # (silently training in f32 would falsify the priced upload_bits)
    supported_dtypes: Tuple[str, ...] = ("f32",)
    # whether the engine honors the Scenario fault axes (churn/dropout/
    # stragglers) and buffer_k; Simulation rejects active fault axes on
    # engines that would silently train fault-free
    supports_faults: bool = False
    # whether :meth:`fused_train` runs a whole block of rounds (the fused
    # loop, ``repro_torch.fl.fused_sim``); engines without it are refused
    # before any RNG stream is consumed
    supports_fused: bool = False
    # whether the engine honors ``Scenario.data_plane="traced"``;
    # Simulation rejects the traced plane on engines that would keep
    # sampling from the numpy stream (the planes draw different batches)
    supports_traced_data: bool = False

    def estimate_stats(self, sim: "Simulation", params) -> DataStats:
        """Estimate the per-device sigma_n/delta_n/L_n statistics the
        divergence bound (paper Sec. VII-A) needs."""
        raise NotImplementedError

    def train_round(self, sim: "Simulation", trained: List[int],
                    l_n: np.ndarray,
                    with_boundary: bool = False) -> Optional[np.ndarray]:
        """Train one round in-place on ``sim`` (params + per-gateway
        losses); returns the (N,) boundary-activation RMS when requested
        and supported, else None."""
        raise NotImplementedError

    def run_round(self, sim: "Simulation", dec: RoundDecision,
                  trained: List[int], l_n: np.ndarray,
                  gw_delay: Dict[int, float],
                  boundary: bool = False) -> RoundOutcome:
        """Execute one scheduled round: train the scheduled cohort and
        realize exactly the scheduled delays (the FedAvg barrier waits for
        the slowest gateway, ``max`` over ``gw_delay``)."""
        rms = self.train_round(sim, trained, l_n, with_boundary=boundary)
        return RoundOutcome(delay=max(gw_delay.values(), default=0.0),
                            boundary_rms=rms,
                            aggregations=1 if trained else 0)

    def inflight_counts(self, sim: "Simulation") -> Optional[np.ndarray]:
        """(M,) per-gateway count of dispatched-but-not-landed updates,
        offered to policies via ``RoundContext.inflight``; synchronous
        engines have none (``None``)."""
        return None

    def fused_train(self, sim: "Simulation", params, losses0, xs, ys,
                    masks, ls, ws, gws, trained, eval_mask=None):
        """Run a whole pre-packed block of rounds (the fused loop,
        ``repro_torch.fl.fused_sim``).

        ``xs/ys/masks/ls/ws/gws`` are per-tier tuples of tensors with a
        leading round axis (tier k: ``(T, S_k, ...)``), ``trained`` the
        (T, M) bool trained-gateway mask, ``eval_mask`` the (T,) bool
        ``eval_every`` schedule (None: never evaluate). Returns (final
        params, final (M,) losses, (T, M) loss history, (T,) test hits,
        -1 on rounds not evaluated), on the device. Engines without a
        scanned round raise: ``Simulation.rounds()`` is their only path.
        """
        raise NotImplementedError(
            f"engine {self.name!r} has no fused scan path; use "
            "Simulation.rounds()")

    def reset(self, sim: "Simulation") -> None:
        """Discard engine-internal *run* state (default: none). Called from
        :meth:`Simulation.restart`, and so from ``run()`` and ``reset()``."""
        return None

    def writes_checkpoints(self, sim: "Simulation") -> bool:
        """Whether this process writes ``sim``'s checkpoint files (every
        rank of a sharded run holds the same state; its first writes)."""
        return True

    def sync(self, sim: "Simulation") -> None:
        """Wait for every process that runs ``sim`` (default: there is one)
        — after a checkpoint is written, before any of them reads it."""
        return None

    def state_dict(self, sim: "Simulation"):
        """Engine-internal state to checkpoint, as ``(meta, arrays)`` —
        ``meta`` a JSON-serializable dict stored in the ``sim_*.json``
        manifest, ``arrays`` a tree written beside the params (prefix
        ``engine_``) — or ``None`` for stateless engines (the default)."""
        return None

    def load_state_dict(self, sim: "Simulation", meta: dict, path,
                        step: int) -> None:
        """Restore what :meth:`state_dict` captured (default: nothing)."""
        return None


@register_engine("cohort")
class CohortEngine(Engine):
    """One slot-batched round per FL round (see ``repro_torch.fl.cohort``).

    Participants are packed into a fixed tier-major slot layout
    (``repro_torch.fl.data.CohortLayout``; ``Scenario.tiers`` sets how many
    distinct slot widths are used). Where the round and the statistics
    pass run is the hooks' business (:meth:`_fused_round`,
    :meth:`_fused_stats`, :meth:`_shard_count`, :meth:`_slot_blocks`,
    :meth:`_reduce`): the sharded subclass overrides them, and only them.
    """

    supported_dtypes = ("f32", "bf16")
    supports_fused = True
    supports_traced_data = True

    def _shard_count(self, sim: "Simulation") -> int:
        """Multiple each tier's slot count must divide into (the cohort
        mesh size for the sharded subclass; 1 on a single device)."""
        return 1

    def _layout(self, sim: "Simulation", capacity: int) -> CohortLayout:
        """The (cached) fixed slot layout for ``capacity``-slot rounds."""
        key = (capacity, sim.scenario.tiers, self._shard_count(sim))
        if key not in sim._layouts:
            sim._layouts[key] = CohortLayout.build(
                sim.d_tilde, capacity, sim.scenario.tiers,
                self._shard_count(sim))
        return sim._layouts[key]

    def _fused_round(self, sim: "Simulation", params, batch, l_slot, w_slot,
                     gw_slot, *, with_boundary: bool,
                     with_gateway_models: bool):
        """Execute one round (``repro_torch.fl.cohort.cohort_round``); the
        sharded subclass overrides this to change *where* it runs without
        touching the packing and telemetry around it. Always returns the
        6-tuple (new_global, gw_loss, gw_count, slot_losses, boundary,
        gw_models), ``gw_models`` None when not asked for; tensors on the
        simulation's device."""
        sc = sim.scenario
        out = cohort_lib.cohort_round(
            sim.plan, params, batch, l_slot, w_slot, gw_slot, sc.k_iters,
            sc.lr, with_boundary=with_boundary,
            with_gateway_models=with_gateway_models, compute_dtype=sc.dtype,
            device=sim.device)
        return out if with_gateway_models else (*out, None)

    def _fused_stats(self, sim: "Simulation", params, batch, mix):
        """The sigma/delta/L_n pass (``cohort_lib.cohort_stats``); the
        sharded subclass overrides this to split it over the mesh. Three
        (N,) tensors on the device."""
        sc = sim.scenario
        return cohort_lib.cohort_stats(sim.plan, params, batch, mix, sc.lr,
                                       sc.sigma_samples, device=sim.device)

    def _slot_blocks(self, sim: "Simulation", sizes) -> Tuple[slice, ...]:
        """The slots of each tier (of ``sizes`` slots) this process trains
        in the fused loop: all of them on one device."""
        return tuple(slice(0, s) for s in sizes)

    def _reduce(self, sim: "Simulation"):
        """The fused loop's in-place sum of a round's FedAvg sums over the
        processes that share its slots (``cohort_lib.train_scan``'s
        ``reduce``): None on one device, where a round is one graph."""
        return None

    def estimate_stats(self, sim: "Simulation", params) -> DataStats:
        """sigma/delta/Lipschitz for every device in one slot-batched pass."""
        n_dev = sim.net.cfg.n_devices
        batch = sample_cohort_batch(sim.rng, sim.ds, range(n_dev),
                                    sim.d_tilde, int(sim.d_tilde.max()))
        mix = sim.d_sizes / sim.d_sizes.sum()
        sigma, delta, lips = (t.cpu().numpy() for t in self._fused_stats(
            sim, params, batch, mix))
        return DataStats(sigma, delta, np.maximum(lips, 0.1),
                         sim.d_tilde.astype(float))

    def _cohort(self, sim: "Simulation", trained: List[int]):
        """The trained gateways' devices in gateway-major order, and the
        fixed slot layout that holds them (the all-devices layout if they
        ever outnumber the capacity)."""
        device_ids: List[int] = []
        for m in trained:
            device_ids.extend(dev.idx for dev in sim.gateways[m].devices)
        cap = sim.cohort_capacity if len(device_ids) <= sim.cohort_capacity \
            else sim.net.cfg.n_devices
        return device_ids, self._layout(sim, cap)

    def _pack_round(self, sim: "Simulation", trained: List[int],
                    l_n: np.ndarray):
        """Pack the scheduled devices into the fixed slot layout.

        Draws come from ``sim.rng`` in gateway-major device order, as the
        reference's packing makes them; under ``data_plane="traced"`` from
        the counter-based draws of round ``sim.t`` (no host RNG consumed),
        which the fused scan's in-graph gathers equal. Returns
        (device_ids, batch, l_slot, w_slot, slot_gw).
        """
        device_ids, layout = self._cohort(sim, trained)
        if sim.scenario.data_plane == "traced":
            batch = sample_cohort_batch_traced(sim.data_key, sim.t, sim.ds,
                                               device_ids, sim.d_tilde,
                                               layout=layout)
        else:
            batch = sample_cohort_batch(sim.rng, sim.ds, device_ids,
                                        sim.d_tilde, layout=layout)
        n_slots = layout.n_slots
        l_slot = np.zeros(n_slots, int)
        w_slot = np.zeros(n_slots, np.float32)
        slot_gw = np.zeros((n_slots, sim.net.cfg.n_gateways), np.float32)
        for di, n in enumerate(device_ids):
            s = int(batch.slot_of[di])
            l_slot[s] = l_n[n]
            w_slot[s] = sim.d_tilde[n]
            slot_gw[s, sim.net.assign[n]] = 1.0
        return device_ids, batch, l_slot, w_slot, slot_gw

    def train_round(self, sim: "Simulation", trained: List[int],
                    l_n: np.ndarray,
                    with_boundary: bool = False) -> Optional[np.ndarray]:
        """Pack the scheduled devices and run the cohort round in place on
        ``sim``; with ``with_boundary``, the slots' boundary RMS scattered
        back to device order (0 for devices that did not train)."""
        if not trained:
            return None
        device_ids, batch, l_slot, w_slot, slot_gw = self._pack_round(
            sim, trained, l_n)
        new_global, gw_loss, _, _, boundary, _ = self._fused_round(
            sim, sim.params, batch, l_slot, w_slot, slot_gw,
            with_boundary=with_boundary, with_gateway_models=False)
        sim.params = new_global
        # padded-vs-real sample accounting, as the reference's
        sim.padding_stats["real_samples"] += float(
            sum(t.mask.sum() for t in batch.tiers))
        sim.padding_stats["padded_samples"] += float(
            batch.layout.padded_samples)
        gw_loss = gw_loss.cpu().numpy()
        for m in trained:
            sim.losses[m] = float(gw_loss[m])
        if not with_boundary:
            return None
        rms = np.zeros(sim.net.cfg.n_devices)
        rms[device_ids] = boundary.cpu().numpy()[batch.slot_of]
        return rms

    def fused_train(self, sim: "Simulation", params, losses0, xs, ys,
                    masks, ls, ws, gws, trained, eval_mask=None):
        """A block as one captured round replayed once a round
        (``repro_torch.fl.cohort.train_scan``) over the stacked packed
        batches and decision tensors."""
        sc = sim.scenario
        trained = np.asarray(trained, bool)
        if eval_mask is None:
            eval_mask = np.zeros(trained.shape[0], bool)
        x_test, y_test = self._eval_arrays(sim)
        return cohort_lib.train_scan(
            sim.plan, params, self._losses(sim, losses0), xs, ys, masks, ls,
            ws, gws, torch.as_tensor(trained, device=sim.device), sc.lr,
            np.asarray(eval_mask, bool), x_test, y_test,
            k_iters=sc.k_iters, compute_dtype=sc.dtype,
            graphs=sim._fused_graphs, reduce=self._reduce(sim))

    @staticmethod
    def _losses(sim: "Simulation", losses0) -> torch.Tensor:
        """The scan's f32 loss carry on the device."""
        return torch.as_tensor(np.asarray(losses0), dtype=torch.float32,
                               device=sim.device)

    def _pack_round_meta(self, sim: "Simulation", trained: List[int],
                         l_n: np.ndarray):
        """:meth:`_pack_round`'s slot assignment without drawing a sample:
        the traced data plane's packing, whose scan gathers each slot's
        batch on the device from its device id, so the host ships only
        the round's (slot -> device, l, weight, gateway) metadata.

        Slot ranks are ``sample_cohort_batch_traced``'s (the same stable
        argsort over the same clipped batch lengths), so per-slot outputs
        scatter back to devices alike on both paths. Returns (device_ids,
        layout, slot_dev (-1: empty slot), l_slot, w_slot, slot_gw,
        real_samples).
        """
        device_ids, layout = self._cohort(sim, trained)
        pools = np.array([len(sim.ds.y_dev[n]) for n in device_ids],
                         dtype=int)
        lens = np.minimum(sim.d_tilde[device_ids], pools) if device_ids \
            else np.zeros(0, dtype=int)
        n_slots = layout.n_slots
        slot_dev = np.full(n_slots, -1, np.int32)
        l_slot = np.zeros(n_slots, int)
        w_slot = np.zeros(n_slots, np.float32)
        slot_gw = np.zeros((n_slots, sim.net.cfg.n_gateways), np.float32)
        for rank, di in enumerate(np.argsort(-lens, kind="stable")):
            n = device_ids[di]
            slot_dev[rank] = n
            l_slot[rank] = l_n[n]
            w_slot[rank] = sim.d_tilde[n]
            slot_gw[rank, sim.net.assign[n]] = 1.0
        return (device_ids, layout, slot_dev, l_slot, w_slot, slot_gw,
                int(lens.sum()))

    def _data_stacks(self, sim: "Simulation"):
        """The device-resident shard stacks the traced plane gathers from
        (``repro_torch.fl.data.device_resident_stacks``), made at first
        use and kept for the simulation's life (its dataset is fixed, so
        they survive reset and restart): (x_all, y_all) on the device,
        ``pool`` (N,) numpy."""
        if sim._resident_stacks is None:
            sim._resident_stacks = device_resident_stacks(sim.ds, sim.device)
        return sim._resident_stacks

    def _eval_arrays(self, sim: "Simulation"):
        """(x_test, y_test) on the device, kept as :meth:`_data_stacks`
        is."""
        if sim._resident_eval is None:
            sim._resident_eval = tuple(
                torch.as_tensor(np.asarray(a)).to(sim.device)
                for a in (sim.ds.x_test, sim.ds.y_test))
        return sim._resident_eval

    def fused_train_traced(self, sim: "Simulation", params, losses0, ts,
                           slot_devs, ls, ws, gws, trained, eval_mask,
                           layout):
        """:meth:`fused_train` with the data plane inside the graph
        (``repro_torch.fl.cohort.train_scan_traced``): each round gathers
        its batches on the device from the resident shard stacks, so the
        host never builds the (T, S_k, W_k, ...) sample stacks.
        ``slot_devs/ls/ws/gws`` are per-tier tensors with a leading round
        axis; ``ts`` the absolute rounds the draws fold in."""
        sc = sim.scenario
        x_all, y_all, pool = self._data_stacks(sim)
        x_test, y_test = self._eval_arrays(sim)

        def ints(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=sim.device)
        return cohort_lib.train_scan_traced(
            sim.plan, params, self._losses(sim, losses0), x_all, y_all,
            ints(pool), ints(np.minimum(sim.d_tilde, pool)),
            sim.data_key.to(sim.device), ints(ts), slot_devs, ls, ws, gws,
            torch.as_tensor(np.asarray(trained, bool), device=sim.device),
            sc.lr, np.asarray(eval_mask, bool), x_test, y_test,
            k_iters=sc.k_iters, compute_dtype=sc.dtype,
            tier_widths=tuple(layout.tier_widths), graphs=sim._fused_graphs,
            reduce=self._reduce(sim))

    def shop_floor_round(self, sim: "Simulation", device_ids: List[int],
                         l_n: np.ndarray, params=None,
                         rng: Optional[np.random.Generator] = None):
        """A cohort round over ``device_ids`` that also returns the
        per-gateway shop-floor models (the intermediate the Fig. 2
        divergence experiment compares against a centralized twin).

        Batches are drawn from ``rng`` (default ``sim.rng``) in
        ``device_ids`` order — the draws the sequential per-device loop
        makes — and returned, so the caller can pool them. This path keeps
        the all-devices layout (row n = device n), so ``l_n`` and the
        weights index devices directly.

        Returns (new_global, gateway_models (leading M axis),
        gateway_losses (M,) numpy, CohortBatch).
        """
        rng = sim.rng if rng is None else rng
        params = sim.params if params is None else params
        ids = list(device_ids)
        weights = np.zeros(sim.net.cfg.n_devices, np.float32)
        weights[ids] = sim.d_tilde[ids]
        batch = sample_cohort_batch(rng, sim.ds, ids, sim.d_tilde,
                                    int(sim.d_tilde.max()))
        new_global, gw_loss, _, _, _, gw_models = self._fused_round(
            sim, params, batch, l_n, weights, sim.net.a,
            with_boundary=False, with_gateway_models=True)
        return new_global, gw_models, gw_loss.cpu().numpy(), batch


@register_engine("sequential")
class SequentialEngine(Engine):
    """Per-device loop (kept as the parity reference): one model at a time,
    on the same kernels as the cohort round."""

    def estimate_stats(self, sim: "Simulation", params) -> DataStats:
        """sigma/delta/Lipschitz estimated one device at a time, from the
        same draws of ``sim.rng`` as the reference's loop: each device's
        batch gradient, ``sigma_samples`` per-sample gradients and the
        gradient one SGD step along the batch gradient."""
        sc = sim.scenario
        grads, sigmas, lips = [], [], []
        w0 = split_lib.flat_params(params)
        for n in range(sim.net.cfg.n_devices):
            x, y = (torch.as_tensor(a, device=sim.device)
                    for a in sample_batch(sim.rng, sim.ds, n,
                                          sim.d_tilde[n]))
            g = split_lib.flat_grad(sim.plan, params, x, y)
            grads.append(g)
            # sigma: per-sample gradient spread
            per = torch.stack([
                split_lib.flat_grad(sim.plan, params, x[i:i + 1],
                                    y[i:i + 1])
                for i in range(min(sc.sigma_samples, len(y)))])
            sigmas.append(float(torch.linalg.vector_norm(
                per - per.mean(dim=0), dim=1).mean()))
            # L_n: two-point secant
            pert = split_lib._like(
                [w - sc.lr * gi for w, gi in zip(
                    split_lib.leaves(params), _unflatten_like(g, params))],
                params)
            g2 = split_lib.flat_grad(sim.plan, pert, x, y)
            dw = torch.linalg.vector_norm(split_lib.flat_params(pert) - w0)
            lips.append(float(torch.linalg.vector_norm(g2 - g)
                              / dw.clamp_min(1e-9)))
        # delta: divergence from the D_n-weighted global gradient, in f64
        # as the reference's numpy sums it
        weights = sim.d_sizes / sim.d_sizes.sum()
        global_g = torch.zeros_like(grads[0], dtype=torch.float64)
        for w, g in zip(weights, grads):
            global_g += float(w) * g.double()
        deltas = [float(torch.linalg.vector_norm(g.double() - global_g))
                  for g in grads]
        return DataStats(np.asarray(sigmas), np.asarray(deltas),
                         np.maximum(np.asarray(lips), 0.1),
                         sim.d_tilde.astype(float))

    def train_round(self, sim: "Simulation", trained: List[int],
                    l_n: np.ndarray,
                    with_boundary: bool = False) -> Optional[np.ndarray]:
        """One round as the seed ran it: a loop over gateways and their
        devices (``Gateway.shop_floor_round``), then the base station's
        FedAvg. Reports no boundary RMS (None), as the reference's."""
        sc = sim.scenario
        models, weights = [], []
        for m in trained:
            gw = sim.gateways[m]
            l_splits = np.asarray([l_n[d.idx] for d in gw.devices])
            combined, gw_loss, w_m = gw.shop_floor_round(
                sim.plan, sim.params, sim.ds, l_splits, sc.k_iters, sc.lr,
                sim.rng)
            models.append(combined)
            weights.append(w_m)
            sim.losses[m] = gw_loss
        sim.bs.aggregate(models, np.asarray(weights))
        return None


# ---------------------------------------------------------------------------
# Simulation
# ---------------------------------------------------------------------------

PolicyLike = Union[str, object, None]


class _CheckpointWriter:
    """One daemon thread draining checkpoint write jobs in FIFO order.

    ``submit`` returns at once; ``flush`` blocks until every submitted job
    has finished and re-raises the first exception any job hit. Jobs must
    close over host *snapshots* (numpy arrays, encoded bytes) taken on the
    calling thread: the caller's tensors may change in place, and on the
    card they live on another stream, so the writer touches only numpy and
    the disk, never CUDA.

    The thread is a daemon, so an atexit hook drains the queue at
    interpreter shutdown: every submitted checkpoint lands even if
    ``flush`` is never called (a swallowed error becomes a warning there).
    """

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ckpt-writer")
        self._thread.start()
        atexit.register(self._drain_at_exit)

    def _drain_at_exit(self) -> None:
        self._q.join()
        if self._err is not None:
            warnings.warn(f"background checkpoint write failed and was "
                          f"never flush()ed: {self._err!r}")

    def _loop(self):
        while True:
            job = self._q.get()
            try:
                job()
            except BaseException as e:      # surfaced at the next flush()
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    def submit(self, job) -> None:
        self._q.put(job)

    def flush(self) -> None:
        self._q.join()
        err, self._err = self._err, None
        if err is not None:
            raise err


class Simulation:
    """Composable FL simulation over a :class:`Scenario`.

    State is resolved once at construction (topology, dataset, model, layer
    cost model, per-device statistics); ``rounds()`` then streams
    :class:`RoundRecord` telemetry one round at a time, with
    ``boundary=True`` the per-device boundary RMS; ``save``, ``flush`` and
    ``resume`` checkpoint and continue a run, on the cohort or the
    sequential engine; ``sweep`` runs a scheduling sweep on the device;
    ``fused_rounds`` and ``run_fused`` run rounds through the fused loop
    on the cohort engines; the async engine runs the fault axes and
    buffered aggregation stepwise; the sharded engine runs every rank of
    a process group through the same Simulation, each training its own
    slots (``repro_torch.fl.shard``).

    ``device``: where the data plane runs (``"cuda"`` unless the caller
    passes ``"cpu"``). ``init_params``: numpy params in the reference's
    layout (``jax.tree.map(np.asarray, params)``) to start from instead of
    the port's own seeded init, which draws from a torch generator, not
    the reference's ``jax.random`` initializers.
    ``_stats``: skip the estimation pass (callers then restore the batch
    RNG state themselves, since no estimation draws are consumed).
    """

    def __init__(self, scenario: Scenario,
                 _stats: Optional[DataStats] = None, *, device="cuda",
                 init_params=None):
        self.scenario = sc = scenario
        self.device = resolve_device(device)
        use_f32_numerics()
        self.engine: Engine = make_engine(sc.engine)
        if sc.dtype not in cohort_lib.COMPUTE_DTYPES:
            raise ValueError(
                f"Scenario.dtype={sc.dtype!r}: expected one of "
                f"{sorted(cohort_lib.COMPUTE_DTYPES)}")
        if sc.dtype not in self.engine.supported_dtypes:
            raise ValueError(
                f"engine {sc.engine!r} supports dtypes "
                f"{self.engine.supported_dtypes}, not {sc.dtype!r}")
        if sc.dtype == "bf16" and sc.model not in BF16_MODELS:
            raise NotImplementedError(
                f"Scenario(model={sc.model!r}, dtype='bf16'): the bf16 data "
                f"plane runs {', '.join(BF16_MODELS)}")
        if sc.data_plane not in ("host", "traced"):
            raise ValueError(
                f"Scenario.data_plane={sc.data_plane!r}: expected 'host' "
                "or 'traced'")
        if sc.data_plane == "traced" and \
                not self.engine.supports_traced_data:
            raise ValueError(
                f"engine {sc.engine!r} samples batches host-side: it "
                "cannot honor data_plane='traced'; use a cohort engine")
        if sc.buffer_k is not None and sc.buffer_k < 1:
            raise ValueError(f"Scenario.buffer_k must be >= 1 or None, "
                             f"got {sc.buffer_k}")
        self.faults = FaultModel.from_scenario(sc)
        if ((self.faults.active or sc.buffer_k is not None)
                and not self.engine.supports_faults):
            raise ValueError(
                f"engine {sc.engine!r} is synchronous: it cannot honor "
                f"fault axes (churn/dropout/stragglers) or buffer_k; use "
                f"engine='async'")
        self.net = Network(sc.net, np.random.default_rng(sc.seed))
        self.rng = np.random.default_rng(sc.seed + 1)
        ncfg = self.net.cfg

        # local dataset sizes D_n ~ U(0, 2000]; training batch D~_n = alpha*D_n
        self.d_sizes = np.maximum(
            (self.rng.uniform(0, sc.max_dataset, ncfg.n_devices)).astype(int),
            40)
        self.d_tilde = np.maximum((sc.alpha * self.d_sizes).astype(int), 4)

        # model resolved through the registry + layer-level costs (Table II);
        # built *before* the dataset so its input_kind picks the data path.
        # Its init draws from a torch generator, never from the numpy stream
        self.plan, params, self.layers = self._build_params(sc.seed)
        if init_params is not None:
            params = params_from_numpy(self.plan, init_params, self.device)
        self.bs = BaseStation(self.plan, params)

        if self.plan.input_kind == "tokens":
            # token models: per-device Markov-chain corpora whose transition
            # tables play the role of the class mixture (chi-mixed); no
            # class counts are drawn from self.rng
            self.ds = make_token_fl_dataset(
                ncfg.n_devices, self.d_sizes, vocab=self.plan.classes,
                seq_len=sc.seq_len, chi=sc.chi, seed=sc.seed)
        else:
            # non-IID classes: gateway 0's devices see the widest variety
            # (paper Sec. VII-B: "the 1-th gateway ... a wider variety")
            q = np.zeros(ncfg.n_devices, dtype=int)
            for n in range(ncfg.n_devices):
                gw = self.net.assign[n]
                q[n] = sc.classes if gw == 0 else int(self.rng.integers(1, 4))
            self.ds = make_fl_dataset(ncfg.n_devices, self.d_sizes, q,
                                      chi=sc.chi, classes=sc.classes,
                                      seed=sc.seed)

        o = cm.flops_vector(self.layers)
        g = cm.mem_vector(self.layers, batch=int(self.d_tilde.max()))
        self.workload = Workload(
            o, g, cm.upload_bytes(self.layers, sc.effective_upload_bits),
            sc.k_iters, self.d_tilde.astype(float))

        self.gateways = [
            Gateway(m, [Device(int(n), m, int(self.d_sizes[n]),
                               int(self.d_tilde[n]))
                        for n in self.net.devices_of(m)])
            for m in range(ncfg.n_gateways)]

        # the scheduler can select at most n_channels gateways per round
        # (C2/C3), so this many slots always fit every round's participants
        per_gw = int(np.bincount(self.net.assign,
                                 minlength=ncfg.n_gateways).max())
        self.cohort_capacity = min(ncfg.n_devices, ncfg.n_channels * per_gw)
        self._layouts: Dict = {}      # (capacity, tiers, shards) -> layout

        t0 = time.perf_counter()
        self.stats = _stats if _stats is not None \
            else self.engine.estimate_stats(self, params)
        self.stats_seconds = time.perf_counter() - t0
        self.phi = divergence_bound(self.stats, self.net.assign,
                                    sc.lr, sc.k_iters)
        self.gamma = participation_rates(self.phi, ncfg.n_channels)

        # snapshots for reset(): fresh-Simulation replay of all three streams
        self._init_params = params
        self._rng_state0 = self.rng.bit_generator.state
        self._net_rng_state0 = self.net.rng.bit_generator.state

        self._policy = None
        self.run_seed = sc.seed   # threaded into stochastic policies
        self._sweep_plan = None   # built by the first sweep()
        # the fused loop's captured graphs and device-resident data, made
        # at first use (CohortEngine.fused_train*)
        self._fused_graphs: Dict = {}
        self._resident_stacks = None
        self._resident_eval = None
        self._ckpt_writer: Optional[_CheckpointWriter] = None
        self.restart()

    def _build_params(self, seed: int):
        generator = torch.Generator().manual_seed(seed)
        return model_registry.build_fl_model(self.scenario.model, generator,
                                             self.scenario, self.device)

    # -- state ----------------------------------------------------------

    @property
    def params(self):
        return self.bs.params

    @params.setter
    def params(self, value):
        self.bs.params = value

    @property
    def data_key(self) -> torch.Tensor:
        """Root key of the traced data plane's counter-based batch draws
        (``repro_torch.fl.data.traced_batch_indices``): jax's
        ``PRNGKey(run_seed + 2)``, a (2,) int64 tensor (0, run_seed + 2),
        the reference's ``key_data``. One step past the batch-RNG seed
        (``seed + 1``) and the channel-RNG seed (``seed``), so
        ``reset(seed)`` and resume derive it with no state to save. On
        the CPU: the host packing draws with it there, and the fused
        loop moves it to the device."""
        return threefry.prng_key(self.run_seed + 2, "cpu")

    def restart(self) -> None:
        """Reset the *run* state (round counter, queues, losses, delay) while
        keeping params and RNG streams — what a fresh ``run()`` call does.
        The engine's own run state goes too (:meth:`Engine.reset`)."""
        ncfg = self.net.cfg
        self.t = 0
        self.queues = np.zeros(ncfg.n_gateways)
        self.losses = np.full(ncfg.n_gateways, self.plan.init_loss)
        self.delay_sum = 0.0
        # cumulative padded-vs-real sample counts (the cohort engine fills
        # them)
        self.padding_stats = {"real_samples": 0.0, "padded_samples": 0.0}
        self._policy = None
        self._policy_unresumable = False
        self.engine.reset(self)

    def reset(self, seed: Optional[int] = None) -> "Simulation":
        """Full reset for fair multi-policy sweeps.

        Restores the model parameters, the batch-sampling RNG **and** the
        network channel-state RNG together. With ``seed=None`` this replays
        a fresh ``Simulation(scenario)`` exactly; an explicit ``seed``
        re-seeds params init, batch RNG, channel RNG and the seed threaded
        into stochastic policies, while topology and dataset stay fixed.
        """
        if seed is None or seed == self.scenario.seed:
            self.bs.params = self._init_params
            self.rng.bit_generator.state = self._rng_state0
            self.net.rng.bit_generator.state = self._net_rng_state0
        else:
            _, self.bs.params, _ = self._build_params(seed)
            self.rng = np.random.default_rng(seed + 1)
            self.net.rng = np.random.default_rng(seed)
        self.run_seed = self.scenario.seed if seed is None else seed
        self.restart()
        return self

    # -- the round loop --------------------------------------------------

    def _resolve_policy(self, policy: PolicyLike):
        if policy is None:
            policy = self.scenario.policy
        if isinstance(policy, str):
            return make_policy(policy, seed=self.run_seed,
                               device=self.device)
        return policy

    def _ensure_policy(self, policy: PolicyLike):
        """Resolve/install the active policy (override > restored >
        scenario default), refusing to silently swap out an unresumable
        checkpointed custom policy."""
        if policy is not None:
            self._policy = self._resolve_policy(policy)
            self._policy_unresumable = False
        elif self._policy is None:
            if self._policy_unresumable:
                raise ValueError(
                    "this checkpoint was taken with an unregistered custom "
                    "policy; pass that policy explicitly to rounds()/run() "
                    "to continue")
            self._policy = self._resolve_policy(None)
        return self._policy

    def rounds(self, policy: PolicyLike = None, *,
               boundary: bool = False) -> Iterator[RoundRecord]:
        """Stream one RoundRecord per remaining round.

        ``policy`` (name or instance) overrides the scenario default; when
        resuming from a checkpoint the restored policy is kept unless a new
        one is passed. ``boundary=True`` adds per-device boundary-activation
        RMS telemetry to each record (the cohort engine's one extra forward
        per round; the sequential engine reports none).
        """
        self._ensure_policy(policy)
        while self.t < self.scenario.rounds:
            yield self._step(self._policy, boundary)

    def _step(self, policy, boundary: bool) -> RoundRecord:
        sc = self.scenario
        ncfg = self.net.cfg
        t = self.t
        st = self.net.draw()
        prev_queues = self.queues
        ctx = RoundContext(t, self.workload, self.net, st, self.queues,
                           self.gamma, sc.v, losses=self.losses.copy(),
                           inflight=self.engine.inflight_counts(self))
        dec: RoundDecision = policy.schedule(ctx)
        self.queues = dec.queues

        # resolve the schedule into trained gateways + per-device cuts
        trained, l_n, gw_delay, failures = resolve_decision(
            dec, self.gateways, ncfg.n_devices)

        out = self.engine.run_round(self, dec, trained, l_n, gw_delay,
                                    boundary=boundary)
        # Asynchronous engines report *realized* participation: updates
        # that actually landed at the server this round (late arrivals
        # included, churned ones excluded). When it differs from the
        # schedule, redo Eq. (14) from the pre-decision queues with the
        # realized indicator; when it matches (every synchronous engine,
        # and fault-free async rounds) keep the scheduler's own queues.
        if out.realized is not None and \
                not np.array_equal(out.realized, dec.selected):
            self.queues = update_queues_realized(prev_queues, out.realized,
                                                 self.gamma)
        self.delay_sum += out.delay
        self.t = t + 1

        acc = None
        if (t + 1) % sc.eval_every == 0 or t == sc.rounds - 1:
            acc = self.plan.accuracy(self.params,
                                     self.ds.x_test, self.ds.y_test)
        return RoundRecord(t=t, selected=dec.selected.copy(),
                           trained=trained, l_n=l_n, delay=out.delay,
                           cum_delay=self.delay_sum,
                           queues=self.queues.copy(),
                           losses=self.losses.copy(), failures=failures,
                           boundary_rms=out.boundary_rms, accuracy=acc,
                           aggregations=out.aggregations,
                           staleness_mean=out.staleness_mean,
                           staleness_max=out.staleness_max,
                           stale_discarded=out.stale_discarded,
                           dropped_devices=out.dropped_devices,
                           lost_devices=out.lost_devices,
                           straggler_devices=out.straggler_devices,
                           buffer_fill=out.buffer_fill,
                           inflight=out.inflight)

    def run(self, policy: PolicyLike = None, *,
            boundary: bool = False) -> FLResult:
        """Consume the full round loop into an :class:`FLResult`.

        Restarts the run state (round counter, queues, losses) but keeps the
        current params/RNG streams; call :meth:`reset` first for a
        from-scratch fair run.
        """
        self.restart()
        records = list(self.rounds(policy, boundary=boundary))
        self.flush()     # any per-round save() has fully landed on return
        return self.result_of(records)

    def result_of(self, records: List[RoundRecord]) -> FLResult:
        """Fold a list of streamed RoundRecords into an :class:`FLResult`."""
        acc = [r.accuracy for r in records if r.accuracy is not None]
        acc_rounds = [r.t + 1 for r in records if r.accuracy is not None]
        return FLResult(
            accuracy=acc, acc_rounds=acc_rounds,
            cum_delay=[r.cum_delay for r in records],
            participation=np.asarray([r.selected for r in records]),
            gamma_targets=self.gamma,
            losses=[float(np.mean(r.losses)) for r in records],
            phi=self.phi,
            failures=sum(r.failures for r in records))

    # -- statistics ------------------------------------------------------

    def estimate_stats(self, params=None,
                       engine: Optional[str] = None) -> DataStats:
        """Online estimators for sigma_n, delta_n, L_n (paper Sec. VII-A),
        by ``engine``'s estimator (default: this simulation's engine)."""
        eng = self.engine if engine is None else make_engine(engine)
        return eng.estimate_stats(
            self, self.params if params is None else params)

    # -- checkpointing ---------------------------------------------------

    def save(self, path, keep_last: Optional[int] = None, *,
             block: bool = False) -> pathlib.Path:
        """Checkpoint params + full run state at round ``self.t``, in the
        reference's format (params in its layout, ``convert``), so either
        package resumes the other's checkpoints.

        Non-blocking by default: the run state is snapshotted on the
        calling thread (one host copy of the params, the RNG states,
        queues, losses, statistics and policy state, encoded), then one
        background writer thread writes the files, each through tmp +
        ``os.replace``. The returned path may not exist yet: call
        :meth:`flush` before reading it (or pass ``block=True``).

        ``keep_last`` (default: ``Scenario.keep_last``) rotates the
        directory: after this save only the newest ``keep_last`` round
        checkpoints survive — ``step_*`` param files, their ``sim_*.json``
        manifests and any ``engine_*`` side-cars alike.

        Under the sharded engine every rank holds the same state and only
        the mesh's first rank writes; ``flush`` (and a blocking save) then
        waits for every rank, so all of them can ``resume`` the directory.
        """
        if keep_last is None:
            keep_last = self.scenario.keep_last
        path = pathlib.Path(path)
        step = self.t
        fname = path / f"sim_{step:08d}.json"
        if not self.engine.writes_checkpoints(self):
            if block:
                self.flush()
                self.engine.sync(self)
            return fname
        params = params_to_numpy(self.plan, self.params)   # host copies
        pol = None
        if self._policy is not None:
            name = getattr(self._policy, "name", None)
            # only registered names can be rebuilt at resume time; a custom
            # instance is recorded as such, so resume can refuse to swap in
            # the scenario default silently
            pol = {"name": name if name in POLICIES else None,
                   "state": policy_state(self._policy)}
        eng = self.engine.state_dict(self)
        eng_meta, eng_arrays = eng if eng is not None else (None, None)
        state = {
            "scenario": self.scenario.to_json(),
            "t": step,
            "run_seed": self.run_seed,
            "queues": self.queues.tolist(),
            "losses": self.losses.tolist(),
            "delay_sum": self.delay_sum,
            "rng": self.rng.bit_generator.state,
            "net_rng": self.net.rng.bit_generator.state,
            # stats with exact dtypes: phi/gamma recomputed at resume are
            # then bit-identical, and the estimation pass is skipped
            "stats": {f.name: _arr_to_json(getattr(self.stats, f.name))
                      for f in dataclasses.fields(self.stats)},
            "policy": pol,
            "engine": eng_meta,
        }
        payload = json.dumps(state).encode()       # serialized pre-submit

        def job():
            store.save_pytree(path, params, step=step, keep_last=keep_last)
            if eng_arrays is not None:
                store.save_pytree(path, eng_arrays, step=step,
                                  prefix="engine")
            store.atomic_write_bytes(fname, lambda f: f.write(payload))
            if keep_last is not None:
                kept = set(store.all_steps(path))  # post-GC param ckpts
                for fam in ("sim", "engine"):
                    for f in path.glob(f"{fam}_*.*"):
                        m = re.match(rf"{fam}_(\d+)\.(json|npz)", f.name)
                        if m and int(m.group(1)) not in kept:
                            f.unlink(missing_ok=True)

        if block:
            self.flush()      # keep FIFO order with pending async saves
            job()
            self.engine.sync(self)
        else:
            if self._ckpt_writer is None:
                self._ckpt_writer = _CheckpointWriter()
            self._ckpt_writer.submit(job)
        return fname

    def flush(self) -> None:
        """Block until every pending non-blocking :meth:`save` has fully
        landed on disk; re-raises the first error any background write hit.
        A no-op when nothing is pending, but for the sharded engine's wait
        for every rank (:meth:`Engine.sync`)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.flush()
        self.engine.sync(self)

    @classmethod
    def resume(cls, path, *, device="cuda") -> "Simulation":
        """Rebuild a Simulation on ``device`` from the latest checkpoint in
        ``path`` (written by this package or by the reference).

        The scenario is re-resolved deterministically (topology, dataset;
        the per-device statistics come from the manifest, skipping the
        estimation pass), then params and every RNG/queue/loss/policy
        stream are restored, so the continued round loop is bit-identical
        to an uninterrupted run.
        """
        path = pathlib.Path(path)
        step = store.latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        state = json.loads((path / f"sim_{step:08d}.json").read_text())
        stats = None
        if "stats" in state:
            stats = DataStats(**{k: _arr_from_json(v)
                                 for k, v in state["stats"].items()})
        sim = cls(Scenario.from_json(state["scenario"]), _stats=stats,
                  device=device)
        saved = store.load_pytree(path / f"step_{step:08d}.npz",
                                  like=params_to_numpy(sim.plan, sim.params))
        sim.params = params_from_numpy(sim.plan, saved, sim.device)
        sim.t = state["t"]
        sim.run_seed = state.get("run_seed", sim.scenario.seed)
        sim.queues = np.asarray(state["queues"])
        sim.losses = np.asarray(state["losses"])
        sim.delay_sum = state["delay_sum"]
        sim.rng.bit_generator.state = state["rng"]
        sim.net.rng.bit_generator.state = state["net_rng"]
        pol = state.get("policy")
        if pol:
            if pol.get("name"):
                sim._policy = make_policy(pol["name"], seed=sim.run_seed,
                                          device=sim.device)
                set_policy_state(sim._policy, pol.get("state"))
            else:
                sim._policy_unresumable = True
        eng_meta = state.get("engine")
        if eng_meta is not None:
            sim.engine.load_state_dict(sim, eng_meta, path, step)
        return sim

    # -- scheduling sweeps ----------------------------------------------

    def sweep(self, v_values, seeds=None, *, rounds: Optional[int] = None,
              policies=None):
        """Run a scheduling sweep on the simulation's device.

        Draws each seed's channel trajectory on the host under the
        ``reset(seed)`` fairness contract (so sweep lane (s, v) sees
        exactly the ChannelStates a stepwise ``reset(s)`` run at that V
        would), stacks them, and runs the grid as batched decide rounds:
        with ``policies=None`` the scenario policy's (``ddsra_jax``)
        ``DDSRAPlan.sweep_states`` over seeds x V lanes; with
        ``policies=[...]`` (traced-decide policy names) the policies x
        seeds x V grid of ``repro_torch.core.policy_sweep`` (the Figs. 4-6
        comparison). Leaves ``net.rng`` untouched. Returns a
        ``repro_torch.fl.fused_sim.SweepResult``.
        """
        return fused_sim.sweep(self, v_values, seeds=seeds, rounds=rounds,
                               policies=policies)

    # -- the fused round loop (repro_torch.fl.fused_sim) ------------------

    def fused_rounds(self, policy: PolicyLike = None, *,
                     rounds: Optional[int] = None) -> List[RoundRecord]:
        """Run the remaining rounds (at most ``rounds`` of them) through
        the fused loop instead of the stepwise one: the decide trajectory
        in one pass (batched on the device for traced policies, the host
        loop for the rest), then every training round as one replay of a
        captured CUDA graph, nothing read on the host until the block
        ends. The same :class:`RoundRecord` stream and end state as
        ``rounds()`` (queues and both RNG streams bit-identical, params to
        1e-5), so fused and stepwise blocks interleave and a checkpoint
        taken after a fused block resumes into either; ``eval_every``
        accuracies are evaluated inside the block."""
        return fused_sim.fused_rounds(self, self._ensure_policy(policy),
                                      rounds=rounds)

    def run_fused(self, policy: PolicyLike = None) -> FLResult:
        """:meth:`run`, but through :meth:`fused_rounds`: restart the run
        state, run every round fused, fold the records into an
        :class:`FLResult`."""
        self.restart()
        records = self.fused_rounds(policy)
        self.flush()
        return self.result_of(records)


def _arr_to_json(a: np.ndarray) -> dict:
    a = np.asarray(a)
    return {"data": a.tolist(), "dtype": str(a.dtype)}


def _arr_from_json(d: dict) -> np.ndarray:
    return np.asarray(d["data"], dtype=d["dtype"])


def _unflatten_like(flat: torch.Tensor, params) -> List[torch.Tensor]:
    """Split a flat vector back into views shaped like ``params``'s leaves
    (``split.leaves`` order)."""
    out, i = [], 0
    for leaf in split_lib.leaves(params):
        out.append(flat[i:i + leaf.numel()].view(leaf.shape))
        i += leaf.numel()
    return out


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")

