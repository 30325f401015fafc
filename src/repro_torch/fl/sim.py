"""Composable FL simulation API: Scenario / Policy / Engine (port of
``repro.fl.sim``).

* **Scenario** — a frozen, JSON-serializable spec of everything that defines
  an experiment: network config, data distribution, model (resolved through
  ``repro_torch.models.registry.build_fl_model``), local-training
  hyperparameters and the default policy/engine names. The same fields as
  the reference's, so a scenario round-trips between the two packages.
* **Policy** — any object with ``schedule(ctx) -> RoundDecision``; named
  policies come from the registry in ``repro_torch.core.schedulers``.
* **Engine** — how a scheduled round is executed: this slice has the
  stepwise ``CohortEngine`` (``repro_torch.fl.cohort``).

On top sits :class:`Simulation`: a streaming ``rounds()`` generator yielding
one :class:`RoundRecord` per round, ``run()`` returning the classic
:class:`FLResult`, and ``reset(seed)`` restoring params, batch RNG **and**
network channel-state RNG together. The control plane (network draws,
DDSRA, queues) is the reference's numpy, drawn from the same generators in
the same order, so decisions, queues and delays are bit-identical to
``repro``'s for the same statistics; the data plane runs in PyTorch on
``device`` (``"cuda"`` unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.core import costmodel as cm
from repro_torch.core.ddsra import RoundDecision, Workload
from repro_torch.core.network import Network, NetworkConfig
from repro_torch.core.participation import (DataStats, divergence_bound,
                                            participation_rates)
from repro_torch.core.schedulers import RoundContext, make_policy
from repro_torch.device import resolve_device, use_f32_numerics
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl.data import (CohortLayout, make_fl_dataset,
                                 make_token_fl_dataset, sample_cohort_batch)
from repro_torch.fl.roles import BaseStation, Device, Gateway
from repro_torch.models import registry as model_registry
from repro_torch.models.convert import params_from_numpy


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Frozen, JSON-serializable spec of one FL experiment.

    The reference's fields and defaults. This slice runs ``engine="cohort"``
    with ``dtype="f32"`` and ``data_plane="host"``; the fault axes and
    ``buffer_k`` belong to the async engine, which is not ported yet.
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
    dtype: str = "f32"                 # data-plane dtype: "f32" ("bf16" later)
    data_plane: str = "host"           # "host" ("traced" later)
    # model-upload compression: bits per parameter priced into the DDSRA
    # upload-delay/energy terms (None = the model's native precision)
    upload_bits: Optional[float] = None
    churn: float = 0.0
    dropout: float = 0.0
    straggler_frac: float = 0.0
    straggler_scale: float = 0.0
    buffer_k: Optional[int] = None
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


def make_engine(name: str) -> "Engine":
    """Instantiate a registered engine by name (see ``ENGINES``)."""
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}: "
                         f"expected one of {sorted(ENGINES)}")
    return ENGINES[name]()


@dataclasses.dataclass
class RoundOutcome:
    """What actually happened when an engine executed a scheduled round.

    A synchronous engine realizes exactly what was scheduled, so the
    policy's own queue update stands.
    """
    delay: float                       # realized time advanced this round
    aggregations: int = 0


class Engine:
    """Protocol: how a scheduled round is executed on the model."""
    name: str

    def estimate_stats(self, sim: "Simulation", params) -> DataStats:
        """Estimate the per-device sigma_n/delta_n/L_n statistics the
        divergence bound (paper Sec. VII-A) needs."""
        raise NotImplementedError

    def train_round(self, sim: "Simulation", trained: List[int],
                    l_n: np.ndarray) -> None:
        """Train one round in-place on ``sim`` (params + per-gateway
        losses)."""
        raise NotImplementedError

    def run_round(self, sim: "Simulation", dec: RoundDecision,
                  trained: List[int], l_n: np.ndarray,
                  gw_delay: Dict[int, float]) -> RoundOutcome:
        """Execute one scheduled round: train the scheduled cohort and
        realize exactly the scheduled delays (the FedAvg barrier waits for
        the slowest gateway, ``max`` over ``gw_delay``)."""
        self.train_round(sim, trained, l_n)
        return RoundOutcome(delay=max(gw_delay.values(), default=0.0),
                            aggregations=1 if trained else 0)


@register_engine("cohort")
class CohortEngine(Engine):
    """One slot-batched round per FL round (see ``repro_torch.fl.cohort``).

    Participants are packed into a fixed tier-major slot layout
    (``repro_torch.fl.data.CohortLayout``; ``Scenario.tiers`` sets how many
    distinct slot widths are used).
    """

    def _layout(self, sim: "Simulation", capacity: int) -> CohortLayout:
        """The (cached) fixed slot layout for ``capacity``-slot rounds."""
        key = (capacity, sim.scenario.tiers)
        if key not in sim._layouts:
            sim._layouts[key] = CohortLayout.build(
                sim.d_tilde, capacity, sim.scenario.tiers)
        return sim._layouts[key]

    def estimate_stats(self, sim: "Simulation", params) -> DataStats:
        """sigma/delta/Lipschitz for every device in one slot-batched pass."""
        sc = sim.scenario
        n_dev = sim.net.cfg.n_devices
        batch = sample_cohort_batch(sim.rng, sim.ds, range(n_dev),
                                    sim.d_tilde, int(sim.d_tilde.max()))
        mix = sim.d_sizes / sim.d_sizes.sum()
        sigma, delta, lips = cohort_lib.cohort_stats(
            sim.plan, params, batch, mix, sc.lr, sc.sigma_samples,
            device=sim.device)
        sigma, delta, lips = (t.cpu().numpy() for t in (sigma, delta, lips))
        return DataStats(sigma, delta, np.maximum(lips, 0.1),
                         sim.d_tilde.astype(float))

    def _pack_round(self, sim: "Simulation", trained: List[int],
                    l_n: np.ndarray):
        """Pack the scheduled devices into the fixed slot layout.

        Draws come from ``sim.rng`` in gateway-major device order, as the
        reference's packing makes them. Returns (batch, l_slot, w_slot,
        slot_gw).
        """
        device_ids: List[int] = []
        for m in trained:
            device_ids.extend(dev.idx for dev in sim.gateways[m].devices)
        cap = sim.cohort_capacity if len(device_ids) <= sim.cohort_capacity \
            else sim.net.cfg.n_devices
        layout = self._layout(sim, cap)
        batch = sample_cohort_batch(sim.rng, sim.ds, device_ids, sim.d_tilde,
                                    layout=layout)
        n_slots = layout.n_slots
        l_slot = np.zeros(n_slots, int)
        w_slot = np.zeros(n_slots, np.float32)
        slot_gw = np.zeros((n_slots, sim.net.cfg.n_gateways), np.float32)
        for di, n in enumerate(device_ids):
            s = int(batch.slot_of[di])
            l_slot[s] = l_n[n]
            w_slot[s] = sim.d_tilde[n]
            slot_gw[s, sim.net.assign[n]] = 1.0
        return batch, l_slot, w_slot, slot_gw

    def train_round(self, sim: "Simulation", trained: List[int],
                    l_n: np.ndarray) -> None:
        """Pack the scheduled devices and run the cohort round in place on
        ``sim``."""
        if not trained:
            return
        sc = sim.scenario
        batch, l_slot, w_slot, slot_gw = self._pack_round(sim, trained, l_n)
        new_global, gw_loss, _, _, _ = cohort_lib.cohort_round(
            sim.plan, sim.params, batch, l_slot, w_slot, slot_gw,
            sc.k_iters, sc.lr, device=sim.device)
        sim.params = new_global
        gw_loss = gw_loss.cpu().numpy()
        for m in trained:
            sim.losses[m] = float(gw_loss[m])


# ---------------------------------------------------------------------------
# Simulation
# ---------------------------------------------------------------------------

PolicyLike = Union[str, object, None]


class Simulation:
    """Composable FL simulation over a :class:`Scenario`.

    State is resolved once at construction (topology, dataset, model, layer
    cost model, per-device statistics); ``rounds()`` then streams
    :class:`RoundRecord` telemetry one round at a time.

    ``device``: where the data plane runs (``"cuda"`` unless the caller
    passes ``"cpu"``). ``init_params``: numpy params in the reference's
    layout (``jax.tree.map(np.asarray, params)``) to start from instead of
    the port's own seeded init — the port cannot replay ``jax.random``.
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
        if sc.dtype not in ("f32", "bf16"):
            raise ValueError(f"Scenario.dtype={sc.dtype!r}: expected 'f32' "
                             "or 'bf16'")
        if sc.dtype not in cohort_lib.COMPUTE_DTYPES:
            raise NotImplementedError(f"Scenario.dtype={sc.dtype!r}")
        if sc.data_plane not in ("host", "traced"):
            raise ValueError(
                f"Scenario.data_plane={sc.data_plane!r}: expected 'host' "
                "or 'traced'")
        if sc.data_plane == "traced":
            raise NotImplementedError("Scenario.data_plane='traced'")
        if (sc.churn or sc.dropout or sc.straggler_frac
                or sc.buffer_k is not None):
            raise ValueError(
                f"engine {sc.engine!r} is synchronous: it cannot honor "
                "fault axes (churn/dropout/stragglers) or buffer_k")
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
        self._layouts: Dict = {}      # (capacity, tiers) -> layout

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

    def restart(self) -> None:
        """Reset the *run* state (round counter, queues, losses, delay) while
        keeping params and RNG streams — what a fresh ``run()`` call does."""
        ncfg = self.net.cfg
        self.t = 0
        self.queues = np.zeros(ncfg.n_gateways)
        self.losses = np.full(ncfg.n_gateways, self.plan.init_loss)
        self.delay_sum = 0.0
        self._policy = None

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

    def _ensure_policy(self, policy: PolicyLike):
        """Resolve/install the active policy (override > scenario default)."""
        if policy is not None or self._policy is None:
            policy = self.scenario.policy if policy is None else policy
            self._policy = make_policy(policy, seed=self.run_seed) \
                if isinstance(policy, str) else policy
        return self._policy

    def rounds(self, policy: PolicyLike = None, *,
               boundary: bool = False) -> Iterator[RoundRecord]:
        """Stream one RoundRecord per remaining round. ``policy`` (name or
        instance) overrides the scenario default."""
        if boundary:
            raise NotImplementedError("boundary-activation telemetry")
        self._ensure_policy(policy)
        while self.t < self.scenario.rounds:
            yield self._step(self._policy)

    def _step(self, policy) -> RoundRecord:
        sc = self.scenario
        ncfg = self.net.cfg
        t = self.t
        st = self.net.draw()
        ctx = RoundContext(t, self.workload, self.net, st, self.queues,
                           self.gamma, sc.v, losses=self.losses.copy())
        dec: RoundDecision = policy.schedule(ctx)
        self.queues = dec.queues

        # resolve the schedule into trained gateways + per-device cuts
        trained, l_n, gw_delay, failures = resolve_decision(
            dec, self.gateways, ncfg.n_devices)

        out = self.engine.run_round(self, dec, trained, l_n, gw_delay)
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
                           accuracy=acc, aggregations=out.aggregations)

    def run(self, policy: PolicyLike = None) -> FLResult:
        """Consume the full round loop into an :class:`FLResult`.

        Restarts the run state (round counter, queues, losses) but keeps the
        current params/RNG streams; call :meth:`reset` first for a
        from-scratch fair run.
        """
        self.restart()
        return self.result_of(list(self.rounds(policy)))

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

    def estimate_stats(self, params=None) -> DataStats:
        """Online estimators for sigma_n, delta_n, L_n (paper Sec. VII-A)."""
        return self.engine.estimate_stats(
            self, self.params if params is None else params)
