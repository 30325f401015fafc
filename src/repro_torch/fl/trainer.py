"""Deprecated FLTrainer/FLConfig shim over ``repro_torch.fl.sim`` (port of
``repro.fl.trainer``).

Keeps the historical ``FLTrainer(FLConfig(...)).run()`` entry point working
by delegating every attribute to an underlying
:class:`repro_torch.fl.sim.Simulation`, so call sites that poke trainer
internals like ``tr.bs.params = ...`` or ``tr.rng = ...`` behave as before.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.network import NetworkConfig
from repro_torch.fl.sim import FLResult, Scenario, Simulation, make_engine

__all__ = ["FLConfig", "FLResult", "FLTrainer"]


@dataclasses.dataclass
class FLConfig:
    """Deprecated: use ``repro_torch.fl.sim.Scenario`` (same fields, plus
    the network config embedded as ``net`` and ``scheduler`` renamed
    ``policy``)."""
    model: str = "vgg"            # repro_torch.models.registry key
    width_mult: float = 0.25
    classes: int = 10
    k_iters: int = 5              # local epochs K
    lr: float = 0.01              # step size beta
    alpha: float = 0.05           # training data sampling ratio
    rounds: int = 50
    v: float = 0.01               # Lyapunov control parameter
    scheduler: str = "ddsra"
    seed: int = 0
    eval_every: int = 5
    max_dataset: int = 2000
    chi: float = 1.0              # non-IID degree
    sigma_samples: int = 8        # per-sample grads for sigma estimation
    engine: str = "cohort"        # cohort (slot-batched) | sequential
    boundary_telemetry: bool = False  # per-device boundary-activation RMS

    def to_scenario(self, net_cfg: Optional[NetworkConfig] = None) -> Scenario:
        """Translate this legacy config into the equivalent Scenario."""
        return Scenario(
            model=self.model, width_mult=self.width_mult,
            classes=self.classes, k_iters=self.k_iters, lr=self.lr,
            alpha=self.alpha, rounds=self.rounds, v=self.v,
            policy=self.scheduler, seed=self.seed,
            eval_every=self.eval_every, max_dataset=self.max_dataset,
            chi=self.chi, sigma_samples=self.sigma_samples,
            engine=self.engine, net=net_cfg or NetworkConfig())


class FLTrainer:
    """Deprecated facade over :class:`repro_torch.fl.sim.Simulation`, on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg: FLConfig, net_cfg: Optional[NetworkConfig] = None,
                 *, device="cuda"):
        self.cfg = cfg
        self.sim = Simulation(cfg.to_scenario(net_cfg), device=device)
        self.last_boundary_rms: Optional[np.ndarray] = None

    # every piece of historical trainer state delegates to the Simulation,
    # so external mutation (tr.rng = ..., tr.bs.params = ...) stays visible
    # to the round loop.
    _DELEGATED = ("net", "rng", "ds", "d_sizes", "d_tilde", "plan", "layers",
                  "bs", "workload", "gateways", "cohort_capacity", "stats",
                  "stats_seconds", "phi", "gamma")

    def __getattr__(self, name):
        if name in FLTrainer._DELEGATED:
            return getattr(self.sim, name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in FLTrainer._DELEGATED:
            setattr(self.sim, name, value)
        else:
            object.__setattr__(self, name, value)

    def estimate_stats(self, params, engine: Optional[str] = None):
        """Deprecated alias for ``Simulation.estimate_stats``."""
        return self.sim.estimate_stats(params, engine=engine)

    def run(self, scheduler_name: Optional[str] = None,
            engine: Optional[str] = None) -> FLResult:
        """Deprecated alias for ``Simulation.run`` (plus the historical
        ``boundary_telemetry`` / per-call ``engine`` override semantics)."""
        old_engine = self.sim.engine
        if engine is not None:
            self.sim.engine = make_engine(engine)
        try:
            if not self.cfg.boundary_telemetry:
                return self.sim.run(scheduler_name)
            self.sim.restart()
            records: List = []
            for rec in self.sim.rounds(scheduler_name, boundary=True):
                records.append(rec)
                if rec.boundary_rms is not None:
                    self.last_boundary_rms = rec.boundary_rms
            return self.sim.result_of(records)
        finally:
            self.sim.engine = old_engine
