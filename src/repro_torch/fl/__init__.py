"""Two-tier split federated learning: data pipeline, engines, simulation
(the port of ``repro.fl``, with its public names).

* :class:`Scenario` / :class:`Simulation` — the composable simulation API
  (``repro_torch.fl.sim``).
* Engines — ``CohortEngine`` (one slot-batched round),
  ``ShardedCohortEngine`` (the same round with its slots split over the
  ranks of a ``torch.distributed`` process group, ``repro_torch.fl.shard``),
  ``AsyncCohortEngine`` (buffered asynchronous aggregation over the same
  round, ``repro_torch.fl.async_engine``), ``SequentialEngine`` (the
  per-device loop). Importing this package registers all four.
* Fault axes — ``FaultModel`` / ``draw_round_faults``
  (``repro_torch.fl.faults``).
* Fused simulation loop — ``RoundTelemetry`` / ``SweepResult``
  (``repro_torch.fl.fused_sim``) behind ``Simulation.fused_rounds()`` /
  ``Simulation.sweep()``.
* Packing contract — ``sample_cohort_batch`` + ``CohortLayout`` /
  ``TieredCohortBatch`` in ``repro_torch.fl.data``.
* ``FLTrainer`` / ``FLConfig`` — deprecated shim over ``Simulation``.
"""
from repro_torch.fl.data import (CohortBatch, CohortLayout, FLDataset,
                                 TieredCohortBatch, make_fl_dataset,
                                 sample_batch, sample_cohort_batch)
from repro_torch.fl.faults import FaultModel, RoundFaults, draw_round_faults
from repro_torch.fl.sim import (ENGINES, CohortEngine, Engine, FLResult,
                                RoundRecord, Scenario, SequentialEngine,
                                Simulation, make_engine, register_engine)
from repro_torch.fl.async_engine import AsyncCohortEngine
from repro_torch.fl.fused_sim import RoundTelemetry, SweepResult
from repro_torch.fl.shard import ShardedCohortEngine
from repro_torch.fl.trainer import FLConfig, FLTrainer

__all__ = ["CohortBatch", "CohortLayout", "TieredCohortBatch", "FLDataset",
           "make_fl_dataset", "sample_batch", "sample_cohort_batch",
           "FLConfig", "FLResult", "FLTrainer", "Scenario", "Simulation",
           "RoundRecord", "Engine", "CohortEngine", "SequentialEngine",
           "ShardedCohortEngine", "AsyncCohortEngine", "FaultModel",
           "RoundFaults", "draw_round_faults", "RoundTelemetry",
           "SweepResult", "ENGINES", "make_engine", "register_engine"]
