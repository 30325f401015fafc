"""Sharded cohort engine (port of ``repro.fl.shard``): the cohort round
with its slots split over the ranks of a ``torch.distributed`` process
group, the cohort mesh of ``repro_torch.sharding``.

The reference maps the fused round over a 1-D ``"cohort"`` device mesh
with ``jax.shard_map`` from one controller. Here every rank is a process
running the same :class:`~repro_torch.fl.sim.Simulation` (see
``repro_torch.sharding`` for why):

* **the control plane is replicated by construction** — every rank draws
  the same numpy streams in the same order, so decisions, queues and the
  packed batches agree on every rank with no exchange;
* **device slots are split** — tier k's ``S_k`` slots (a mesh multiple:
  the engine's ``CohortLayout`` carries its shard count) split into
  contiguous blocks, rank r training slots ``[r S_k / n, (r + 1) S_k /
  n)``, the split ``SLOT_SPEC`` makes under ``shard_map``; a rank uploads
  only its own slots;
* **model parameters are replicated** — each rank trains its slots from
  the global model exactly as the single-device round does
  (``repro_torch.fl.cohort.local_partials``);
* **two-tier FedAvg is one ``all_reduce``** — each rank reduces its slots
  to masked partial sums (every leaf's weighted sum, the weight total, the
  per-gateway counts and loss sums, and with the gateway models their
  numerators and denominators) packed in one flat buffer; one ``all_reduce``
  (sum) a round completes them, and every rank divides
  (``cohort.fedavg_finish``). Per-slot outputs (losses, boundary RMS)
  ride in the same buffer: each rank writes its block into zeros, so the
  sum is every block in place.

The statistics pass splits the same way: only the global mixed gradient
(for delta_n) crosses ranks, in one ``all_reduce``, and sigma_n, delta_n
and L_n come back whole in a second. The fused loop
(``repro_torch.fl.fused_sim``) splits each round at its reduction: a
captured half that trains the rank's slots up to their sums, the eager
``all_reduce``, and a captured half that finishes the round
(``cohort.train_scan``'s ``reduce``); a CUDA graph cannot hold a gloo
collective, so one design serves NCCL and gloo.

Numerically the sharded round equals the single-device round up to the
order its sums are added in (held at 1e-5 against the reference's sharded
engine in ``tests/test_torch_shard.py``, at 1, 2 and 3 ranks). With no
process group the mesh has one rank, every reduction is the identity and
the engine is the cohort engine.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fl import cohort as cohort_lib
from repro_torch.fl import sim as sim_lib
from repro_torch.fl.data import TieredCohortBatch
from repro_torch.models.split_model import Params, SplitModel
from repro_torch.sharding import CohortMesh, cohort_mesh


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad the leading axis of ``a`` up to ``rows``."""
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


def _mine(mesh: CohortMesh, a, rows: int, device, dtype=None):
    """This rank's block of ``a`` zero-padded to ``rows``, on ``device``."""
    a = _pad_rows(np.asarray(a, dtype), rows)
    return torch.as_tensor(np.ascontiguousarray(a[mesh.block(rows)]),
                           device=device)


def _fedavg_allreduce(mesh: CohortMesh, sums: torch.Tensor,
                      slot_values: Sequence[torch.Tensor],
                      index: torch.Tensor, n_slots: int):
    """The round's one collective: this rank's FedAvg sums
    (``cohort.fedavg_partials``) and each per-slot vector of
    ``slot_values`` written at the rank's slot positions ``index`` of a
    zeroed ``n_slots`` vector, packed in one buffer and summed over the
    mesh. Returns (the summed FedAvg sums, every slot value vector
    whole)."""
    k = sums.numel()
    buf = torch.zeros(k + n_slots * len(slot_values), dtype=sums.dtype,
                      device=sums.device)
    buf[:k] = sums
    for i, v in enumerate(slot_values):
        buf[k + i * n_slots:k + (i + 1) * n_slots].index_copy_(0, index, v)
    mesh.all_reduce(buf)
    return buf[:k], [buf[k + i * n_slots:k + (i + 1) * n_slots]
                     for i in range(len(slot_values))]


def sharded_cohort_round(mesh: CohortMesh, model: SplitModel,
                         params: Params, batch, l_slot, w_slot, gw_onehot,
                         k_iters: int, lr, with_boundary: bool = True,
                         with_gateway_models: bool = False,
                         compute_dtype: str = "f32", device="cuda") -> Tuple:
    """One FL round with its slots split over ``mesh``.

    The contract and return convention of
    ``repro_torch.fl.cohort.cohort_round`` (a 5-tuple, or a 6-tuple with
    the gateway models when ``with_gateway_models`` is set); ``batch`` a
    ``CohortBatch`` or a ``TieredCohortBatch``, the same on every rank.
    Tiers whose slot count the mesh size does not divide are zero-padded
    (empty slots are masked out of every sum) and the per-slot outputs
    trimmed back, so any layout runs on any mesh. Every rank returns the
    same tensors, on ``device``.
    """
    cohort_lib._check_dtype(compute_dtype)
    device = resolve_device(device)
    tiers = batch.tiers if isinstance(batch, TieredCohortBatch) else (batch,)
    sizes = tuple(t.x.shape[0] for t in tiers)
    padded = tuple(-(-s // mesh.size) * mesh.size for s in sizes)
    l_slot = np.asarray(l_slot)
    if with_boundary and ((l_slot < 0) | (l_slot > model.n_blocks)).any():
        raise ValueError(f"partition points {l_slot.tolist()} outside "
                         f"[0, {model.n_blocks}]")

    def mine(arrs, dtype=None):
        return tuple(_mine(mesh, a, p, device, dtype)
                     for a, p in zip(arrs, padded))

    def per_slot(v, dtype):
        return torch.cat(mine(cohort_lib._split_tiers(np.asarray(v), sizes),
                              dtype))

    params = cohort_lib._on(params, device)
    sums, losses, boundary = cohort_lib.local_partials(
        model, params, mine([t.x for t in tiers]), mine([t.y for t in tiers]),
        mine([t.mask for t in tiers], np.float32), per_slot(l_slot, np.int64),
        per_slot(w_slot, np.float32), per_slot(gw_onehot, np.float32), lr,
        k_iters=k_iters, with_boundary=with_boundary,
        with_gateway_models=with_gateway_models, compute_dtype=compute_dtype)

    offsets = np.cumsum((0,) + padded[:-1])
    index = torch.cat([torch.arange(o + mesh.block(p).start,
                                    o + mesh.block(p).stop, device=device)
                       for o, p in zip(offsets, padded)])
    total, slot_out = _fedavg_allreduce(
        mesh, sums, (losses, boundary) if with_boundary else (losses,),
        index, int(sum(padded)))
    new_global, gw_loss, gw_count, _, gw_models = cohort_lib.fedavg_finish(
        total, params, cohort_lib._shapes(params), np.shape(gw_onehot)[1],
        with_gateway_models)

    def trim(v):    # the per-tier padding back off a per-slot vector
        return torch.cat([v[o:o + s] for o, s in zip(offsets, sizes)])
    dev_losses = trim(slot_out[0])
    boundary = trim(slot_out[1]) if with_boundary \
        else torch.zeros_like(dev_losses)
    out = (new_global, gw_loss, gw_count, dev_losses, boundary)
    return (*out, gw_models) if with_gateway_models else out


def sharded_cohort_stats(mesh: CohortMesh, model: SplitModel,
                         params: Params, batch, mix_weights, lr,
                         sigma_samples: int, device="cuda"):
    """sigma/delta/Lipschitz for every device, its rows split over
    ``mesh``. Mirrors ``repro_torch.fl.cohort.cohort_stats``: ``batch``
    uses the all-devices layout (row n = device n); rows are zero-padded to
    a mesh multiple and the padding trimmed from the outputs. Two
    ``all_reduce`` calls: the global gradient, then the three statistics
    whole. Returns three (N,) float32 tensors, the same on every rank."""
    device = resolve_device(device)
    n_dev = batch.x.shape[0]
    rows = -(-n_dev // mesh.size) * mesh.size
    grads, sigma, lips, global_g = cohort_lib.stats_partials(
        model, cohort_lib._on(params, device),
        _mine(mesh, batch.x, rows, device), _mine(mesh, batch.y, rows, device),
        _mine(mesh, batch.mask, rows, device, np.float32),
        _mine(mesh, mix_weights, rows, device, np.float32), lr, sigma_samples)
    delta = cohort_lib.stats_delta(grads, mesh.all_reduce(global_g))
    whole = torch.zeros((3, rows), dtype=torch.float32, device=device)
    whole[:, mesh.block(rows)] = torch.stack([sigma, delta, lips])
    sigma, delta, lips = mesh.all_reduce(whole)[:, :n_dev]
    return sigma, delta, lips


@sim_lib.register_engine("sharded")
class ShardedCohortEngine(sim_lib.CohortEngine):
    """Cohort engine sharded over the ranks of a cohort mesh
    (``repro_torch.sharding.cohort_mesh(Scenario.mesh_shape)``).

    The cohort engine's packing and telemetry, unchanged; its hooks run
    the round and the statistics pass with the slots split over the mesh
    and the FedAvg reduced by ``all_reduce`` (see the module docstring).
    ``fused_train`` and ``fused_train_traced`` are the cohort engine's:
    they take the rank's slots (:meth:`_slot_blocks`) and the reduction
    (:meth:`_reduce`) from the hooks. Every rank of the mesh runs the same
    Simulation; with no process group the mesh has one rank and the
    numerics are the cohort engine's. Checkpoints are written by the
    mesh's first rank, and every rank waits for them
    (:meth:`writes_checkpoints`, :meth:`sync`).
    """

    def _mesh(self, sim: "sim_lib.Simulation") -> CohortMesh:
        """The cohort mesh the scenario asks for (its group is built once:
        ``cohort_mesh`` keeps it); a rank outside it raises
        ``ValueError`` here, at the engine's first use."""
        return cohort_mesh(sim.scenario.mesh_shape)

    def _shard_count(self, sim: "sim_lib.Simulation") -> int:
        """Tier slot counts must divide into the mesh size."""
        return self._mesh(sim).size

    def _fused_round(self, sim: "sim_lib.Simulation", params, batch, l_slot,
                     w_slot, gw_slot, *, with_boundary: bool,
                     with_gateway_models: bool):
        """The round with its slots split over the mesh."""
        sc = sim.scenario
        out = sharded_cohort_round(
            self._mesh(sim), sim.plan, params, batch, l_slot, w_slot,
            gw_slot, sc.k_iters, sc.lr, with_boundary=with_boundary,
            with_gateway_models=with_gateway_models, compute_dtype=sc.dtype,
            device=sim.device)
        return out if with_gateway_models else (*out, None)

    def _fused_stats(self, sim: "sim_lib.Simulation", params, batch, mix):
        """The sigma/delta/L_n pass with its rows split over the mesh (the
        same rng draws and DataStats post-processing as the cohort
        engine's, so the engines stay swappable)."""
        sc = sim.scenario
        return sharded_cohort_stats(self._mesh(sim), sim.plan, params, batch,
                                    mix, sc.lr, sc.sigma_samples,
                                    device=sim.device)

    def _slot_blocks(self, sim: "sim_lib.Simulation",
                     sizes) -> Tuple[slice, ...]:
        """This rank's block of each tier's slots."""
        mesh = self._mesh(sim)
        return tuple(mesh.block(s) for s in sizes)

    def _reduce(self, sim: "sim_lib.Simulation"):
        """The mesh's in-place ``all_reduce``; None with no process group,
        where the fused round stays one graph."""
        mesh = self._mesh(sim)
        return mesh.all_reduce if mesh.group is not None else None

    def writes_checkpoints(self, sim: "sim_lib.Simulation") -> bool:
        """Only the mesh's first rank writes checkpoint files."""
        return self._mesh(sim).rank == 0

    def sync(self, sim: "sim_lib.Simulation") -> None:
        """A barrier over the mesh."""
        self._mesh(sim).barrier()
