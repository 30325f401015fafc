"""Slot-batched cohort split-training engine (port of ``repro.fl.cohort``).

One FL round trains every scheduled device's model at once. The reference
``vmap``s a per-device step over a struct-of-arrays pytree; here the slot
axis is written out: every param of the round is an ``(S, ...)`` tensor,
each conv runs as one grouped ``F.conv2d`` over the slots and each fc layer
as one launch of the slot-batched fused linear kernels. The K local epochs
(``lax.scan`` in the reference) are a Python loop; the two-tier FedAvg
closes the round.

**Partition point handled as data.** Split training at cut ``l`` computes
exactly the same parameter update as unsplit SGD (the boundary
activation/error exchange is transparent, ``tests/test_torch_models.py``),
so the round runs the unsplit forward/backward once per slot and the cut
prices the round (``repro_torch.core.costmodel``), as in the paper; it
also picks which block's output the boundary telemetry reports (the
tensor that would cross the device->gateway link).

Fixed-shape batching contract: inputs come from
``repro_torch.fl.data.sample_cohort_batch`` — padded slots with a
row-validity mask, non-participants zero-masked and zero-weighted. A slot
whose mask is all zero contributes an exact-zero loss and gradient. Tiered
layouts (``CohortLayout``) run one slot-batched segment per tier.

The statistics pass (:func:`cohort_stats`) takes per-device gradients at
the shared global weights: each weight enters as an expanded stride-0 view
with one slot per device, so the kernels read the single matrix in place
while autograd returns one gradient per slot.

Mixed precision (``compute_dtype="bf16"``, the reference's
``Scenario(dtype="bf16")``): the round's per-slot master copies stay f32;
each local step casts them and the inputs to bf16, so autograd runs
through the cast and the gradients come back f32 onto the f32 masters,
and the logits are promoted to f32 before the loss. The statistics pass
and evaluation stay f32, as in the reference.

The fused loop's training half (:func:`train_scan`,
:func:`train_scan_traced`, driven by ``repro_torch.fl.fused_sim``) runs a
block of rounds with nothing read on the host: on CUDA one trained round
is captured once as a CUDA graph (``repro_torch.graphs.GraphedStep``) and
replayed every round, threading (params, losses) on the device.

Each round, stepwise or fused, is two halves: the slots' training and
their FedAvg sums (:func:`local_partials`), then the division that
finishes the averages (:func:`fedavg_finish`). The sharded engine
(``repro_torch.fl.shard``) runs the first half on a rank's own slots and
sums the halves' buffers over the ranks with one ``all_reduce`` before
the second; the statistics pass splits the same way at the global
gradient (:func:`stats_partials`, :func:`stats_delta`).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fl.data import TieredCohortBatch, traced_batch_indices
from repro_torch.fl.split import _like, flat_params, leaves
from repro_torch.graphs import GraphedStep
from repro_torch.models.split_model import Params, SplitModel

# Scenario.dtype -> the dtype the round's activations and weights are
# computed in (None: the f32 masters as they are)
COMPUTE_DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _cast_floats(tree, dtype):
    """Cast the floating tensors of a tensor or a list of per-layer dicts
    to ``dtype`` (integer tokens untouched); ``dtype=None`` is the
    identity. Differentiable: a cast master's gradient comes back in the
    master's dtype."""
    if dtype is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    return [{k: _cast_floats(v, dtype) for k, v in layer.items()}
            for layer in tree]


def _on(params: Params, device) -> Params:
    return [{k: v.to(device) for k, v in p.items()} for p in params]


def _batch_tiers(batch, device):
    """(xs, ys, masks) per-tier tuples on ``device`` from a CohortBatch or
    TieredCohortBatch — single-width batches become one-tier tuples."""
    tiers = batch.tiers if isinstance(batch, TieredCohortBatch) else (batch,)

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)
    return (tuple(put(t.x) for t in tiers), tuple(put(t.y) for t in tiers),
            tuple(put(t.mask) for t in tiers))


def _local_train(model: SplitModel, params: Params, xs, ys, masks,
                 k_iters: int, lr, compute_dtype: str = "f32"):
    """K local SGD epochs for every slot, one slot-batched segment per tier.

    ``xs/ys/masks`` are per-tier tuples (tier k: ``(S_k, W_k, ...)``).
    Returns (per-tier per-slot final params, per-tier last-epoch losses):
    the loss of the last epoch is taken before its update, as the
    reference's scan reports it. ``compute_dtype="bf16"`` casts the f32
    per-slot params and the inputs to bf16 inside each step.
    """
    cdt = COMPUTE_DTYPES[compute_dtype]
    finals, losses = [], []
    for x, y, m in zip(xs, ys, masks):
        s = x.shape[0]
        # the round's own per-slot f32 copies of the global model, updated
        # in place epoch by epoch
        p = [{k: v.detach().expand(s, *v.shape).clone().requires_grad_()
              for k, v in layer.items()} for layer in params]
        ws = leaves(p)
        xc = _cast_floats(x, cdt)
        for _ in range(k_iters):
            logits = model.forward_slots(_cast_floats(p, cdt), xc)
            loss = model.masked_loss(logits.float(), y, m)
            grads = torch.autograd.grad(loss.sum(), ws)
            with torch.no_grad():
                for w, g in zip(ws, grads):
                    w.sub_(lr * g)
        finals.append([{k: v.detach() for k, v in layer.items()}
                       for layer in p])
        losses.append(loss.detach())
    return tuple(finals), tuple(losses)


def _masked_rms(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-slot RMS over the valid rows of a slot-batched (S, B, ...)
    activation, in f32."""
    a2 = a.reshape(a.shape[0], a.shape[1], -1).float()
    denom = mask.sum(dim=1).clamp_min(1.0) * a2.shape[2]
    return torch.sqrt((a2 * a2 * mask[..., None]).sum(dim=(1, 2)) / denom)


@torch.no_grad()
def _boundary_rms(model: SplitModel, params: Params, x, mask,
                  l) -> torch.Tensor:
    """Each slot's RMS of the activation crossing the device->gateway
    boundary at its cut ``l`` (S,): l = 0 ships the raw input, l =
    model.n_blocks the logits (everything ran device-side)."""
    norms = torch.stack([_masked_rms(a, mask)
                         for a in model.activations_slots(params, x)])
    return norms[l, torch.arange(x.shape[0], device=x.device)]


def _boundary_tiers(model: SplitModel, finals, xs, masks, ls):
    """Per-slot boundary-activation RMS, one slot-batched pass per tier."""
    return tuple(_boundary_rms(model, f, x, m, l)
                 for f, x, m, l in zip(finals, xs, masks, ls))


def _split_tiers(v, sizes: Tuple[int, ...]):
    """Split a tier-major per-slot vector/matrix into per-tier pieces."""
    out, off = [], 0
    for s in sizes:
        out.append(v[off:off + s])
        off += s
    return tuple(out)


def _concat_tiers(tiers) -> Params:
    """Concatenate per-tier per-slot params along the slot axis."""
    if len(tiers) == 1:
        return tiers[0]
    return [{k: torch.cat([t[i][k] for t in tiers]) for k in layer}
            for i, layer in enumerate(tiers[0])]


def stack_params(models: List[Params]) -> Params:
    """Same-structure params stacked leaf by leaf on a new leading axis."""
    return [{k: torch.stack([m[i][k] for m in models]) for k in layer}
            for i, layer in enumerate(models[0])]


def weighted_mean(stacked: Params, w: torch.Tensor) -> Params:
    """Contract every leaf's leading (model) axis with the weights ``w`` —
    the FedAvg of a stack of models; a (G, S) ``w`` gives G averages on a
    new leading axis."""
    return [{k: torch.tensordot(w, v, dims=1) for k, v in p.items()}
            for p in stacked]


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")


def fedavg_partials(final: Params, weights, losses, gw_onehot,
                    with_gateway_models: bool = False) -> torch.Tensor:
    """The two-tier FedAvg's sums over the given slots, in one flat f32
    buffer: every leaf's sum of weight x slot params, the weight total,
    each gateway's count of active slots and sum of their losses, and,
    with ``with_gateway_models``, each gateway's weighted sum of its slots'
    params and its weight total. Sums over disjoint sets of slots add up
    to the sums over their union, so the sharded round reduces these
    buffers with one ``all_reduce`` and :func:`fedavg_finish` divides."""
    parts = [torch.tensordot(weights, v, dims=1).reshape(-1)
             for v in leaves(final)]
    active = (weights > 0).float()
    parts += [weights.sum().reshape(1), gw_onehot.T @ active,
              gw_onehot.T @ (losses * active)]
    if with_gateway_models:
        # per-gateway shop-floor FedAvg before the global mix: columns of
        # the (S, M) incidence weighted by d_tilde, normalized per gateway
        gw_w = gw_onehot * weights[:, None]
        parts += [torch.tensordot(gw_w.T, v, dims=1).reshape(-1)
                  for v in leaves(final)]
        parts.append(gw_w.sum(dim=0))
    return torch.cat(parts)


def fedavg_finish(sums: torch.Tensor, skeleton: Params, shapes, n_gw: int,
                  with_gateway_models: bool = False):
    """(new_global, gw_loss, gw_count, w_sum, gw_models) from a buffer of
    :func:`fedavg_partials` (summed over every slot): the gateway-level
    then BS-level weighted averaging telescopes to one weighted average
    over participating slots. ``shapes`` are the global params' leaf
    shapes (:func:`leaves` order); ``gw_models`` None unless asked
    for."""
    off = 0

    def take(n: int) -> torch.Tensor:
        nonlocal off
        off += n
        return sums[off - n:off]
    totals = [take(int(np.prod(s))).view(s) for s in shapes]
    w_sum = take(1)[0]
    new_global = _like([t / w_sum.clamp_min(1e-12) for t in totals],
                       skeleton)
    gw_count = take(n_gw)
    gw_loss = take(n_gw) / gw_count.clamp_min(1.0)
    gw_models = None
    if with_gateway_models:
        nums = [take(n_gw * int(np.prod(s))).view(n_gw, *s) for s in shapes]
        den = take(n_gw).clamp_min(1e-12)
        gw_models = _like([t / den.view(-1, *(1,) * (t.dim() - 1))
                           for t in nums], skeleton)
    return new_global, gw_loss, gw_count, w_sum, gw_models


def _shapes(params: Params) -> List[Tuple[int, ...]]:
    return [tuple(v.shape) for v in leaves(params)]


def local_partials(model: SplitModel, params: Params, xs, ys, masks, l_n,
                   weights, gw_onehot, lr, *, k_iters: int,
                   with_boundary: bool, with_gateway_models: bool = False,
                   compute_dtype: str = "f32"):
    """A round up to its reduction, over the slots given: train them
    (:func:`_local_train`), then their FedAvg sums
    (:func:`fedavg_partials`). ``xs/ys/masks`` are per-tier tuples, ``l_n``
    (S,) int64 (read only with ``with_boundary``), ``weights`` (S,) and
    ``gw_onehot`` (S, M) float32. Returns (sums, slot losses (S,),
    boundary RMS (S,), zeros without ``with_boundary``)."""
    xs = tuple(model.prepare_inputs(x) for x in xs)
    final_t, loss_t = _local_train(model, params, xs, ys, masks, k_iters,
                                   lr, compute_dtype)
    dev_losses = torch.cat(loss_t)
    sums = fedavg_partials(_concat_tiers(final_t), weights, dev_losses,
                           gw_onehot, with_gateway_models)
    if with_boundary:
        boundary = torch.cat(_boundary_tiers(
            model, final_t, xs, masks,
            _split_tiers(l_n, tuple(x.shape[0] for x in xs))))
    else:    # skip the extra forward pass; l_n stays unused data
        boundary = torch.zeros_like(weights)
    return sums, dev_losses, boundary


def cohort_round_traced(model: SplitModel, params: Params, xs, ys, masks,
                        l_n, weights, gw_onehot, lr, *, k_iters: int,
                        with_boundary: bool,
                        with_gateway_models: bool = False,
                        compute_dtype: str = "f32"):
    """The round on tensors already on the device, reading nothing on the
    host: :func:`local_partials` over every slot, then
    :func:`fedavg_finish`. The body of :func:`cohort_round`; the sharded
    round (``repro_torch.fl.shard``) runs the same two halves with an
    ``all_reduce`` between. Arguments as :func:`local_partials`'. Returns
    (new_global, gw_loss, gw_count, slot_losses, boundary, gw_models),
    ``gw_models`` None unless asked for."""
    sums, dev_losses, boundary = local_partials(
        model, params, xs, ys, masks, l_n, weights, gw_onehot, lr,
        k_iters=k_iters, with_boundary=with_boundary,
        with_gateway_models=with_gateway_models, compute_dtype=compute_dtype)
    new_global, gw_loss, gw_count, _, gw_models = fedavg_finish(
        sums, params, _shapes(params), gw_onehot.shape[1],
        with_gateway_models)
    return new_global, gw_loss, gw_count, dev_losses, boundary, gw_models


def cohort_round(model: SplitModel, params: Params, batch, l_n, weights,
                 gw_onehot, k_iters: int, lr, with_boundary: bool = True,
                 with_gateway_models: bool = False,
                 compute_dtype: str = "f32", device="cuda") -> Tuple:
    """Run one FL round for the whole cohort.

    batch: ``repro_torch.fl.data.CohortBatch`` (single padded width) or
    ``TieredCohortBatch`` (tiered slot widths, one segment per tier).
    l_n: (S,) partition point per slot: it prices the round (see the module
    docstring) and picks the cut whose activation ``with_boundary``
    reports. weights: (S,) FedAvg weights (d_tilde for participants, 0
    otherwise). gw_onehot: (S, M) slot->gateway incidence.
    with_boundary: also report each slot's boundary-activation RMS at its
    cut (one more forward pass, in f32 on the trained f32 per-slot params
    whatever ``compute_dtype``); zeros otherwise.
    with_gateway_models: also return the per-gateway shop-floor FedAvg
    models (leading gateway axis M), before the global mix — the
    intermediate the Fig. 2 divergence experiment measures.

    Returns (new_global_params, per_gateway_loss (M,), per_gateway_count
    (M,), per_slot_loss (S,), boundary_rms (S,)), plus the gateway models
    as a sixth element when ``with_gateway_models`` is set; tensors on
    ``device``. The inputs go to the device and ``l_n`` is checked on the
    host here; the round itself is :func:`cohort_round_traced`, whose
    sharded mapping is ``repro_torch.fl.shard.sharded_cohort_round``.
    """
    _check_dtype(compute_dtype)
    device = resolve_device(device)
    xs, ys, masks = _batch_tiers(batch, device)
    if with_boundary:
        l_n = np.asarray(l_n)
        if ((l_n < 0) | (l_n > model.n_blocks)).any():
            raise ValueError(f"partition points {l_n.tolist()} outside "
                             f"[0, {model.n_blocks}]")
        l_n = torch.as_tensor(l_n, dtype=torch.long, device=device)
    weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                              device=device)
    gw = torch.as_tensor(np.asarray(gw_onehot), dtype=torch.float32,
                         device=device)
    out = cohort_round_traced(
        model, _on(params, device), xs, ys, masks, l_n, weights, gw, lr,
        k_iters=k_iters, with_boundary=with_boundary,
        with_gateway_models=with_gateway_models, compute_dtype=compute_dtype)
    return out if with_gateway_models else out[:5]


# ---------------------------------------------------------------------------
# the fused loop's training half: every round of a block, one CUDA graph
# replay a round (the reference's lax.scan programs)
# ---------------------------------------------------------------------------


def _eval_hits(model: SplitModel, params: Params, x_test: torch.Tensor,
               y_test: torch.Tensor, batch: int = 256) -> torch.Tensor:
    """Test-set hits of the f32 master params, a 0-d int64 tensor: the
    forward in the ``batch``-row chunks of ``SplitModel.accuracy``, so the
    count equals the stepwise loop's evaluation exactly."""
    hits = torch.zeros((), dtype=torch.int64, device=x_test.device)
    with torch.no_grad():
        for i in range(0, len(x_test), batch):
            logits = model.forward(params, x_test[i:i + batch])
            hits = hits + (logits.argmax(-1) == y_test[i:i + batch]).sum()
    return hits


def _guarded_finish(params: Params, losses, sums, tr):
    """A round of the fused loop from its reduced FedAvg sums
    (:func:`fedavg_finish`) with the reference scan's two guards: a round
    where nobody trained (weight total 0) keeps the old params, where the
    normalized FedAvg would average into zeros (the stepwise loop skips
    such a round); a gateway's loss updates only where it trained (``tr``,
    (M,) bool)."""
    new_global, gw_loss, _, w_sum, _ = fedavg_finish(
        sums, params, _shapes(params), tr.shape[0])
    any_trained = w_sum > 0
    params = [{k: torch.where(any_trained, new[k], old[k]) for k in old}
              for new, old in zip(new_global, params)]
    return params, torch.where(tr, gw_loss, losses)


def _scan(train, evaluate: GraphedStep, params: Params, losses0,
          rounds: int, inputs_at, eval_mask):
    """``rounds`` calls of ``train`` threading (params, losses), and
    replays of ``evaluate`` on the rounds ``eval_mask`` (host bools)
    marks; nothing is read on the host. Returns (params, losses, loss
    history (T, M), hits (T,), -1 where not evaluated), on the device."""
    carry = (*leaves(params), losses0)
    loss_hist = torch.empty((rounds, *losses0.shape), dtype=losses0.dtype,
                            device=losses0.device)
    hits = torch.full((rounds,), -1, dtype=torch.int64,
                      device=losses0.device)
    for t in range(rounds):
        carry = train(*carry, *inputs_at(t))
        loss_hist[t].copy_(carry[-1])
        if eval_mask[t]:
            hits[t].copy_(evaluate(*carry[:-1])[0])
    # a graph's outputs are its own buffers, which its next replay
    # overwrites: keep copies
    return (_like([x.clone() for x in carry[:-1]], params),
            carry[-1].clone(), loss_hist, hits)


def _skeleton(params: Params) -> Params:
    """``params``'s structure without its tensors (what :func:`_like`
    reads), for closures that outlive a block."""
    return [dict.fromkeys(p) for p in params]


def _steps(graphs, plane: str, model: SplitModel, params: Params, local_fn,
           x_test, y_test, reduce):
    """A trained round of ``plane`` as a callable over (params leaves,
    losses, the round's inputs, its trained mask ``tr``), returning the
    new (params leaves, losses), and the evaluation's GraphedStep.

    ``local_fn(params, *inputs)`` is the round up to its reduction (the
    FedAvg sums, :func:`local_partials`). With ``reduce`` None the round
    is one GraphedStep ("train_scan"). A sharded round is split at its
    collective, which a CUDA graph cannot hold under gloo: a captured
    local half ("train_local"), ``reduce`` on its sums (an in-place
    ``all_reduce``) run eagerly, and a captured half that finishes the
    round (:func:`_guarded_finish`, "train_finish"). The GraphedSteps live
    in ``graphs`` (the caller's cache: a later block with the same shapes
    replays the graphs captured before), made on first use."""
    key = (plane, id(model))
    skeleton, n = _skeleton(params), len(leaves(params))
    if key not in graphs:
        def eval_fn(*flat):
            return (_eval_hits(model, _like(list(flat), skeleton), x_test,
                               y_test),)

        def finish_fn(*flat):      # params, losses, sums, tr
            p, losses = _guarded_finish(_like(list(flat[:n]), skeleton),
                                        *flat[n:])
            return (*leaves(p), losses)

        if reduce is None:
            def train_fn(*flat):   # params, losses, inputs, tr
                sums = local_fn(_like(list(flat[:n]), skeleton),
                                *flat[n + 1:-1])
                return finish_fn(*flat[:n + 1], sums, flat[-1])
            steps = (GraphedStep(train_fn, "train_scan"),)
        else:
            def sums_fn(*flat):    # params, inputs
                return (local_fn(_like(list(flat[:n]), skeleton),
                                 *flat[n:]),)
            steps = (GraphedStep(sums_fn, "train_local"),
                     GraphedStep(finish_fn, "train_finish"))
        graphs[key] = steps + (GraphedStep(eval_fn, "eval"),)
    *steps, evaluate = graphs[key]
    if reduce is None:
        return steps[0], evaluate
    local, finish = steps

    def train(*flat):
        sums = reduce(local(*flat[:n], *flat[n + 1:-1])[0])
        return finish(*flat[:n + 1], sums, flat[-1])
    return train, evaluate


def train_scan(model: SplitModel, params: Params, losses0, xs, ys, masks,
               ls, ws, gws, trained, lr, eval_mask, x_test, y_test, *,
               k_iters: int, compute_dtype: str = "f32", graphs=None,
               reduce=None):
    """The whole training block: one trained round per replay of one
    captured graph (on CUDA; eagerly on the CPU), the counterpart of the
    reference's ``lax.scan`` of the fused round.

    ``xs/ys/masks/ls/ws/gws`` are per-tier tuples of (T, S_k, ...) tensors
    on the device and ``trained`` the (T, M) bool trained-gateway mask;
    ``ls`` is accepted as the reference's scan takes it, and unused (the
    scan reports no boundary RMS). The carry is (params, per-gateway f32
    losses), with :func:`_guarded_finish`'s guards. ``eval_mask`` is the
    (T,) host bool ``eval_every`` schedule: a marked round replays a
    second graph, the test-set hit count (:func:`_eval_hits`) on the
    round's params. ``graphs``: a dict the caller keeps across blocks.
    ``reduce``: the sharded engine's in-place sum of a round's FedAvg
    sums over the mesh; the slots are then this rank's, and the round
    splits at the reduction (:func:`_steps`).

    Returns (params, losses (M,), loss history (T, M) f32, test hits (T,)
    int64, -1 where not evaluated), on the device. One capture of each
    graph per (model, tier shapes, K, dtype); the graph's ``lr``, K and
    dtype are those of its first capture, so one ``graphs`` dict serves
    one scenario.
    """
    del ls
    _check_dtype(compute_dtype)
    n_tiers = len(xs)

    def local_fn(p, *inputs):
        xs_t, ys_t, masks_t = (inputs[i * n_tiers:(i + 1) * n_tiers]
                               for i in range(3))
        w, gw = inputs[3 * n_tiers:]
        return local_partials(model, p, xs_t, ys_t, masks_t, None, w, gw,
                              lr, k_iters=k_iters, with_boundary=False,
                              compute_dtype=compute_dtype)[0]

    train, evaluate = _steps({} if graphs is None else graphs, "host", model,
                             params, local_fn, x_test, y_test, reduce)
    w_all, gw_all = torch.cat(ws, dim=1), torch.cat(gws, dim=1)
    return _scan(train, evaluate, params, losses0, trained.shape[0],
                 lambda t: (*[x[t] for x in xs], *[y[t] for y in ys],
                            *[m[t] for m in masks], w_all[t], gw_all[t],
                            trained[t]), eval_mask)


def _gather_tier(x_all, y_all, pool_lens, batch_lens, key, t, devs,
                 width: int):
    """One tier's round batch gathered from the device-resident stacks:
    slot i reads device ``devs[i]``'s draw (:func:`traced_batch_indices`
    at the tier's width), an empty slot (-1) device 0's rows under an
    all-zero mask; rows past the device's batch length are masked too."""
    d = devs.clamp_min(0)
    idx = traced_batch_indices(key, t, d, pool_lens[d], width,
                               x_all.shape[1])
    rows = torch.arange(width, device=devs.device)
    mask = ((rows < batch_lens[d][:, None]) & (devs >= 0)[:, None]).float()
    return x_all[d[:, None], idx], y_all[d[:, None], idx], mask


def train_scan_traced(model: SplitModel, params: Params, losses0, x_all,
                      y_all, pool_lens, batch_lens, data_key, ts, slot_devs,
                      ls, ws, gws, trained, lr, eval_mask, x_test, y_test, *,
                      k_iters: int, compute_dtype: str = "f32",
                      tier_widths: Tuple[int, ...], graphs=None,
                      reduce=None):
    """:func:`train_scan` with the data plane inside the graph: each round
    gathers its batches from the device-resident shard stacks
    (``repro_torch.fl.data.device_resident_stacks``) by the counter-based
    draws, so the block ships only the decision tensors to the device.

    ``slot_devs`` maps every tier-major slot to its device id (-1 empty),
    per tier (T, S_k) int64; ``ts`` the (T,) absolute rounds the draws
    fold in; ``pool_lens`` and ``batch_lens`` (N,) int64 and ``data_key``
    (2,) on the device. Empty slots gather device 0's rows under an
    all-zero mask, whose loss and gradients are exact zeros, as the host
    plane's zero padding gives. Under ``reduce`` the slots are this
    rank's, so a rank gathers only its own slots' batches. Returns what
    :func:`train_scan` does.
    """
    del ls
    _check_dtype(compute_dtype)
    n_tiers = len(slot_devs)

    def local_fn(p, t, key, *inputs):
        devs, (w, gw) = inputs[:n_tiers], inputs[n_tiers:]
        gathered = [_gather_tier(x_all, y_all, pool_lens, batch_lens, key,
                                 t, d, width)
                    for d, width in zip(devs, tier_widths)]
        return local_partials(
            model, p, *(tuple(g[i] for g in gathered) for i in range(3)),
            None, w, gw, lr, k_iters=k_iters, with_boundary=False,
            compute_dtype=compute_dtype)[0]

    train, evaluate = _steps({} if graphs is None else graphs, "traced",
                             model, params, local_fn, x_test, y_test, reduce)
    w_all, gw_all = torch.cat(ws, dim=1), torch.cat(gws, dim=1)
    return _scan(train, evaluate, params, losses0, trained.shape[0],
                 lambda t: (ts[t], data_key, *[d[t] for d in slot_devs],
                            w_all[t], gw_all[t], trained[t]), eval_mask)


def buffer_fedavg(models: List[Params], weights) -> Params:
    """Weighted FedAvg over a list of same-structure parameter lists, with
    raw (unnormalized) weights — the aggregation primitive of the buffered
    async engine, the same contraction as the round's FedAvg."""
    device = leaves(models[0])[0].device
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=device)
    return weighted_mean(stack_params(models), w / w.sum().clamp_min(1e-12))


# ---------------------------------------------------------------------------
# per-device gradient statistics (sigma_n, delta_n, L_n)
# ---------------------------------------------------------------------------


def _slot_grads(model: SplitModel, params: Params, x, y, mask=None, *,
                per_slot: bool = False) -> List[torch.Tensor]:
    """Each slot's gradient of its own loss, as (S, ...) tensors in
    :func:`leaves` order. ``per_slot=False``: ``params`` is one model, fed
    to every slot as a stride-0 view; ``True``: leaves already lead with S."""
    s = x.shape[0]
    p = [{k: (v if per_slot else v.expand(s, *v.shape)).detach()
          .requires_grad_() for k, v in layer.items()} for layer in params]
    logits = model.forward_slots(p, x)
    loss = (model.loss(logits, y) if mask is None
            else model.masked_loss(logits, y, mask))
    return list(torch.autograd.grad(loss.sum(), leaves(p)))


def _rows(ts: List[torch.Tensor]) -> torch.Tensor:
    """(S, P) flat rows from per-slot leaves."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in ts], dim=1)


def _grads_sigma_lips(model: SplitModel, params: Params, x, y, mask, lr,
                      sigma_samples: int):
    """Per-device flat batch gradients, sigma_n and L_n. ``x`` must already
    be through ``model.prepare_inputs``. Returns (grads (N, P), sigma (N,),
    lips (N,))."""
    g = _slot_grads(model, params, x, y, mask)
    grads = _rows(g)                                             # (N, P)

    # sigma_n: per-sample gradient spread. One device at a time, so the
    # (S, P) per-sample buffer stays per device: its samples are S slots of
    # one row each at the shared weights.
    s = min(sigma_samples, x.shape[1])
    sigma = []
    for xs, ys, ms in zip(x[:, :s], y[:, :s], mask[:, :s]):
        per = _rows(_slot_grads(model, params, xs.unsqueeze(1),
                                ys.unsqueeze(1)))                # (S, P)
        cnt = ms.sum().clamp_min(1.0)
        mean_g = (per * ms[:, None]).sum(dim=0) / cnt
        dev = torch.linalg.vector_norm(per - mean_g[None], dim=1)
        sigma.append((dev * ms).sum() / cnt)
    sigma = torch.stack(sigma)

    # L_n: two-point secant along the SGD direction.
    pert = [w.detach()[None] - lr * gi for w, gi in zip(leaves(params), g)]
    grads2 = _rows(_slot_grads(model, _like(pert, params), x, y, mask,
                               per_slot=True))
    dw = torch.linalg.vector_norm(
        _rows(pert) - flat_params(params).detach()[None], dim=1)
    lips = (torch.linalg.vector_norm(grads2 - grads, dim=1)
            / dw.clamp_min(1e-9))
    return grads, sigma, lips


def stats_partials(model: SplitModel, params: Params, x, y, mask, mix,
                   lr, sigma_samples: int):
    """The statistics pass over the given devices up to its reduction:
    their flat batch gradients, sigma_n and L_n
    (:func:`_grads_sigma_lips`, on ``x`` as the batch holds it), and their
    share of the D_n-weighted global gradient (``mix`` their weights).
    Returns (grads (N, P), sigma (N,), lips (N,), partial global (P,))."""
    grads, sigma, lips = _grads_sigma_lips(
        model, params, model.prepare_inputs(x), y, mask, lr, sigma_samples)
    return grads, sigma, lips, torch.tensordot(mix, grads, dims=1)


def stats_delta(grads: torch.Tensor, global_g: torch.Tensor) -> torch.Tensor:
    """delta_n: each device's divergence from the global gradient."""
    return torch.linalg.vector_norm(grads - global_g[None], dim=1)


def cohort_stats(model: SplitModel, params: Params, batch, mix_weights, lr,
                 sigma_samples: int, device="cuda"):
    """sigma/delta/Lipschitz for every device of ``batch`` (a CohortBatch
    with one row per device): :func:`stats_partials` over every row, then
    :func:`stats_delta` (the sharded pass reduces the global gradient
    between them). Returns three (N,) float32 tensors."""
    device = resolve_device(device)
    (x,), (y,), (mask,) = _batch_tiers(batch, device)
    mix = torch.as_tensor(np.asarray(mix_weights), dtype=torch.float32,
                          device=device)
    grads, sigma, lips, global_g = stats_partials(
        model, _on(params, device), x, y, mask, mix, lr, sigma_samples)
    return sigma, stats_delta(grads, global_g), lips
