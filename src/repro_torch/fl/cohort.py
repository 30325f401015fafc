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
only prices the round (``repro_torch.core.costmodel``), as in the paper.

Fixed-shape batching contract: inputs come from
``repro_torch.fl.data.sample_cohort_batch`` — padded slots with a
row-validity mask, non-participants zero-masked and zero-weighted. A slot
whose mask is all zero contributes an exact-zero loss and gradient. Tiered
layouts (``CohortLayout``) run one slot-batched segment per tier.

The statistics pass (:func:`cohort_stats`) takes per-device gradients at
the shared global weights: each weight enters as an expanded stride-0 view
with one slot per device, so the kernels read the single matrix in place
while autograd returns one gradient per slot.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fl.data import TieredCohortBatch
from repro_torch.fl.split import _like, flat_params, leaves
from repro_torch.models.split_model import Params, SplitModel

# Scenario.dtype values the data plane runs in (bf16 comes in a later slice)
COMPUTE_DTYPES = ("f32",)


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
                 k_iters: int, lr):
    """K local SGD epochs for every slot, one slot-batched segment per tier.

    ``xs/ys/masks`` are per-tier tuples (tier k: ``(S_k, W_k, ...)``).
    Returns (per-tier per-slot final params, per-tier last-epoch losses):
    the loss of the last epoch is taken before its update, as the
    reference's scan reports it.
    """
    finals, losses = [], []
    for x, y, m in zip(xs, ys, masks):
        s = x.shape[0]
        # the round's own per-slot copies of the global model, updated in
        # place epoch by epoch
        p = [{k: v.detach().expand(s, *v.shape).clone().requires_grad_()
              for k, v in layer.items()} for layer in params]
        ws = leaves(p)
        for _ in range(k_iters):
            loss = model.masked_loss(model.forward_slots(p, x), y, m)
            grads = torch.autograd.grad(loss.sum(), ws)
            with torch.no_grad():
                for w, g in zip(ws, grads):
                    w.sub_(lr * g)
        finals.append([{k: v.detach() for k, v in layer.items()}
                       for layer in p])
        losses.append(loss.detach())
    return tuple(finals), tuple(losses)


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
    the FedAvg of a stack of models."""
    return [{k: torch.tensordot(w, v, dims=1) for k, v in p.items()}
            for p in stacked]


def cohort_round(model: SplitModel, params: Params, batch, l_n, weights,
                 gw_onehot, k_iters: int, lr, with_boundary: bool = False,
                 with_gateway_models: bool = False,
                 compute_dtype: str = "f32", device="cuda") -> Tuple:
    """Run one FL round for the whole cohort.

    batch: ``repro_torch.fl.data.CohortBatch`` (single padded width) or
    ``TieredCohortBatch`` (tiered slot widths, one segment per tier).
    l_n: (S,) partition point per slot (prices the round; see the module
    docstring). weights: (S,) FedAvg weights (d_tilde for participants, 0
    otherwise). gw_onehot: (S, M) slot->gateway incidence.

    Returns (new_global_params, per_gateway_loss (M,), per_gateway_count
    (M,), per_slot_loss (S,), boundary_rms (S,) — zeros, as the reference
    reports without ``with_boundary``), tensors on ``device``.
    """
    if with_boundary or with_gateway_models:
        raise NotImplementedError(
            "boundary RMS and per-gateway models are not ported yet")
    if compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype={compute_dtype!r}")
    del l_n
    device = resolve_device(device)
    xs, ys, masks = _batch_tiers(batch, device)
    xs = tuple(model.prepare_inputs(x) for x in xs)
    final_t, loss_t = _local_train(model, _on(params, device), xs, ys, masks,
                                   k_iters, lr)
    final = _concat_tiers(final_t)
    dev_losses = torch.cat(loss_t)

    # fused two-tier FedAvg: gateway-level then BS-level weighted averaging
    # telescopes to one weighted average over participating devices.
    weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                              device=device)
    new_global = weighted_mean(final,
                               weights / weights.sum().clamp_min(1e-12))

    gw = torch.as_tensor(np.asarray(gw_onehot), dtype=torch.float32,
                         device=device)
    active = (weights > 0).float()
    gw_count = gw.T @ active                                        # (M,)
    gw_loss = (gw.T @ (dev_losses * active)) / gw_count.clamp_min(1.0)
    boundary = torch.zeros_like(weights)
    return new_global, gw_loss, gw_count, dev_losses, boundary


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


def cohort_stats(model: SplitModel, params: Params, batch, mix_weights, lr,
                 sigma_samples: int, device="cuda"):
    """sigma/delta/Lipschitz for every device of ``batch`` (a CohortBatch
    with one row per device). Returns three (N,) float32 tensors."""
    device = resolve_device(device)
    (x,), (y,), (mask,) = _batch_tiers(batch, device)
    params = _on(params, device)
    grads, sigma, lips = _grads_sigma_lips(
        model, params, model.prepare_inputs(x), y, mask, lr, sigma_samples)

    # delta_n: divergence from the D_n-weighted global gradient.
    mix = torch.as_tensor(np.asarray(mix_weights), dtype=torch.float32,
                          device=device)
    global_g = torch.tensordot(mix, grads, dims=1)
    delta = torch.linalg.vector_norm(grads - global_g[None], dim=1)
    return sigma, delta, lips
