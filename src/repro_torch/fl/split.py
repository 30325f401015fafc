"""Split forward/backward across the DNN partition point (port of
``repro.fl.split``).

Implements the paper's mechanism exactly (Sec. II-B3): the device runs the
bottom ``l`` blocks forward and ships the boundary activation to the
gateway; the gateway runs the top blocks, computes the loss,
backpropagates to the boundary and returns the boundary *error*; the
device completes backward for the bottom blocks. Only the boundary
activation/error and labels cross the tier boundary.

Everything here is model-agnostic: ``model`` is any
``repro_torch.models.split_model.SplitModel`` and ``params`` its matching
per-block list of tensor dicts. Functions return new tensors; nothing is
updated in place.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.models.split_model import Params, SplitModel


def leaves(params: Params) -> List[torch.Tensor]:
    """Param tensors in the reference's pytree order (blocks in order,
    keys sorted within a block)."""
    return [p[k] for p in params for k in sorted(p)]


def _like(flat: List[torch.Tensor], params: Params) -> Params:
    """Per-block dicts shaped like ``params`` from a :func:`leaves` list."""
    it = iter(flat)
    return [{k: next(it) for k in sorted(p)} for p in params]


def _trainable(params: Params) -> Params:
    return [{k: v.detach().requires_grad_() for k, v in p.items()}
            for p in params]


def flat_params(params: Params) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in leaves(params)])


def device_forward(model: SplitModel, bottom: Params, x: torch.Tensor,
                   l: int):
    """Bottom-block forward with a VJP handle kept device-side:
    ``vjp(g_act)`` returns ``(grads of bottom,)``."""
    bottom = _trainable(bottom)
    act = model.forward_range(bottom, x, 0, l)
    ws = leaves(bottom)

    def vjp(g_act):
        grads = torch.autograd.grad(act, ws, g_act) if ws else []
        return (_like(list(grads), bottom),)

    return act.detach(), vjp


def gateway_step(model: SplitModel, top: Params, act: torch.Tensor,
                 labels: torch.Tensor, l: int):
    """Top-block forward+backward. Returns loss, top grads, boundary error."""
    top = _trainable(top)
    a = act.detach().requires_grad_()
    logits = model.forward_range([None] * l + top, a, l, model.n_blocks)
    loss = model.loss(logits, labels)
    ws = leaves(top)
    *g_top, g_act = torch.autograd.grad(loss, ws + [a])
    return loss.detach(), _like(g_top, top), g_act


def _sgd(params: Params, grads: Params, lr) -> Params:
    return [{k: (w - lr * g[k]).detach() for k, w in p.items()}
            for p, g in zip(params, grads)]


def split_sgd_step(model: SplitModel, params: Params, batch_xy, l: int, lr):
    """One local iteration of split training at partition point ``l``."""
    x, labels = batch_xy
    bottom, top = params[:l], params[l:]
    act, vjp = device_forward(model, bottom, x, l)
    loss, g_top, g_act = gateway_step(model, top, act, labels, l)
    (g_bottom,) = vjp(g_act)
    return _sgd(bottom, g_bottom, lr) + _sgd(top, g_top, lr), loss


def local_train(model: SplitModel, params: Params, x, y, l: int,
                k_iters: int, lr: float) -> Tuple[Params, float]:
    """K local epochs of SGD over the sampled batch (the paper's update
    rule). The partition point drops out of the math — split training
    equals unsplit SGD — so every ``l`` runs the same unsplit step."""
    del l
    loss = None
    for _ in range(k_iters):
        p = _trainable(params)
        loss = model.loss(model.forward(p, x), y)
        grads = _like(list(torch.autograd.grad(loss, leaves(p))), p)
        params = _sgd(p, grads, lr)
    return params, float(loss.detach())
