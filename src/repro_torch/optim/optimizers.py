"""Minimal tree optimizers over nested dicts of tensors (port of
``repro.optim.optimizers``).

API mirrors the reference's (and optax's): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
:func:`apply_updates`. Functional: nothing is updated in place, and no
autograd graph is recorded. The arithmetic is the reference's, op for op
in f32 (moments, bias corrections, the step's schedule), not
``torch.optim``'s: AdamW's eps sits outside the square root and its
weight decay joins the update before the learning rate. A tree's leaves
are taken in the reference's pytree order, dict keys sorted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.convert import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


@torch.no_grad()
def clip_scale(tree, max_norm: float):
    """(scale, norm): the global norm of ``tree`` and the factor
    :func:`clip_by_global_norm` multiplies every leaf by."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    scale, norm = clip_scale(tree, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0, 1)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def _step_counter(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        state = {"step": _step_counter(params)}
        if momentum:
            state["mu"] = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
        return state

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
            upd = tree_map(lambda m, g: (-lr_t * m).to(g.dtype), mu, grads)
            return upd, {"step": step, "mu": mu}
        upd = tree_map(lambda g: (-lr_t * g.float()).to(g.dtype), grads)
        return upd, {"step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype=torch.float32) -> Optimizer:
    """``moment_dtype=torch.bfloat16`` halves the optimizer state's memory
    (the update math still runs in f32)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,  # noqa
                                      device=p.device)
        return {"step": _step_counter(params),
                "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        m = tree_map(lambda m_, g: (b1 * m_.float() + (1 - b1) * g.float())
                 .to(moment_dtype), state["m"], grads)
        v = tree_map(lambda v_, g: (b2 * v_.float()
                                + (1 - b2) * torch.square(g.float()))
                 .to(moment_dtype), state["v"], grads)

        def upd(m_, v_, p):
            u = ((m_.float() / bc1)
                 / (torch.sqrt(v_.float() / bc2) + eps))
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
