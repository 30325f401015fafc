"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro.models.moe``).

Each routing group's tokens pick their top-k experts; an expert takes at
most ``capacity`` of them, in token order, and the rest are dropped (the
residual path keeps them lossless). The dispatch buffer is (E, C, D), so
each expert's SwiGLU is one batched product over (slots, experts).

The FL models run slot-batched (``SeqSplitModel``: activations
``(S, B, seq, D)``, every weight per slot), and the reference's
``moe_ffn`` sees one slot's ``(B, seq, D)`` under its cohort round's vmap.
So :func:`moe_ffn_slots` routes each slot (and each of its
``dispatch_groups`` groups) on its own: capacity is per group, padded rows
of a slot take capacity like real ones, and slots are never folded into
one routing group. A caller that routes a whole batch as one group (the
evaluation's 256-row chunks) must not pad it either: one token's output
depends on the other tokens of its group.

Traps the reference's jax ops hide, each matched here:

* **Top-k ties.** ``jax.lax.top_k`` puts the lower index first among
  equal values; ``torch.topk`` promises no order. bf16 router logits tie
  often at E = 4, so :func:`router_topk` takes the top k of a stable
  descending sort, on keys that order -0.0 below +0.0 as jax does.
* **Stable sort.** ``jnp.argsort`` is stable, and an entry's rank within
  its expert is its place in that order: ``torch.argsort(stable=True)``.
* **No host syncs.** The fused loop captures a trained round as one CUDA
  graph, so the dispatch reads nothing on the host: expert sizes are a
  fixed-size one-hot sum (not ``bincount``), no boolean-mask indexing,
  no ``nonzero``, no ``.item()``.
* **Dtypes as the reference casts them.** Logits are in the activations'
  dtype (bf16 on the bf16 plane) before the f32 top-k; the experts' silu
  rounds each of its ops to that dtype, as XLA's expansion of
  ``jax.nn.silu`` does (:func:`_silu`); the gate is cast to the expert
  outputs' dtype before the multiply, and the combine sums in that
  dtype.
* **Dropped entries.** The reference writes them as zeros to (expert 0,
  rank 0) and adds their zero-weighted contribution from there. Here a
  dropped entry writes to a spare row past the buffer, which no expert
  reads, and the combine reads (expert 0, rank 0) at weight 0 as the
  reference does. Every kept entry has a cell of its own, so the dispatch
  is a scatter without accumulation (its gradient a gather), and the
  combine gathers each token's k contributions to (T, k, D) and adds them
  in ascending expert order (the reference's scatter-add order), not by
  atomics: deterministic on the card for any k.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def router_topk(logits: torch.Tensor, k: int):
    """logits (..., E) -> gates (..., k) f32 (softmaxed over the top k),
    idx (..., k) int64, the lower index first among equal logits.

    ``jax.lax.top_k`` orders floats totally (-0.0 below +0.0), so the sort
    key is the f32 bit pattern mapped to an int32 of the same order."""
    logits = logits.float()
    bits = logits.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.softmax(logits.gather(-1, idx), dim=-1), idx


def _silu(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: ``a * logistic(a)`` with the
    logistic expanded to ``1 / (1 + exp(-a))``, each op rounded to ``a``'s
    dtype. In bf16 that lies up to a few ulps from ``F.silu``, which
    rounds once; in f32 the two agree to an ulp."""
    return a * torch.reciprocal(1.0 + torch.exp(-a))


def _route(logits: torch.Tensor, e: int, k: int, cap: int):
    """One routing per group: logits (G, T, E) -> (dest (G, T*k) int64,
    the entry's buffer cell ``expert * cap + rank`` or the spare cell
    ``e * cap`` when dropped; keep (G, T*k) bool; gates (G, T*k) f32), in
    token-major order (token t's j-th choice at t * k + j)."""
    gates, idx = router_topk(logits, k)                  # (G, T, k)
    g, t = idx.shape[:2]
    flat_expert = idx.reshape(g, t * k)
    # the reference's stable sort by expert: an entry's rank within its
    # expert is how many entries of that expert precede it in token order
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = flat_expert.gather(-1, order)
    experts = torch.arange(e, device=idx.device)
    sizes = (flat_expert[..., None] == experts).sum(dim=1)          # (G, E)
    starts = sizes.cumsum(dim=-1) - sizes
    rank_sorted = (torch.arange(t * k, device=idx.device)
                   - starts.gather(-1, se))
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    keep = rank < cap
    dest = torch.where(keep, flat_expert * cap + rank,
                       torch.full_like(rank, e * cap))
    return dest, keep, gates.reshape(g, t * k)


def moe_ffn_slots(x: torch.Tensor, params: Dict[str, torch.Tensor],
                  cfg: MoEConfig) -> torch.Tensor:
    """x (S, B, seq, D) -> (S, B, seq, D), each slot on its own weights.

    params: router (S, D, E), w1/w3 (S, E, D, F), w2 (S, E, F, D), per
    slot (a stride-0 expanded view when shared). Each slot's B x seq
    tokens split into ``cfg.dispatch_groups`` fixed groups, each routed
    alone (the reference's ``moe_ffn`` on that slot)."""
    s, d = x.shape[0], x.shape[-1]
    t = x[0].numel() // d
    e, k = cfg.n_experts, cfg.top_k
    ng = max(1, cfg.dispatch_groups)
    if t % ng:
        raise ValueError(f"{t} tokens do not split into {ng} groups")
    tg = t // ng
    cap = capacity(tg, cfg)

    xt = x.reshape(s, t, d)
    logits = torch.bmm(xt, params["router"])             # (S, T, E), x's dtype
    dest, keep, gates = _route(logits.reshape(s * ng, tg, e), e, k, cap)

    # dispatch: each entry's token row to its cell, drops to the spare row
    xg = xt.reshape(s * ng, tg, d)
    rows = xg[:, :, None, :].expand(-1, -1, k, -1).reshape(s * ng, tg * k, d)
    buf = torch.zeros((s * ng, e * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf = buf.scatter(1, dest[..., None].expand(-1, -1, d), rows)
    buf = buf[:, :e * cap].reshape(s, ng, e, cap, d)

    # experts: one batched product per (slot, expert) over its groups' cells
    be = buf.transpose(1, 2).reshape(s, e, ng * cap, d)
    h = _silu(torch.matmul(be, params["w1"])) * torch.matmul(be,
                                                            params["w3"])
    yb = torch.matmul(h, params["w2"])                   # (S, E, G*C, D)
    yb = yb.reshape(s, e, ng, cap, d).transpose(1, 2).reshape(
        s * ng, e * cap, d)

    # combine: every entry reads its cell ((0, 0) when dropped) at its
    # gate, and a token's k contributions add up in ascending expert
    # order, the order of the reference's scatter-add over sorted entries
    cell = torch.where(keep, dest, torch.zeros_like(dest))
    contrib = yb.gather(1, cell[..., None].expand(-1, -1, d))
    contrib = (contrib * (gates * keep).to(yb.dtype)[..., None]).reshape(
        s * ng, tg, k, d)
    if k > 2:                     # a sum of two is the same either way
        by_expert = (dest // cap).reshape(s * ng, tg, k).argsort(dim=-1)
        contrib = contrib.gather(2, by_expert[..., None].expand(
            -1, -1, -1, d))
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y.reshape(x.shape)


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor],
            cfg: MoEConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) for one model: params router (D, E),
    w1/w3 (E, D, F), w2 (E, F, D), as the reference's ``moe_ffn``."""
    return moe_ffn_slots(x[None], {n: w[None] for n, w in params.items()},
                         cfg)[0]


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss, for training loops that
    add it to the task loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[..., 0], n_experts).float().mean(dim=0)
    return n_experts * torch.sum(me * ce)
