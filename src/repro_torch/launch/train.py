"""LM training driver (port of ``repro.launch.train``): the same code path
on the CPU (reduced configs) as on the card (full configs).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --smoke --device cpu --steps 3 --batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --steps 3 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch stablelm-3b --steps 3 --batch 1 --seq 4096 --remat

A step is the loss's value and gradient, the gradient clipped to a global
norm of 1.0, then AdamW (weight decay 0.01) on a cosine schedule with a
warmup of ``max(steps // 20, 5)`` steps, as the reference's. The step
writes the new params and moments into the old ones, a block of a leaf
at a time (the whole-tree functions' arithmetic, element for element), so
it holds one copy of the params, the gradients and the moments and a
block's temporaries: with ``remat`` (each unit's activations recomputed
in the backward) a 2.8B-param model trains in f32 at 1 x 4096 on one
80 GB card, where the whole-tree update's copies of its 6.7 GB stacked
leaves do not fit.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch import configs as cfg_lib
from repro_torch.checkpoint import latest_step, load_pytree, save_pytree
from repro_torch.configs.base import ArchConfig
from repro_torch.data import markov_stream
from repro_torch.device import resolve_device, use_f32_numerics
from repro_torch.models import get_bundle
from repro_torch.models import model as model_lib
from repro_torch.models.convert import flatten, unflatten
from repro_torch.optim import Optimizer, adamw, cosine_schedule
from repro_torch.optim.optimizers import clip_scale


def value_and_grad(loss_of: Callable, params):
    """(loss, grads shaped as ``params``) of ``loss_of(params)``; the params
    themselves stay outside autograd."""
    leaves = {k: v.detach().requires_grad_()
              for k, v in flatten(params).items()}
    loss = loss_of(unflatten(leaves))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), unflatten(dict(zip(leaves, grads)))


def _leaf(tree, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


# the update's block: elements of a leaf a call of the optimizer sees
UPDATE_BLOCK = 1 << 24


@torch.no_grad()
def update_in_place(opt: Optimizer, grads, opt_state, params,
                    scale: torch.Tensor) -> None:
    """``clip_by_global_norm``'s scaling, ``opt.update`` and
    ``apply_updates`` written into ``params`` and the params-shaped trees
    of ``opt_state``, UPDATE_BLOCK elements of a leaf at a time: ``grads``
    is flat (dotted paths, :func:`flatten`) and emptied, each gradient
    dropped once used. Every op of the three is elementwise, and the
    optimizer sees each block with the whole state's step counter, so the
    result is the whole-tree update's element for element."""
    step = opt_state["step"]
    for path in list(grads):
        g = grads.pop(path).reshape(-1)
        trees = {k: _leaf(v, path).view(-1) for k, v in opt_state.items()
                 if k != "step"}
        p = _leaf(params, path).view(-1)
        for i in range(0, p.numel(), UPDATE_BLOCK):
            blk = slice(i, i + UPDATE_BLOCK)
            gb = g[blk] * scale.to(g.dtype)
            sub = {"step": opt_state["step"],
                   **{k: {path: t[blk]} for k, t in trees.items()}}
            upd, new = opt.update({path: gb}, sub, {path: p[blk]})
            p[blk].copy_(p[blk] + upd[path])
            for k, t in trees.items():
                t[blk].copy_(new[k][path])
            step = new["step"]
        del g
    opt_state["step"] = step


def make_step(cfg: ArchConfig, opt: Optimizer,
              remat: bool = False) -> Callable:
    """The training step ``(params, opt_state, tokens, labels) -> (params,
    opt_state, loss, gnorm)``: the params and the state passed in come
    back updated in place (:func:`update_in_place`). ``remat`` recomputes
    each unit's activations in the backward."""
    def step_fn(params, opt_state, tokens, labels):
        batch_d = {"tokens": tokens, "labels": labels}
        if cfg.enc_layers:
            batch_d["enc_frames"] = torch.zeros(
                (tokens.shape[0], 16, cfg.d_model),
                dtype=params["final_norm"].dtype, device=tokens.device)
        loss, grads = value_and_grad(
            lambda p: model_lib.loss_fn(p, batch_d, cfg, remat=remat),
            params)
        scale, gnorm = clip_scale(grads, 1.0)
        grads = flatten(grads)   # the only reference: emptied below
        update_in_place(opt, grads, opt_state, params, scale)
        return params, opt_state, loss, gnorm
    return step_fn


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          lr: float = 3e-4, ckpt_dir=None, log_every: int = 10,
          seed: int = 0, device="cuda", remat: bool = False,
          on_step: Optional[Callable[[int, float], None]] = None):
    """Train ``arch`` for ``steps`` steps on the Markov token stream;
    returns the losses. ``remat`` recomputes each unit's activations in
    the backward. ``on_step(i, loss)`` runs after step ``i`` (0-based) has
    ended on the device."""
    device = resolve_device(device)
    if device.type == "cuda":
        use_f32_numerics()
    bundle = get_bundle(arch, smoke=smoke)
    cfg = bundle.cfg
    stream = markov_stream(cfg.vocab, seq, batch, seed)

    params = bundle.init(torch.Generator(device=device).manual_seed(seed))
    opt = adamw(cosine_schedule(lr, warmup=max(steps // 20, 5), total=steps),
                weight_decay=0.01)
    opt_state = opt.init(params)
    start = 0
    if ckpt_dir and (s := latest_step(ckpt_dir)) is not None:
        loaded = load_pytree(f"{ckpt_dir}/step_{s:08d}.npz", params)
        params = unflatten({k: v.to(device)
                            for k, v in flatten(loaded).items()})
        start = s

    step_fn = make_step(cfg, opt, remat)
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        b = stream.next_batch()
        params, opt_state, loss, gnorm = step_fn(
            params, opt_state, torch.from_numpy(b["tokens"]).to(device),
            torch.from_numpy(b["labels"]).to(device))
        losses.append(float(loss))
        if on_step is not None:
            on_step(i, losses[-1])
        if (i + 1) % log_every == 0:
            dt = (time.time() - t0) / (i + 1 - start)
            print(f"step {i+1:5d}  loss {float(loss):.4f}  gnorm "
                  f"{float(gnorm):.2f}  {dt*1e3:.0f} ms/step  (floor "
                  f"~{stream.entropy_floor():.2f})")
        if ckpt_dir and (i + 1) % 100 == 0:
            save_pytree(ckpt_dir, params, step=i + 1)
    if ckpt_dir:
        save_pytree(ckpt_dir, params, step=steps)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-3b", choices=list(cfg_lib.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each unit's activations in the backward")
    args = ap.parse_args(argv)
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   lr=args.lr, ckpt_dir=args.ckpt_dir, device=args.device,
                   remat=args.remat)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
