"""LM training driver (port of ``repro.launch.train``): the same code path
on the CPU (reduced configs) as on the card (full configs).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --smoke --device cpu --steps 3 --batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --steps 3 --batch 1 --seq 4096

A step is the loss's value and gradient, the gradient clipped to a global
norm of 1.0, then AdamW (weight decay 0.01) on a cosine schedule with a
warmup of ``max(steps // 20, 5)`` steps, as the reference's.
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
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm
from repro_torch.optim import cosine_schedule
from repro_torch.optim.optimizers import apply_updates


def value_and_grad(loss_of: Callable, params):
    """(loss, grads shaped as ``params``) of ``loss_of(params)``; the params
    themselves stay outside autograd."""
    leaves = {k: v.detach().requires_grad_()
              for k, v in flatten(params).items()}
    loss = loss_of(unflatten(leaves))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), unflatten(dict(zip(leaves, grads)))


def make_step(cfg: ArchConfig, opt: Optimizer) -> Callable:
    """The training step ``(params, opt_state, tokens, labels) -> (params,
    opt_state, loss, gnorm)``."""
    def step_fn(params, opt_state, tokens, labels):
        batch_d = {"tokens": tokens, "labels": labels}
        if cfg.enc_layers:
            batch_d["enc_frames"] = torch.zeros(
                (tokens.shape[0], 16, cfg.d_model),
                dtype=params["final_norm"].dtype, device=tokens.device)
        loss, grads = value_and_grad(
            lambda p: model_lib.loss_fn(p, batch_d, cfg), params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        upd, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, upd), opt_state, loss, gnorm
    return step_fn


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          lr: float = 3e-4, ckpt_dir=None, log_every: int = 10,
          seed: int = 0, device="cuda",
          on_step: Optional[Callable[[int, float], None]] = None):
    """Train ``arch`` for ``steps`` steps on the Markov token stream;
    returns the losses. ``on_step(i, loss)`` runs after step ``i``
    (0-based) has ended on the device."""
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

    step_fn = make_step(cfg, opt)
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
    args = ap.parse_args(argv)
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   lr=args.lr, ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
