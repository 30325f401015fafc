"""Batched decode/serving driver (port of ``repro.launch.serve``):
prefill-free cache warmup + greedy decode, the same code path on the CPU
(reduced configs) as on the card (full configs).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b

The prompt is the reference's draw, bit for bit; the params (and the
encoder frames of the encoder-decoder arch) are drawn from torch
generators, so they differ from the reference's for a seed: parity runs
hand :func:`greedy_decode` the reference's instead.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import configs as cfg_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, use_f32_numerics
from repro_torch.models import get_bundle
from repro_torch.models import model as model_lib
from repro_torch.models import params as params_lib

# the encoder length the reference's driver fixes
ENC_LEN = 16


@torch.no_grad()
def greedy_decode(cfg: ArchConfig, params: Dict[str, Any],
                  cache: Dict[str, Any], prompt: np.ndarray, gen: int, *,
                  enc_frames: Optional[torch.Tensor] = None,
                  ring: bool = False,
                  on_step: Optional[Callable[[int, torch.Tensor],
                                             None]] = None) -> np.ndarray:
    """Feed ``prompt`` (B, P) token by token, then ``gen`` greedy
    (argmax) tokens -> the generated (B, gen) int32.

    ``params`` and ``cache`` (a zeroed :func:`model_lib.cache_template`,
    written in place) live on one device; ``enc_frames`` (B, T, D) fill
    the cross cache first where the arch has an encoder.
    ``on_step(i, logits)`` runs after step ``i`` (0-based, prompt steps
    first) with its logits (B, 1, V), before anything is read back."""
    device = params["embed"].device
    if cfg.enc_layers:
        enc_out = model_lib.encode_for_decode(params, enc_frames, cfg)
        model_lib.fill_cross_cache(params, cache, enc_out, cfg)
    prompt_t = torch.from_numpy(np.asarray(prompt, np.int32)).to(device)
    prompt_len = prompt_t.shape[1]
    logits, generated = None, []
    for i in range(prompt_len + gen):
        if i < prompt_len:
            tok = prompt_t[:, i:i + 1]
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            generated.append(tok)
        logits, cache = model_lib.serve_step(params, cache, tok, i, cfg,
                                             ring=ring)
        if on_step is not None:
            on_step(i, logits)
    if not generated:
        return np.zeros((prompt_t.shape[0], 0), np.int32)
    return torch.cat(generated, dim=1).cpu().numpy()


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          cache_len: int = 128, seed: int = 0, ring: bool = False,
          device="cuda",
          on_step: Optional[Callable[[int, torch.Tensor], None]] = None
          ) -> np.ndarray:
    """Serve ``batch`` random prompts of ``arch`` from random params;
    returns the generated (batch, gen) int32 tokens. ``on_step`` as in
    :func:`greedy_decode`."""
    device = resolve_device(device)
    if device.type == "cuda":
        use_f32_numerics()
    bundle = get_bundle(arch, smoke=smoke)
    cfg = bundle.cfg
    params = bundle.init(torch.Generator(device=device).manual_seed(seed))
    cache = params_lib.init_params(
        torch.Generator(device=device).manual_seed(1),
        bundle.cache_template(batch, cache_len, enc_len=ENC_LEN))
    enc = None
    if cfg.enc_layers:
        enc = torch.randn(batch, ENC_LEN, cfg.d_model, device=device,
                          generator=torch.Generator(
                              device=device).manual_seed(2))
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    t0 = time.time()
    out = greedy_decode(cfg, params, cache, prompt, gen, enc_frames=enc,
                        ring=ring, on_step=on_step)
    dt = time.time() - t0
    tput = batch * (prompt_len + gen) / dt
    print(f"{arch}: served {batch} seqs, {prompt_len}+{gen} tokens each, "
          f"{tput:.1f} tok/s ({dt:.1f}s total)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-2.7b",
                    choices=list(cfg_lib.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve(args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
          ring=args.ring, device=args.device)


if __name__ == "__main__":
    main()
