"""Per-(arch x shape x mesh) step functions, abstract inputs and partition
specs (port of ``repro.launch.specs``).

``input_specs`` returns fake tensors for every model input: the shape and
dtype of each (the reference's ``ShapeDtypeStruct``s), no storage.
``build_case`` packages (step fn, fake args, partition specs) for the dry
run (:mod:`repro_torch.launch.dryrun`), which traces the step on them.

The inputs are fake CPU tensors of one ``FakeTensorMode`` (kept on the
case), not meta tensors: the kernel wrappers dispatch by device and refuse
meta, and on a CPU tensor, fake or not, they take their plain versions.
The reference's activation-sharding anchors (``acts_for``) and scan
``unroll`` are jax-only and have no counterpart: the port's units run in a
Python loop, so every unit and microbatch is traced as it runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as cfg_lib
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.train import value_and_grad
from repro_torch.models import model as model_lib
from repro_torch.models import params as params_lib
from repro_torch.models.convert import tree_map
from repro_torch.models.params import PSpec, _axis_size
from repro_torch.optim import adamw

ENC_LEN = 1024          # stubbed audio frontend frames (precomputed embeddings)
RING_FAMILIES = ("dense", "vlm", "moe", "audio")


def is_ring(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k on full-attention archs -> sliding-window ring cache."""
    return shape.name == "long_500k" and cfg.family in RING_FAMILIES


def cache_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    return cfg.window if is_ring(cfg, shape) else shape.seq_len


def rules_for(cfg: ArchConfig, shape: ShapeConfig, mesh,
              profile: str = "baseline") -> Dict[str, Any]:
    rules = params_lib.rules_for_mesh(mesh)
    if shape.mode == "decode" and shape.global_batch < _axis_size(mesh, rules["batch"]):
        # long_500k: batch=1 cannot use the batch axes; context-parallel the
        # cache sequence dim over 'data' instead (SSM/hybrid full caches).
        rules["batch"] = None
        rules["seq"] = None if is_ring(cfg, shape) else "data"
    if profile == "optimized" and shape.mode == "decode" and rules.get("seq") is None:
        # the reference's tuned decode layout: the cache sequence dim over
        # 'model' instead of head_dim
        rules["hd"] = None
        rules["seq"] = "model"
    return rules


def _batch_spec(cfg: ArchConfig, shape: ShapeConfig, mesh,
                rules) -> Dict[str, tuple]:
    b_ax = rules["batch"]
    specs = {"tokens": (b_ax, None)}
    if shape.mode == "train":
        specs["labels"] = (b_ax, None)
    if cfg.enc_layers:
        specs["enc_frames"] = (b_ax, None, None)
    return specs


def abstract_batch(cfg: ArchConfig, shape: ShapeConfig,
                   mode: Optional[FakeTensorMode] = None
                   ) -> Dict[str, torch.Tensor]:
    """Fake tensors of the batch's inputs: tokens (and labels) int32, the
    stubbed frontend's frame embeddings bf16."""
    b = shape.global_batch
    s = shape.seq_len if shape.mode != "decode" else 1
    with mode or FakeTensorMode():
        out = {"tokens": torch.empty((b, s), dtype=torch.int32)}
        if shape.mode == "train":
            out["labels"] = torch.empty((b, s), dtype=torch.int32)
        if cfg.enc_layers:
            # frames arrive as embeddings
            out["enc_frames"] = torch.empty((b, ENC_LEN, cfg.d_model),
                                            dtype=torch.bfloat16)
    return out


def abstract_tree(template, dtype, mode: FakeTensorMode):
    """Fake tensors of every PSpec of ``template`` (``dtype`` where a leaf
    names none)."""
    with mode:
        return tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype or dtype), template)


@dataclasses.dataclass
class Case:
    """One dry-run case: the step fn, its fake args, their partition specs
    and its outputs', and the fake mode the args belong to."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Any
    fake_mode: FakeTensorMode
    donate: Tuple[int, ...] = ()


def input_specs(arch: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """Public helper: fake-tensor stand-ins for every model input."""
    cfg = cfg_lib.get_config(arch)
    shape = cfg_lib.get_shape(shape_name)
    return abstract_batch(cfg, shape)


def build_case(arch: str, shape_name: str, mesh, *, dtype=torch.bfloat16,
               remat: bool = True, extra_rules: Optional[dict] = None,
               microbatch: int = 4,
               grad_acc_dtype=torch.float32,
               moment_dtype=torch.float32,
               moe_groups: Optional[int] = None,
               profile: str = "baseline") -> Case:
    """The step of ``arch`` x ``shape_name`` on ``mesh``'s shape, at full
    depth: the reference's ``n_layers`` and ``unroll`` (its shallow,
    unrolled compiles for cost analysis) have no counterpart, since the
    dry run traces and counts every unit and microbatch as it runs. The
    other keywords are the reference's: ``extra_rules`` update the
    sharding rules after :func:`rules_for`, ``moe_groups`` sets the MoE
    dispatch groups (the optimized profile's group choice applies only
    where it is None)."""
    cfg = cfg_lib.get_config(arch)
    shape = cfg_lib.get_shape(shape_name)
    if moe_groups and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=moe_groups))
    if profile == "optimized" and cfg.moe is not None:
        # shard-local (grouped) MoE dispatch
        groups = _axis_size(mesh, rules_for(cfg, shape, mesh)["batch"])
        if shape.mode != "decode" or shape.global_batch % max(groups, 1) == 0:
            if moe_groups is None and groups > 1:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, dispatch_groups=groups))
    rules = rules_for(cfg, shape, mesh, profile)
    if extra_rules:
        rules.update(extra_rules)
    mode = FakeTensorMode()

    template = model_lib.build_template(cfg)
    params_abs = abstract_tree(template, dtype, mode)
    params_specs = params_lib.partition_specs(template, mesh, rules)
    batch_abs = abstract_batch(cfg, shape, mode)
    batch_specs = _batch_spec(cfg, shape, mesh, rules)
    name = f"{arch}:{shape_name}"

    if shape.mode == "train":
        if profile == "optimized":
            moment_dtype = torch.bfloat16      # optimizer state halves
        opt = adamw(1e-4, weight_decay=0.1, moment_dtype=moment_dtype)
        with mode:
            opt_abs = opt.init(params_abs)
        opt_specs = {"step": (), "m": params_specs, "v": params_specs}

        # gradient accumulation: activations live for one microbatch only
        n_micro = max(1, microbatch)
        if shape.global_batch % n_micro:
            raise ValueError(f"batch {shape.global_batch} does not split "
                             f"into {n_micro} microbatches")

        def loss_of(p, b):
            return model_lib.loss_fn(p, b, cfg, remat=remat)

        def train_step(params, opt_state, batch):
            if n_micro == 1:
                loss, grads = value_and_grad(lambda p: loss_of(p, batch),
                                             params)
            else:
                # microbatch i takes rows i, i + n_micro, ... (the
                # reference's reshape and swapaxes)
                mb = {k: t.reshape(t.shape[0] // n_micro, n_micro,
                                   *t.shape[1:]).swapaxes(0, 1)
                      for k, t in batch.items()}
                loss = torch.zeros((), dtype=torch.float32)
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=grad_acc_dtype), params)
                for i in range(n_micro):
                    b_i = {k: t[i] for k, t in mb.items()}
                    loss_i, g_i = value_and_grad(lambda p: loss_of(p, b_i),
                                                 params)
                    loss = loss + loss_i
                    grads = tree_map(lambda a, g: a + g.to(a.dtype), grads,
                                     g_i)
                loss = loss / n_micro
                grads = tree_map(lambda g: g / n_micro, grads)
            upd, opt_state = opt.update(grads, opt_state, params)
            params = tree_map(lambda p, u: (p + u).to(p.dtype), params, upd)
            return params, opt_state, loss

        return Case(name, train_step, (params_abs, opt_abs, batch_abs),
                    (params_specs, opt_specs, batch_specs),
                    (params_specs, opt_specs, ()), mode, donate=(0, 1))

    logits_spec = params_lib.partition_specs(
        PSpec((shape.global_batch, 1, cfg.vocab), ("batch", None, "vocab")),
        mesh, rules)

    if shape.mode == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            return model_lib.forward(params, batch, cfg)

        return Case(name, prefill, (params_abs, batch_abs),
                    (params_specs, batch_specs), logits_spec, mode)

    # decode
    clen = cache_len_for(cfg, shape)
    ring = is_ring(cfg, shape)
    cache_t = model_lib.cache_template(cfg, shape.global_batch, clen,
                                       enc_len=ENC_LEN if cfg.enc_layers else 0)
    cache_abs = abstract_tree(cache_t, dtype, mode)
    cache_specs = params_lib.partition_specs(cache_t, mesh, rules)
    pos_val = shape.seq_len - 1

    def decode_step(params, cache, tokens):
        return model_lib.serve_step(params, cache, tokens, pos_val, cfg,
                                    ring=ring)

    return Case(name, decode_step, (params_abs, cache_abs,
                                    batch_abs["tokens"]),
                (params_specs, cache_specs, batch_specs["tokens"]),
                (logits_spec, cache_specs), mode, donate=(1,))
