"""Model registries (port of ``repro.models.registry``).

* arch-id -> (template, init, forward, loss, serve step, cache
  template) bundle for the LLM stack (:func:`get_bundle`);
* FL split-model registry: name -> builder producing the ``(SplitModel,
  params, layer costs)`` triple the FL simulation consumes (``vgg``,
  ``mlp``, ``transformer``, ``moe`` and ``ssm``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs as cfg_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models import params as params_lib


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    build_template: Callable[[], Any]
    init: Callable[..., Any]          # generator[, dtype] -> params
    forward: Callable[..., torch.Tensor]
    loss_fn: Callable[..., torch.Tensor]
    serve_step: Callable[..., Any]
    cache_template: Callable[..., Any]

    def abstract_params(self, dtype=torch.bfloat16):
        return params_lib.abstract_params(self.build_template(), dtype)


def bundle_for(cfg: ArchConfig) -> ModelBundle:
    """The bundle of ``cfg``; ``init(generator, dtype=float32)`` draws the
    params on the generator's device."""
    template = model_lib.build_template(cfg)
    return ModelBundle(
        cfg=cfg,
        build_template=lambda: template,
        init=lambda generator, dtype=torch.float32: params_lib.init_params(
            generator, template, dtype),
        forward=lambda p, b, **kw: model_lib.forward(p, b, cfg, **kw),
        loss_fn=lambda p, b, **kw: model_lib.loss_fn(p, b, cfg, **kw),
        serve_step=lambda p, c, t, pos, **kw: model_lib.serve_step(
            p, c, t, pos, cfg, **kw),
        cache_template=lambda batch, cache_len, enc_len=0:
            model_lib.cache_template(cfg, batch, cache_len, enc_len),
    )


def get_bundle(arch: str, smoke: bool = False) -> ModelBundle:
    cfg = cfg_lib.get_smoke_config(arch) if smoke else cfg_lib.get_config(arch)
    return bundle_for(cfg)


def demo_batch(cfg: ArchConfig, batch: int, seq: int,
               generator: Optional[torch.Generator] = None,
               enc_len: int = 64, device="cuda") -> Dict[str, torch.Tensor]:
    """Random tokens and labels (B, S) int32 [+ enc_frames (B, enc_len, D)
    f32 for audio], drawn from ``generator`` (default: a CPU generator
    seeded 0) in that order and moved to ``device``. The draws are not
    jax's: parity runs carry the reference's batch across."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    out = {name: torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                               device=g.device, dtype=torch.int32)
           for name in ("tokens", "labels")}
    if cfg.enc_layers:
        out["enc_frames"] = torch.randn(batch, enc_len, cfg.d_model,
                                        generator=g, device=g.device)
    return {k: v.to(device) for k, v in out.items()}


# ---------------------------------------------------------------------------
# FL split-model registry
# ---------------------------------------------------------------------------

# name -> builder(generator, spec, device) -> (SplitModel, params, costs).
# ``spec`` is any object exposing the scenario fields the builder needs
# (width_mult, classes, mlp_hidden, ...) — typically
# ``repro_torch.fl.sim.Scenario``.
FL_MODELS: Dict[str, Callable[..., Tuple[Any, Any, Any]]] = {}


def register_fl_model(name: str):
    """Decorator registering an FL split-model builder; duplicates raise."""
    def deco(fn):
        if name in FL_MODELS:
            raise ValueError(f"FL model {name!r} already registered")
        FL_MODELS[name] = fn
        return fn
    return deco


def build_fl_model(name: str, generator: torch.Generator, spec,
                   device="cuda") -> Tuple[Any, Any, Any]:
    """Resolve + build ``name`` -> (SplitModel, params, layer costs)."""
    if name not in FL_MODELS:
        raise KeyError(f"unknown FL model {name!r}; "
                       f"known: {sorted(FL_MODELS)}")
    return FL_MODELS[name](generator, spec, device)


@register_fl_model("vgg")
def _build_vgg(generator, spec, device):
    from repro_torch.models import split_model as sm
    model = sm.VGGSplitModel(width_mult=spec.width_mult, classes=spec.classes)
    return model, model.init(generator, device), model.layer_costs()


@register_fl_model("mlp")
def _build_mlp(generator, spec, device):
    from repro_torch.models import split_model as sm
    sizes = (3072, *getattr(spec, "mlp_hidden", (128, 64)), spec.classes)
    model = sm.MLPSplitModel(sizes=sizes)
    return model, model.init(generator, device), model.layer_costs()


@register_fl_model("transformer")
def _build_transformer(generator, spec, device):
    from repro_torch.models import split_model as sm
    model = sm.SeqSplitModel(sm.FL_TRANSFORMER,
                             seq_len=getattr(spec, "seq_len", 32))
    return model, model.init(generator, device), model.layer_costs()


@register_fl_model("moe")
def _build_moe(generator, spec, device):
    from repro_torch.models import split_model as sm
    model = sm.SeqSplitModel(sm.FL_MOE, seq_len=getattr(spec, "seq_len", 32))
    return model, model.init(generator, device), model.layer_costs()


@register_fl_model("ssm")
def _build_ssm(generator, spec, device):
    from repro_torch.models import split_model as sm
    model = sm.SeqSplitModel(sm.FL_SSM, seq_len=getattr(spec, "seq_len", 32))
    return model, model.init(generator, device), model.layer_costs()
