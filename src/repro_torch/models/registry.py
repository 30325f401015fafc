"""FL split-model registry: name -> builder producing the ``(SplitModel,
params, layer costs)`` triple the FL simulation consumes (port of the FL
half of ``repro.models.registry``: ``vgg``, ``mlp``, ``transformer``,
``moe`` and ``ssm``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

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
