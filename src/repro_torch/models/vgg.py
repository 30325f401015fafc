"""VGG-11 (the paper's experiment DNN) + MLP, as *layer lists* so the DNN
partition point indexes the same layer sequence as the Table II cost model.

The port of ``repro.models.vgg``. A model is a pair ``(plan, params)``:
``plan`` is a tuple of layer kinds, ``params`` a matching list of dicts of
tensors (empty dict for parameterless layers). Layouts follow the reference
at the public functions: images are NHWC and fc weights ``(K, N)``; conv
weights are stored OIHW for ``F.conv2d`` (``repro_torch.models.convert``
maps them to and from the reference's HWIO).

Every layer runs **slot-batched**: activations carry a leading slot axis
``(S, B, ...)`` and each weight is either shared by all slots (its plain
shape) or per slot (a leading ``S`` axis) — the cohort engine trains S
device models in one pass. ``forward_range``/``forward`` keep the
reference's single-model signature (x ``(B, ...)``) on top of that.
Convs and pools are PyTorch's (``F.conv2d``, ``F.max_pool2d``), as the
reference leaves them to XLA; every fc layer goes through the hand-written
fused linear kernels (``repro_torch.kernels.fused_linear.ops.linear``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.costmodel import VGG11_PLAN, LayerCost, fc_layer
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_linear import ops as fused_ops

Plan = Tuple[str, ...]
Params = List[Dict[str, torch.Tensor]]


def init_vgg11(generator: torch.Generator, width_mult: float = 1.0,
               classes: int = 10, image: int = 32,
               device="cuda") -> Tuple[Plan, Params]:
    """He-normal VGG-11 drawn from ``generator`` (a CPU generator, so a seed
    gives the same weights on every device), then moved to ``device``."""
    device = resolve_device(device)
    plan: List[str] = []
    params: Params = []
    ci, hw = 3, image
    for item in VGG11_PLAN:
        if item == "M":
            plan.append("pool")
            params.append({})
            hw //= 2
        else:
            co = max(1, int(item * width_mult))
            scale = math.sqrt(2.0 / (ci * 9))
            plan.append("conv")
            params.append({
                "w": torch.randn((co, ci, 3, 3), generator=generator) * scale,
                "b": torch.zeros((co,)),
            })
            ci = co
    feat = ci * hw * hw
    fc1 = max(16, int(4096 * width_mult))
    dims = [(feat, fc1), (fc1, fc1), (fc1, classes)]
    for i, (si, so) in enumerate(dims):
        plan.append("fc_last" if i == len(dims) - 1 else "fc")
        params.append({
            "w": torch.randn((si, so), generator=generator)
            * math.sqrt(2.0 / si),
            "b": torch.zeros((so,)),
        })
    return tuple(plan), _to(params, device)


def init_mlp(generator: torch.Generator, sizes=(3072, 128, 64, 10),
             device="cuda") -> Tuple[Plan, Params]:
    device = resolve_device(device)
    plan: List[str] = []
    params: Params = []
    for i, (si, so) in enumerate(zip(sizes[:-1], sizes[1:])):
        plan.append("fc_last" if i == len(sizes) - 2 else "fc")
        params.append({
            "w": torch.randn((si, so), generator=generator)
            * math.sqrt(2.0 / si),
            "b": torch.zeros((so,)),
        })
    return tuple(plan), _to(params, device)


def _to(params: Params, device) -> Params:
    return [{k: v.to(device) for k, v in p.items()} for p in params]


def mlp_layer_costs(sizes=(3072, 128, 64, 10), sf: int = 4) -> List[LayerCost]:
    return [fc_layer(f"fc{i}", si, so, sf=sf)
            for i, (si, so) in enumerate(zip(sizes[:-1], sizes[1:]))]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3 SAME + b) on NHWC slots x (S, B, H, W, C)."""
    s, n, h, wd, c = x.shape
    if w.dim() == 4:
        # one weight for every slot: fold the slots into the batch; the
        # NCHW view of NHWC memory is channels-last, so no copy is made
        y = F.conv2d(x.reshape(s * n, h, wd, c).permute(0, 3, 1, 2), w, b,
                     padding=1)
        return F.relu(y).permute(0, 2, 3, 1).reshape(s, n, h, wd, -1)
    # a weight per slot: one grouped conv with the slots as groups
    co = w.shape[1]
    xg = x.permute(1, 0, 4, 2, 3).reshape(n, s * c, h, wd)
    y = F.conv2d(xg, w.reshape(s * co, c, 3, 3), b.reshape(s * co),
                 padding=1, groups=s)
    return F.relu(y).reshape(n, s, co, h, wd).permute(1, 0, 3, 4, 2)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool on NHWC slots x (S, B, H, W, C)."""
    s, n = x.shape[:2]
    y = F.max_pool2d(x.flatten(0, 1).permute(0, 3, 1, 2), 2)
    return y.permute(0, 2, 3, 1).unflatten(0, (s, n))


def _apply_layer(kind: str, layer: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """One layer on slot-batched x (S, B, ...)."""
    if kind == "conv":
        return _conv(x, layer["w"], layer["b"])
    if kind == "pool":
        return _pool(x)
    if kind in ("fc", "fc_last"):
        # flatten each sample in NHWC order, as the reference's reshape does
        x = x.reshape(x.shape[0], x.shape[1], -1)
        act = "none" if kind == "fc_last" else "relu"
        return fused_ops.linear(x, layer["w"], layer["b"], activation=act)
    raise ValueError(kind)


def forward_range_slots(plan: Plan, params: Params, x: torch.Tensor,
                        lo: int, hi: int) -> torch.Tensor:
    """Layers [lo, hi) on slot-batched x (S, B, ...)."""
    for kind, layer in zip(plan[lo:hi], params[lo:hi]):
        x = _apply_layer(kind, layer, x)
    return x


def forward_range(plan: Plan, params: Params, x: torch.Tensor,
                  lo: int, hi: int) -> torch.Tensor:
    """Layers [lo, hi) of one model on x (B, ...)."""
    return forward_range_slots(plan, params, x[None], lo, hi)[0]


def forward(plan: Plan, params: Params, x: torch.Tensor) -> torch.Tensor:
    return forward_range(plan, params, x, 0, len(plan))


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis (-2 of the logits); a leading
    slot axis gives one loss per slot."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -ll.mean(dim=-1)


def masked_xent_loss(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid (mask==1) rows of a padded batch.

    Equals ``xent_loss`` on the unpadded batch: padded rows contribute an
    exact 0 to the sum, so only summation length differs.
    """
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -torch.sum(mask * ll, dim=-1) / mask.sum(dim=-1).clamp_min(1.0)
