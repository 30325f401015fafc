"""Model-agnostic split-training interface (port of
``repro.models.split_model``).

The paper's DNN-partition mechanism is model-agnostic: a device trains the
bottom ``l`` blocks, its gateway the top. Every engine sees only a
:class:`SplitModel` handle:

* a **hashable, frozen** description of one model;
* ``init`` produces ``params`` as a *list of per-block dicts* aligned with
  ``block_kinds``, so a partition point ``l`` splits ``params[:l]`` /
  ``params[l:]`` and ``forward_range(lo, hi)`` runs blocks [lo, hi);
* losses (masked + unmasked), ``accuracy``, valid partition points and the
  per-block :class:`~repro_torch.core.costmodel.LayerCost` profile the DDSRA
  partition search prices.

Blocks run slot-batched (``apply_block`` and the ``*_slots`` methods take
x ``(S, B, ...)``, each weight shared or per slot, see
``repro_torch.models.vgg``); ``forward_range``/``forward`` are the
single-model forms. This slice has the layer-list families (VGG-11, MLP);
the token families come with the token zoo.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel as cm
from repro_torch.models import vgg

Params = List[Dict[str, torch.Tensor]]


class SplitModel:
    """Base contract. Subclasses are frozen dataclasses (hashable)."""

    input_kind: str = "image"   # "image" -> float batches
    min_cut: int = 0            # smallest valid partition point

    # -- structure ---------------------------------------------------------

    @property
    def block_kinds(self) -> Tuple[str, ...]:
        raise NotImplementedError

    @property
    def n_blocks(self) -> int:
        return len(self.block_kinds)

    @property
    def valid_cuts(self) -> Tuple[int, ...]:
        """Partition points ``l``: device trains blocks [0, l)."""
        return tuple(range(self.min_cut, self.n_blocks + 1))

    # -- params / forward --------------------------------------------------

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        raise NotImplementedError

    def apply_block(self, i: int, p: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
        """Block ``i`` on slot-batched x (S, B, ...)."""
        raise NotImplementedError

    def forward_range_slots(self, params: Params, x: torch.Tensor,
                            lo: int, hi: int) -> torch.Tensor:
        for i in range(lo, hi):
            x = self.apply_block(i, params[i], x)
        return x

    def forward_slots(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.forward_range_slots(params, x, 0, self.n_blocks)

    def forward_range(self, params: Params, x: torch.Tensor,
                      lo: int, hi: int) -> torch.Tensor:
        """Blocks [lo, hi) of one model on x (B, ...)."""
        return self.forward_range_slots(params, x[None], lo, hi)[0]

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.forward_range(params, x, 0, self.n_blocks)

    def prepare_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Reshape packed batches (lead-2 axes = slots, width) for block 0."""
        return x

    # -- losses / eval -----------------------------------------------------

    def loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def masked_loss(self, logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """Per-sample mask over a padded batch; equals ``loss`` when all 1."""
        raise NotImplementedError

    @property
    def init_loss(self) -> float:
        """Loss of the uniform predictor (pre-training telemetry value)."""
        return math.log(self.classes)

    @torch.no_grad()
    def accuracy(self, params: Params, x, labels, batch: int = 256) -> float:
        """Test accuracy in ``batch``-row chunks on the params' device."""
        device = next(v for p in params for v in p.values()).device
        hits, n = 0, 0
        for i in range(0, len(x), batch):
            xb = torch.as_tensor(np.asarray(x[i:i + batch]), device=device)
            yb = torch.as_tensor(np.asarray(labels[i:i + batch]),
                                 device=device)
            logits = self.forward(params, xb)
            hits += int((logits.argmax(-1) == yb).sum())
            n += int(yb.numel())
        return hits / max(n, 1)

    # -- cost profile ------------------------------------------------------

    def layer_costs(self) -> List[cm.LayerCost]:
        raise NotImplementedError


class _LayerListModel(SplitModel):
    """Shared plumbing for the ``(plan, params)`` layer-list models."""

    def apply_block(self, i, p, x):
        return vgg._apply_layer(self.block_kinds[i], p, x)

    def loss(self, logits, labels):
        return vgg.xent_loss(logits, labels)

    def masked_loss(self, logits, labels, mask):
        return vgg.masked_xent_loss(logits, labels, mask)


_VGG_PLAN: Tuple[str, ...] = tuple(
    "pool" if item == "M" else "conv" for item in cm.VGG11_PLAN
) + ("fc", "fc", "fc_last")


@dataclasses.dataclass(frozen=True)
class VGGSplitModel(_LayerListModel):
    width_mult: float = 1.0
    classes: int = 10
    image: int = 32

    @property
    def block_kinds(self):
        return _VGG_PLAN

    def init(self, generator, device="cuda"):
        plan, params = vgg.init_vgg11(generator, self.width_mult,
                                      self.classes, self.image, device)
        assert plan == self.block_kinds
        return params

    def layer_costs(self):
        return cm.vgg11_layers(self.width_mult, image=self.image,
                               classes=self.classes)


@dataclasses.dataclass(frozen=True)
class MLPSplitModel(_LayerListModel):
    sizes: Tuple[int, ...] = (3072, 128, 64, 10)

    @property
    def classes(self) -> int:
        return self.sizes[-1]

    @property
    def block_kinds(self):
        return ("fc",) * (len(self.sizes) - 2) + ("fc_last",)

    def prepare_inputs(self, x):
        # all-fc stack on image data: flatten the sample dims once up front
        # so packed (slots, width, H, W, C) batches hit block 0 as features.
        return x.reshape(x.shape[0], x.shape[1], -1) if x.dim() > 3 else x

    def init(self, generator, device="cuda"):
        _, params = vgg.init_mlp(generator, self.sizes, device)
        return params

    def layer_costs(self):
        return vgg.mlp_layer_costs(self.sizes)
