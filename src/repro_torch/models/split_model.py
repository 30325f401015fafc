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
single-model forms. Families: the layer-list models (VGG-11, MLP) and
:class:`SeqSplitModel` over a decoder-only ``ArchConfig`` (the FL
transformer and the FL Mamba-2; a MoE FFN is not ported yet).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.core import costmodel as cm
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as model_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import vgg
from repro_torch.models.convert import flatten
from repro_torch.models.layers import rms_norm, slot_bcast, slot_mm
from repro_torch.models.params import init_params

Params = List[Dict[str, torch.Tensor]]


class SplitModel:
    """Base contract. Subclasses are frozen dataclasses (hashable)."""

    input_kind: str = "image"   # "image" -> float batches, "tokens" -> int
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


# ---------------------------------------------------------------------------
# sequence families — blocks are arch_layers entries
# ---------------------------------------------------------------------------


def _seq_blocks(cfg: ArchConfig) -> Tuple[Tuple[str, int], ...]:
    """(kind, layer_idx) per block, 1:1 with ``costmodel.arch_layers``."""
    blocks: List[Tuple[str, int]] = [("embed", -1)]
    for i in range(cfg.n_layers):
        blocks.append(("attn" if cfg.kind(i) == "A" else "ssm", i))
        if cfg.d_ff:
            blocks.append(("ffn", i))
    blocks.append(("head", -1))
    return tuple(blocks)


def _sub(p: Dict[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    """The ``name.*`` entries of a block, under their reference keys."""
    pre = name + "."
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


@dataclasses.dataclass(frozen=True)
class SeqSplitModel(SplitModel):
    """Token split model over a decoder-only ``ArchConfig``.

    The embedding block stays device-side (``min_cut=1``): tokens are
    integers, so no gradient can cross the cut below the embedding. A
    block's params are the reference's nested dict flattened to dotted
    keys (``"attn.wq"``), so the engine's flat per-block dicts hold them
    and sorted keys keep the reference's leaf order.
    """

    cfg: ArchConfig
    seq_len: int = 32

    input_kind = "tokens"
    min_cut = 1

    def __post_init__(self):
        if self.cfg.enc_layers:
            raise ValueError("split models are decoder-only")
        if self.cfg.tie_embeddings:
            raise ValueError("tied embeddings couple the embed and head "
                             "blocks across the cut")

    @property
    def classes(self) -> int:
        return self.cfg.vocab

    @property
    def block_kinds(self):
        return tuple(kind for kind, _ in _seq_blocks(self.cfg))

    def init(self, generator, device="cuda"):
        device = resolve_device(device)
        cfg = self.cfg
        full = init_params(generator, model_lib.build_template(cfg))
        pat = model_lib.pattern_of(cfg)
        blocks = []
        for kind, li in _seq_blocks(cfg):
            if kind == "embed":
                block = {"embed": full["embed"]}
            elif kind == "head":
                block = {"final_norm": full["final_norm"],
                         "unembed": full["unembed"]}
            else:
                u, j = divmod(li, len(pat))
                sub = full["blocks"][f"s{j}"]
                keys = {"ffn": ("ln2", "ffn"), "attn": ("ln1", "attn"),
                        "ssm": ("ln1", "mamba")}[kind]
                block = flatten({k: sub[k] for k in keys})
                block = {k: v[u] for k, v in block.items()}
            blocks.append({k: v.contiguous().to(device)
                           for k, v in block.items()})
        return blocks

    def forward_range(self, params, x, lo, hi):
        # one model: every weight becomes a single slot (a view)
        params = [p if p is None else {k: v[None] for k, v in p.items()}
                  for p in params]
        return self.forward_range_slots(params, x[None], lo, hi)[0]

    def apply_block(self, i, p, x):
        """Block ``i`` on slot-batched x: tokens (S, B, seq) for the
        embedding, activations (S, B, seq, D) after it."""
        cfg = self.cfg
        kind = self.block_kinds[i]
        if kind == "embed":
            emb = p["embed"]                                  # (S, V, D)
            slots = torch.arange(emb.shape[0], device=emb.device)
            return emb[slots.reshape(-1, *([1] * (x.dim() - 1))), x.long()]
        if kind == "head":
            h = rms_norm(x, slot_bcast(p["final_norm"], x.dim()),
                         cfg.norm_eps)
            return slot_mm(h, p["unembed"])
        if kind == "ffn":
            h = rms_norm(x, slot_bcast(p["ln2"], x.dim()), cfg.norm_eps)
            return x + model_lib._ffn_apply(h, _sub(p, "ffn"), cfg)
        h = rms_norm(x, slot_bcast(p["ln1"], x.dim()), cfg.norm_eps)
        if kind == "attn":
            return x + self._attention(h, _sub(p, "attn"))
        return x + ssm_lib.mamba_block(h, _sub(p, "mamba"), cfg)

    def _attention(self, h, p):
        cfg = self.cfg
        seq = h.shape[-2]
        positions = torch.arange(seq, device=h.device)
        q, k, v = model_lib._proj_qkv(h, p, cfg, positions)
        # slots x rows fold into the attention batch (a view)
        o = flash_ops.gqa_attention(q.flatten(0, 1), k.flatten(0, 1),
                                    v.flatten(0, 1), causal=True)
        return slot_mm(o.reshape(*h.shape[:-1], cfg.n_heads * cfg.hd),
                       p["wo"])

    def _token_ll(self, logits, labels):
        logp = F.log_softmax(logits.float(), dim=-1)
        return logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)

    def loss(self, logits, labels):
        """Mean token cross-entropy over (batch, seq); a leading slot axis
        gives one loss per slot."""
        return -self._token_ll(logits, labels).mean(dim=(-2, -1))

    def masked_loss(self, logits, labels, mask):
        # mask is per *sample* (one sequence); broadcast over the seq axis so
        # padded slots contribute an exact 0, matching the image contract.
        ll = self._token_ll(logits, labels)
        denom = mask.sum(dim=-1).clamp_min(1.0) * labels.shape[-1]
        return -torch.sum(ll * mask[..., None], dim=(-2, -1)) / denom

    def layer_costs(self):
        # arch_layers prices per *token*; the FL data unit is one sequence.
        per_tok = cm.arch_layers(self.cfg, self.seq_len, sf=4)
        return [dataclasses.replace(
            lc,
            flops_fwd=lc.flops_fwd * self.seq_len,
            flops_bwd=lc.flops_bwd * self.seq_len,
            mem_act_per_sample=lc.mem_act_per_sample * self.seq_len)
            for lc in per_tok]


# ---------------------------------------------------------------------------
# smoke-size FL token configs (registered in repro_torch.models.registry)
# ---------------------------------------------------------------------------

FL_TRANSFORMER = ArchConfig(
    name="fl-transformer", family="dense", n_layers=2, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=128, vocab=128,
    source="smoke-size GQA decoder for FL split training")

FL_SSM = ArchConfig(
    name="fl-ssm", family="ssm", n_layers=2, d_model=64,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=128,
    ssm=SSMConfig(d_state=16, d_conv=4, head_dim=32, expand=2, chunk_size=32),
    source="smoke-size Mamba-2 SSD decoder for FL split training")
