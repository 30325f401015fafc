"""Layer-level memory-usage and FLOPs model (paper Table II + extensions).

The paper derives universal per-layer formulas for conv / pooling / fully-
connected layers from the backpropagation algorithm. ``o_l`` / ``o_l'`` are
the forward / backward FLOPs *per sample point*; ``g_l`` is the memory for
weights + forward outputs + backward errors (+ gradients) at training batch
size ``B_s``.

The paper's formulas are kept verbatim for its own VGG-11 experiment. This
is the PyTorch port's own copy of ``repro.core.costmodel`` (numpy only),
with the token models' layer entries (attention, FFN, SSM).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class LayerCost:
    name: str
    kind: str
    flops_fwd: float          # o_l, per sample point
    flops_bwd: float          # o'_l, per sample point
    mem_weights: float        # bytes (incl. gradient buffers where Table II says so)
    mem_act_per_sample: float # bytes per sample (fwd outputs + bwd errors)
    sf: float = 4.0           # native precision, bytes/param (S_f in Table II)

    def flops(self) -> float:
        return self.flops_fwd + self.flops_bwd

    def mem(self, batch: int) -> float:
        return self.mem_weights + batch * self.mem_act_per_sample


# ---------------------------------------------------------------------------
# Table II entries (verbatim). S_f = precision bytes.
# ---------------------------------------------------------------------------


def conv_layer(name: str, ci: int, hi: int, wi: int, co: int,
               hf: int = 3, wf: int = 3, stride: int = 1, pad: int = 1,
               sf: int = 4) -> LayerCost:
    ho = (hi + 2 * pad - hf) // stride + 1
    wo = (wi + 2 * pad - wf) // stride + 1
    fwd = 2 * ci * hf * wf * co * ho * wo                       # B_s = 1
    err = 2 * (2 * wf + wf * wo - 2) * (2 * hf + hf * ho - 2)
    grad = 2 * ci * hf * wf * co * ho * wo
    weights = sf * ci * hf * wf * co
    acts = sf * (co * ho * wo + ci * hi * wi)                   # fwd out + bwd err
    return LayerCost(name, "conv", fwd, err + grad,
                     2 * weights,                               # weight + gradient
                     acts, sf=sf)


def pool_layer(name: str, ci: int, hi: int, wi: int, k: int = 2,
               sf: int = 4) -> LayerCost:
    ho, wo = hi // k, wi // k
    fwd = ci * hi * wi
    err = ci * hi * wi
    acts = sf * (ci * ho * wo + ci * hi * wi)
    return LayerCost(name, "pool", fwd, err, 0.0, acts, sf=sf)


def fc_layer(name: str, si: int, so: int, sf: int = 4) -> LayerCost:
    fwd = 2 * si * so
    bwd = 2 * si * so + si * so                                 # error + gradient
    weights = sf * si * so
    acts = sf * (so + si)
    return LayerCost(name, "fc", fwd, bwd, 2 * weights, acts, sf=sf)


# ---------------------------------------------------------------------------
# VGG-11 (the paper's experiment DNN), 32x32x3 inputs (SVHN / CIFAR-10)
# ---------------------------------------------------------------------------

VGG11_PLAN = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def vgg11_layers(width_mult: float = 1.0, sf: int = 4,
                 image: int = 32, classes: int = 10) -> List[LayerCost]:
    layers: List[LayerCost] = []
    ci, hw = 3, image
    idx = 0
    for item in VGG11_PLAN:
        if item == "M":
            layers.append(pool_layer(f"pool{idx}", ci, hw, hw, sf=sf))
            hw //= 2
        else:
            co = max(1, int(item * width_mult))
            layers.append(conv_layer(f"conv{idx}", ci, hw, hw, co, sf=sf))
            ci = co
            idx += 1
    feat = ci * hw * hw
    fc1 = max(16, int(4096 * width_mult))
    layers.append(fc_layer("fc0", feat, fc1, sf=sf))
    layers.append(fc_layer("fc1", fc1, fc1, sf=sf))
    layers.append(fc_layer("fc2", fc1, classes, sf=sf))
    return layers


# ---------------------------------------------------------------------------
# Extensions: per-layer costs for the token models
# (per token; sf bytes per element; seq enters attention's O(S) term)
# ---------------------------------------------------------------------------


def attention_layer(name: str, cfg: ArchConfig, seq: int, sf: int = 2) -> LayerCost:
    d, hd, nh, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * (nh * hd) + 2 * 2 * d * (kv * hd) + 2 * (nh * hd) * d
    scores = 2 * nh * hd * seq + 2 * nh * seq * hd             # QK^T + AV per token
    fwd = proj + scores
    weights = sf * (d * nh * hd + 2 * d * kv * hd + nh * hd * d)
    acts = sf * (4 * nh * hd + 2 * d)
    return LayerCost(name, "attention", fwd, 2 * fwd, 2 * weights, acts,
                     sf=sf)


def ffn_layer(name: str, cfg: ArchConfig, sf: int = 2) -> LayerCost:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.moe is not None:
        k, e = cfg.moe.top_k, cfg.moe.n_experts
        fwd = 2 * d * e + k * 3 * 2 * d * f                    # router + top-k experts
        weights = sf * (d * e + e * 3 * d * f)                 # ALL experts resident
        acts = sf * (k * (2 * f + d))
        return LayerCost(name, "moe_ffn", fwd, 2 * fwd, 2 * weights, acts,
                         sf=sf)
    fwd = 3 * 2 * d * f
    weights = sf * 3 * d * f
    acts = sf * (2 * f + d)
    return LayerCost(name, "ffn", fwd, 2 * fwd, 2 * weights, acts, sf=sf)


def ssm_layer(name: str, cfg: ArchConfig, sf: int = 2) -> LayerCost:
    s = cfg.ssm
    d = cfg.d_model
    d_in, n, p, ds = s.d_inner(d), s.n_heads(d), s.head_dim, s.d_state
    q = s.chunk_size
    proj = 2 * d * (2 * d_in + 2 * ds + n) + 2 * d_in * d
    conv = 2 * s.d_conv * (d_in + 2 * ds)
    # SSD per token: intra-chunk quadratic (O(q)) + state update (O(ds*p))
    ssd = 2 * q * ds + 2 * q * n * p + 4 * n * p * ds
    fwd = proj + conv + ssd
    weights = sf * (d * (2 * d_in + 2 * ds + n) + d_in * d
                    + s.d_conv * (d_in + 2 * ds))
    acts = sf * (4 * d_in + 4 * ds + 2 * n)
    return LayerCost(name, "ssm", fwd, 2 * fwd, 2 * weights, acts, sf=sf)


def arch_layers(cfg: ArchConfig, seq: int, sf: int = 2) -> List[LayerCost]:
    """Per-layer cost vector for a decoder stack."""
    out: List[LayerCost] = []
    emb = LayerCost("embed", "embed", 2 * cfg.d_model, 2 * cfg.d_model,
                    sf * cfg.vocab * cfg.d_model, sf * cfg.d_model, sf=sf)
    out.append(emb)
    for i in range(cfg.enc_layers):
        out.append(attention_layer(f"enc{i}.attn", cfg, seq, sf))
    for i in range(cfg.n_layers):
        if cfg.kind(i) == "A":
            out.append(attention_layer(f"l{i}.attn", cfg, seq, sf))
        else:
            out.append(ssm_layer(f"l{i}.ssm", cfg, sf))
        if cfg.d_ff:
            out.append(ffn_layer(f"l{i}.ffn", cfg, sf))
    head_w = 0 if cfg.tie_embeddings else sf * cfg.d_model * cfg.vocab
    out.append(LayerCost("unembed", "fc", 2 * cfg.d_model * cfg.vocab,
                         4 * cfg.d_model * cfg.vocab, 2 * head_w,
                         sf * cfg.vocab, sf=sf))
    return out


# ---------------------------------------------------------------------------
# aggregates used by the optimizer (paper Eqs. (1)-(5))
# ---------------------------------------------------------------------------


def flops_vector(layers: Sequence[LayerCost]) -> np.ndarray:
    """(o_l + o'_l) per layer."""
    return np.array([l.flops() for l in layers], float)


def mem_vector(layers: Sequence[LayerCost], batch: int) -> np.ndarray:
    """g_l per layer at training batch size."""
    return np.array([l.mem(batch) for l in layers], float)


def model_size_bytes(layers: Sequence[LayerCost]) -> float:
    """gamma: DNN model size transmitted between tiers (weights only)."""
    return float(sum(l.mem_weights / 2 for l in layers))  # /2: exclude grad buffer


def param_count(layers: Sequence[LayerCost]) -> float:
    """Transmitted parameter count: the weight bytes of each layer divided
    by its native precision ``sf`` (so mixed-precision stacks sum
    correctly). Uses the same weights-only convention as
    :func:`model_size_bytes`."""
    return float(sum(l.mem_weights / 2 / l.sf for l in layers))


def upload_bytes(layers: Sequence[LayerCost],
                 bits_per_param: Optional[float] = None) -> float:
    """gamma at a chosen upload compression level.

    ``bits_per_param=None`` prices the upload at each layer's native
    precision — exactly :func:`model_size_bytes`, the historical behavior.
    Otherwise every transmitted parameter costs ``bits_per_param/8`` bytes
    (e.g. 16 for a bf16 data plane, 8 for int8-quantized uploads), which
    scales the DDSRA uplink/downlink delay and transmit-energy terms
    linearly since they are all linear in gamma.
    """
    if bits_per_param is None:
        return model_size_bytes(layers)
    if bits_per_param <= 0:
        raise ValueError(f"bits_per_param must be positive, "
                         f"got {bits_per_param}")
    return param_count(layers) * float(bits_per_param) / 8.0


def train_time_split(flops: np.ndarray, l_split: int, k_iters: int, d_batch: int,
                     phi_dev: float, f_dev: float,
                     phi_gw: float, f_gw: float) -> float:
    """Eq. (1) inner term: bottom l_split layers on device, rest on gateway."""
    bottom = flops[:l_split].sum()
    top = flops[l_split:].sum()
    return k_iters * d_batch * (bottom / (phi_dev * f_dev) + top / (phi_gw * f_gw))


def train_energy_device(flops: np.ndarray, l_split: int, k_iters: int,
                        d_batch: int, v_eff: float, phi: float, f: float) -> float:
    """Eq. (2)."""
    return k_iters * d_batch * v_eff / phi * flops[:l_split].sum() * f ** 2


def train_energy_gateway(flops: np.ndarray, l_split: int, k_iters: int,
                         d_batch: int, v_eff: float, phi: float, f: float) -> float:
    """Eq. (3)."""
    return k_iters * d_batch * v_eff / phi * flops[l_split:].sum() * f ** 2
