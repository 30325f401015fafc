"""Layer-level memory-usage and FLOPs model (paper Table II + extensions).

The paper derives universal per-layer formulas for conv / pooling / fully-
connected layers from the backpropagation algorithm. ``o_l`` / ``o_l'`` are
the forward / backward FLOPs *per sample point*; ``g_l`` is the memory for
weights + forward outputs + backward errors (+ gradients) at training batch
size ``B_s``.

The paper's formulas are kept verbatim for its own VGG-11 experiment. This
is the PyTorch port's own copy of ``repro.core.costmodel`` (numpy only); the
token-zoo layer entries (attention, FFN, SSM) come with the token models.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np



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
