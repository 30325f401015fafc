"""Carry weights across from the JAX reference.

The port cannot replay ``jax.random``, so parity runs start from the
reference's own weights, exported with ``jax.tree.map(np.asarray, params)``
(a list of per-block dicts of numpy arrays). Conv weights go from the
reference's HWIO ``(3, 3, ci, co)`` to the port's OIHW; fc weights stay
``(K, N)``; biases are unchanged. A token model's block holds nested dicts
(``{"ln1": ..., "attn": {"wq": ...}}``), which the port keeps flat under
dotted keys (``"attn.wq"``); sorted, those keys give the reference's leaf
order.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device

NpParams = List[Dict[str, np.ndarray]]


def flatten(tree: Dict, prefix: str = "") -> Dict:
    """A nested dict as one dict with dotted keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Dict) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def params_from_numpy(model, np_params: NpParams, device="cuda"):
    """The reference's numpy params as the port's tensors on ``device``."""
    device = resolve_device(device)
    out = []
    for kind, layer in zip(model.block_kinds, np_params):
        d = {}
        for name, arr in flatten(layer).items():
            t = torch.tensor(np.asarray(arr, np.float32))
            if kind == "conv" and name == "w":
                t = t.permute(3, 2, 0, 1)                # HWIO -> OIHW
            d[name] = t.contiguous().to(device)
        out.append(d)
    return out


def params_to_numpy(model, params) -> NpParams:
    """The inverse of :func:`params_from_numpy`: numpy in the reference's
    layout and nesting."""
    out = []
    for kind, layer in zip(model.block_kinds, params):
        d = {}
        for name, t in layer.items():
            t = t.detach().cpu()
            if kind == "conv" and name == "w":
                t = t.permute(2, 3, 1, 0)                # OIHW -> HWIO
            d[name] = t.contiguous().numpy()
        out.append(_unflatten(d))
    return out
