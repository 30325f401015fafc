"""Carry weights across from the JAX reference.

The port cannot replay ``jax.random``, so parity runs start from the
reference's own weights, exported with ``jax.tree.map(np.asarray, params)``
(a list of per-block dicts of numpy arrays). Conv weights go from the
reference's HWIO ``(3, 3, ci, co)`` to the port's OIHW; fc weights stay
``(K, N)``; biases are unchanged. A token model's block holds nested dicts
(``{"ln1": ..., "attn": {"wq": ...}}``), which the port keeps flat under
dotted keys (``"attn.wq"``); sorted, those keys give the reference's leaf
order.

The LM stack's params are nested dicts of the reference's own leaves, in
the same layout in both packages: :func:`tree_from_numpy` and
:func:`tree_to_numpy` carry them across whole. :func:`tree_map` and
:func:`tree_leaves` walk such trees in the reference's pytree order, dict
keys sorted at every level, for every module of the port that does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device

NpParams = List[Dict[str, np.ndarray]]


def tree_leaves(tree) -> List:
    """The leaves of a nested dict in pytree order: keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a nested dict and of same-structured
    ``rest``, called in pytree order: keys sorted."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def flatten(tree: Dict, prefix: str = "") -> Dict:
    """A nested dict as one dict with dotted keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Dict) -> Dict:
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
    layout and nesting, each array a host copy of its own (a later
    in-place change of ``params`` does not reach it)."""
    out = []
    for kind, layer in zip(model.block_kinds, params):
        d = {}
        for name, t in layer.items():
            t = t.detach()
            if kind == "conv" and name == "w":
                t = t.permute(2, 3, 1, 0)                # OIHW -> HWIO
            d[name] = t.to("cpu", memory_format=torch.contiguous_format,
                           copy=True).numpy()
        out.append(unflatten(d))
    return out


def tree_from_numpy(np_tree, device="cuda"):
    """A nested dict of numpy arrays (the reference's LM params, exported
    with ``jax.tree.map(np.asarray, params)``) as tensors on ``device``,
    in the arrays' own dtypes."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    np_tree)


def tree_to_numpy(tree) -> Any:
    """The inverse of :func:`tree_from_numpy`: each tensor a host numpy
    copy of its own."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def pipeline_params_from_numpy(np_params, device="cuda"):
    """The reference's two-stage pipeline demo weights (``build_demo``'s
    ``{"w": (2, L/2, W, W), "b": (2, L/2, W)}``, exported with
    ``jax.tree.map(np.asarray, params)``) as f32 tensors on ``device``,
    in the same stacked layout (``repro_torch.launch.pipeline``)."""
    w, b = np.asarray(np_params["w"]), np.asarray(np_params["b"])
    if (set(np_params) != {"w", "b"} or w.ndim != 4 or w.shape[0] != 2
            or w.shape[2] != w.shape[3] or b.shape != w.shape[:3]):
        raise ValueError(f"not a 2-stage demo: w {w.shape}, b {b.shape}, "
                         f"keys {sorted(np_params)}")
    return tree_from_numpy({"w": w.astype(np.float32),
                            "b": b.astype(np.float32)}, device)
