"""Numpy-backed tree checkpointing (port of ``repro.checkpoint.store``).

Flattens a tree (nested dicts, lists and tuples; dict keys sorted, as
``jax.tree`` orders them) to ``"/"``-joined, escaped key paths in a single
``.npz`` plus a JSON dtype manifest, and restores it exactly, bf16 leaves
included (stored as uint16 views, since numpy has no bfloat16). The file
names, key paths and manifests are the reference's, so a directory written
by either package reads in the other. Leaves go in as numpy arrays or torch
tensors and come back as CPU torch tensors.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _escape_segment(seg: str) -> str:
    """Escape the path separator inside one key segment, so dict keys that
    themselves contain ``/`` (e.g. ``{"a/b": ...}``) can never collide with
    genuine nesting (``{"a": {"b": ...}}``) in the flat ``.npz`` namespace."""
    return seg.replace("\\", "\\\\").replace("/", "\\/")


def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _paths_and_leaves(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    if tree is None:                       # an empty subtree, as in jax
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(_escape_segment(str(p)) for p in prefix), tree)]
    return [pair for k, child in kids
            for pair in _paths_and_leaves(child, prefix + (k,))]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``
    (an iterator)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(host array, whether it holds bf16 as uint16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), True
        return leaf.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
        return arr.view(np.uint16), True
    return arr, False


def atomic_write_bytes(fname: pathlib.Path, write_fn) -> None:
    """Write a file atomically: ``write_fn(file_object)`` fills a ``.tmp``
    sibling which is then ``os.replace``-d over ``fname``. Readers (e.g.
    ``Simulation.resume`` racing a background checkpoint writer) therefore
    only ever see absent or *complete* files, never partial ones."""
    tmp = fname.with_name(fname.name + ".tmp")
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, fname)


def save_pytree(path, tree, step: Optional[int] = None,
                keep_last: Optional[int] = None,
                prefix: str = "step") -> pathlib.Path:
    """Write ``tree`` under ``path``; with ``step``, as ``step_NNNNNNNN.npz``.

    ``keep_last`` rotates stepped checkpoints: after a successful write,
    only the ``keep_last`` newest ``step_*`` files (counting this one) are
    kept and older ones are deleted. The step just written is never
    deleted, even if the directory holds stale higher-numbered steps from
    an earlier, longer run.

    ``prefix`` names the file family (default ``"step"``); side-car trees
    use their own (e.g. ``engine_NNNNNNNN.npz``) so they never collide with
    the model params. Rotation only tracks the ``step`` family. Both the
    ``.npz`` and its dtype manifest are written atomically (tmp + rename).
    """
    if keep_last is not None and keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    fname = path / (f"{prefix}_{step:08d}.npz" if step is not None
                    else "ckpt.npz")
    arrays = {}
    meta = {}
    for key, leaf in _paths_and_leaves(tree):
        if key in arrays:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        arrays[key], bf16 = _to_numpy(leaf)
        if bf16:
            meta[key] = "bfloat16"
    atomic_write_bytes(fname, lambda f: np.savez(f, **arrays))
    atomic_write_bytes(fname.with_suffix(".json"),
                       lambda f: f.write(json.dumps(meta).encode()))
    if step is not None and keep_last is not None and prefix == "step":
        gc_steps(path, keep_last, protect=step)
    return fname


def all_steps(path) -> list:
    """Sorted step numbers of every ``step_*.npz`` under ``path``."""
    path = pathlib.Path(path)
    if not path.exists():
        return []
    return sorted(int(m.group(1)) for f in path.glob("step_*.npz")
                  if (m := re.match(r"step_(\d+)\.npz", f.name)))


def gc_steps(path, keep_last: int, protect: Optional[int] = None) -> list:
    """Delete all but the ``keep_last`` newest ``step_*`` checkpoint pairs
    under ``path`` (and never ``protect``); returns the deleted steps."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    path = pathlib.Path(path)
    dropped = [s for s in all_steps(path)[:-keep_last] if s != protect]
    for s in dropped:
        (path / f"step_{s:08d}.npz").unlink(missing_ok=True)
        (path / f"step_{s:08d}.json").unlink(missing_ok=True)
    return dropped


def load_pytree(fname, like) -> Any:
    """The tree saved in ``fname``, shaped like ``like`` (whose leaves only
    name the keys to read), as CPU torch tensors in the saved dtypes."""
    fname = pathlib.Path(fname)
    meta = json.loads(fname.with_suffix(".json").read_text())
    leaves = []
    with np.load(fname) as data:
        for key, _ in _paths_and_leaves(like):
            arr = data[key]
            if meta.get(key) == "bfloat16":
                leaves.append(torch.from_numpy(arr.view(np.int16))
                              .view(torch.bfloat16))
            else:
                leaves.append(torch.from_numpy(arr))
    return _rebuild(like, iter(leaves))


def latest_step(path) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None
