"""Save and restore nested NamedTuples, tuples, lists and dicts of tensors.

``save_checkpoint(path, tree)`` writes the files the JAX package writes:
``path.npz`` with one array a leaf (``leaf_00000``, …, in JAX's flattening
order: sequences in order, dict keys sorted) and ``path.json`` with each
leaf's key path, the structure and the caller's metadata.  Loading reads
no pickle.  A leaf is a tensor, a numpy array or a Python number; any
other value (``FLState.layout``, ``None``) is part of the structure: it is
not saved, and a restore takes it from ``like``.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

_SCALARS = (bool, int, float, np.generic)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray) + _SCALARS)


def _children(tree):
    """``[(key, child), ...]`` of a container, ``None`` for anything
    else."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return None


def _leaves(tree, prefix: str = "") -> list:
    """``[(key path, leaf), ...]`` in flattening order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    kids = _children(tree)
    if kids is None:
        return []
    return [kv for key, child in kids for kv in _leaves(child, prefix + key)]


def _structure(tree) -> str:
    if _is_leaf(tree):
        return "*"
    kids = _children(tree)
    if kids is None:
        return type(tree).__name__
    inner = ", ".join(f"{k}={_structure(c)}" for k, c in kids)
    return f"{type(tree).__name__}({inner})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any,
                    metadata: dict | None = None) -> None:
    """Write ``path.npz`` (the leaves) and ``path.json`` (key paths,
    structure, metadata)."""
    leaves = _leaves(tree)
    arrays = {f"leaf_{i:05d}": _to_numpy(leaf)
              for i, (_, leaf) in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"keys": [k.replace("/", "_") for k, _ in leaves],
                   "structure": _structure(tree),
                   "metadata": metadata or {}}, f)


def _restore(like, it):
    if _is_leaf(like):
        arr = next(it)
        if isinstance(like, torch.Tensor):
            return torch.as_tensor(arr).to(
                device=like.device, dtype=like.dtype)
        if isinstance(like, np.ndarray):
            return arr.astype(like.dtype)
        return type(like)(arr.item())
    kids = _children(like)
    if kids is None:
        return like
    values = [_restore(c, it) for _, c in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*values)
    if isinstance(like, (tuple, list)):
        return type(like)(values)
    return dict(zip(sorted(like), values))


def load_checkpoint(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure, dtypes and devices of ``like``; returns
    ``(tree, metadata)``.  A leaf count other than ``like``'s raises."""
    with open(path + ".json") as f:
        meta = json.load(f)
    n = len(meta["keys"])
    expected = len(_leaves(like))
    if expected != n:
        raise ValueError(f"checkpoint has {n} leaves; target structure "
                         f"expects {expected}")
    with np.load(path + ".npz", allow_pickle=False) as data:
        arrays = [data[f"leaf_{i:05d}"] for i in range(n)]
    return _restore(like, iter(arrays)), meta["metadata"]
