"""Checkpoint / resume: serialize a state tree to a single .npz.

Port of ``pop_up_slam_tpu/utils/checkpoint.py``.  The reference flattens
with ``jax.tree``; the port has its own flatten over the trees its
runners keep: NamedTuples (leaves in field order), dicts (leaves in
sorted key order), lists and tuples (in order), and tensor, numpy or
scalar leaves.  A port snapshot round-trips in the port only: its leaf
order is not the reference's, so neither package reads the other's
files.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _flatten(tree) -> list:
    """The leaves of ``tree``, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    """A tree shaped as ``like`` over the leaves iterator ``leaves``."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(x: np.ndarray, like):
    """``x`` as the type, dtype and device of the leaf ``like``: a tensor
    or an array."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x, dtype=like.dtype).to(like.device)
    return x.astype(np.asarray(like).dtype)


def save_state(path: str, state, meta: dict | None = None) -> None:
    """Snapshot a state tree to ``path`` (.npz).  ``meta`` is any
    JSON-able dict stored alongside (e.g. frame index, config name)."""
    arrays = {f"leaf_{i}": _as_numpy(x)
              for i, x in enumerate(_flatten(state))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Restore a snapshot.  ``like`` provides the tree structure and each
    leaf's type, dtype and device (e.g. a freshly initialized state of
    the same config); the shapes are the snapshot's.

    Returns (state, meta)."""
    with np.load(path) as data:
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else {})
        leaves = _flatten(like)
        new = [_like(data[f"leaf_{i}"], x) for i, x in enumerate(leaves)]
    return _unflatten(like, iter(new)), meta
