"""Checkpoint/resume for algorithm states.

Counterpart of ``essentials_tpu/utils/checkpoint.py``, in its file format:
an ``.npz`` of ``leaf_0`` ... ``leaf_{n-1}`` and a ``__meta__`` JSON with
``version`` 1, ``step``, ``n_leaves``, ``treedef`` and ``user``. A state is
flattened as the JAX package flattens a pytree: NamedTuples, tuples and lists
in order, dicts by sorted key, None as no leaf, anything else (a tensor, an
array, a Python number) as one leaf. So a checkpoint written by either
package loads in the other wherever the leaf counts agree.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_VERSION = 1


def _flatten(x, leaves: list):
    """Append x's leaves to ``leaves``; returns x's structure."""
    if x is None:
        return None
    if isinstance(x, dict):
        keys = sorted(x)
        return ("dict", keys, [_flatten(x[k], leaves) for k in keys])
    if isinstance(x, (tuple, list)):
        kind = type(x).__name__ if hasattr(x, "_fields") else (
            "tuple" if isinstance(x, tuple) else "list")
        return (kind, None, [_flatten(v, leaves) for v in x])
    leaves.append(x)
    return "*"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state, *, step: int = 0,
               meta: dict | None = None) -> None:
    """Save a state (its leaves copied to the host) and metadata to an .npz
    checkpoint."""
    leaves = []
    treedef = _flatten(state, leaves)
    arrays = {f"leaf_{i}": _host(l) for i, l in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(json.dumps({
        "version": _VERSION, "step": step, "n_leaves": len(leaves),
        "treedef": repr(treedef), "user": meta or {},
    }).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _like(saved: np.ndarray, like):
    """A saved leaf in the form of ``like``'s leaf: a tensor on its device,
    an array, or a Python number of its type."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(saved).to(like.device)
    if isinstance(like, np.ndarray):
        return saved
    return type(like)(saved.item())


def _rebuild(like, leaves):
    """``like`` with each leaf replaced by the next of ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        vals = [_rebuild(v, leaves) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    return _like(next(leaves), like)


def load_state(path: str, like):
    """Load a checkpoint into the structure of ``like`` (a state with as
    many leaves as the saved one): each leaf on the device of ``like``'s
    matching leaf. Returns (state, step)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    target = []
    _flatten(like, target)
    if len(target) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, target structure has "
            f"{len(target)}")
    return _rebuild(like, iter(leaves)), meta["step"]
