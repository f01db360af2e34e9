"""Uniquify: frontier deduplication.

Counterpart of ``essentials_tpu/ops/uniquify.py`` (reference parity:
operators::uniquify::execute, uniquify.hxx:15-74). A boolmap cannot hold a
duplicate, so uniquify returns it as it is; an index list becomes a boolmap.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch.errors import throw_if


def uniquify(frontier: torch.Tensor, *,
             capacity: int | None = None) -> torch.Tensor:
    """Boolmap in -> the same boolmap out (already duplicate-free).

    Index list in (integer dtype) -> bool[capacity] with duplicates dropped,
    and entries outside [0, capacity) (negative pads among them) dropped,
    as the JAX package's scatter drops them."""
    if frontier.dtype == torch.bool:
        return frontier
    throw_if(capacity is None, "uniquify of an index list needs capacity")
    keep = (frontier >= 0) & (frontier < capacity)
    hit = torch.zeros(capacity + 1, dtype=torch.bool, device=frontier.device)
    hit[torch.where(keep, frontier, capacity).long()] = True
    return hit[:capacity]
