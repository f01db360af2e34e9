"""Frontiers: dense boolean maps over vertices or edges.

Counterpart of ``essentials_tpu/frontier``. A boolmap cannot hold
duplicates; the spray tiers of ``ops/sparse_advance.py`` keep a capped
index list beside it.
"""

from essentials_tpu_torch.frontier.boolmap import (
    empty_frontier, frontier_from_indices, frontier_is_empty, frontier_size,
    frontier_to_indices, full_frontier)

__all__ = [
    "empty_frontier", "full_frontier", "frontier_from_indices",
    "frontier_size", "frontier_is_empty", "frontier_to_indices",
]
