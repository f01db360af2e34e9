"""Dense boolmap frontier primitives.

Counterpart of ``essentials_tpu/frontier/boolmap.py:15-46``. A frontier is
a ``bool[Vp]`` (or ``bool[Ep]`` for edge frontiers) tensor on the graph's
device; the pad slots are always False.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch.graph.graph import Graph


def _size(g: Graph, kind: str) -> int:
    return g.n_vertices_padded if kind == "vertex" else g.n_edges_padded


def empty_frontier(g: Graph, kind: str = "vertex") -> torch.Tensor:
    return torch.zeros(_size(g, kind), dtype=torch.bool, device=g.device)


def full_frontier(g: Graph, kind: str = "vertex") -> torch.Tensor:
    """All real vertices/edges active (reference: frontier sequence fill)."""
    return g.vertex_mask() if kind == "vertex" else g.edge_mask()


def frontier_from_indices(g: Graph, indices, kind: str = "vertex"
                          ) -> torch.Tensor:
    out = empty_frontier(g, kind)
    out[torch.as_tensor(indices, device=g.device).long()] = True
    return out


def frontier_size(frontier: torch.Tensor) -> torch.Tensor:
    """Number of active elements, an int32 scalar on the frontier's
    device."""
    return frontier.sum(dtype=torch.int32)


def frontier_is_empty(frontier: torch.Tensor) -> torch.Tensor:
    return ~frontier.any()


def frontier_to_indices(frontier: torch.Tensor, capacity: int
                        ) -> torch.Tensor:
    """Fixed-capacity active-index list, ascending, padded with -1."""
    idx = torch.nonzero(frontier).flatten()[:capacity].int()
    out = torch.full((capacity,), -1, dtype=torch.int32,
                     device=frontier.device)
    out[:idx.numel()] = idx
    return out
