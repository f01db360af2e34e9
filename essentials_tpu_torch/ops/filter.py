"""Filter: predicate-driven frontier restriction.

Counterpart of ``essentials_tpu/ops/filter.py`` (reference parity:
operators::filter::execute with its four strategies, filter.hxx:59-152).
With dense boolmap frontiers all four are one masked AND.
"""

from __future__ import annotations

from typing import Callable

import torch

from essentials_tpu_torch.graph.graph import Graph


def filter_frontier(g: Graph, frontier: torch.Tensor, predicate: Callable,
                    kind: str = "vertex") -> torch.Tensor:
    """Keep active elements where ``predicate(ids) -> bool`` holds.

    ``predicate`` receives the full int32 id vector ([Vp] or [Ep]) and must
    return a boolean vector; it is only *observed* at active slots.
    """
    ids = torch.arange(frontier.shape[0], dtype=torch.int32,
                       device=frontier.device)
    valid = g.vertex_mask() if kind == "vertex" else g.edge_mask()
    return frontier & predicate(ids) & valid
