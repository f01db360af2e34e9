"""parallel_for: apply a function over vertices or edges, masked.

Counterpart of ``essentials_tpu/ops/parallel_for.py`` (reference parity:
operators::parallel_for::execute, for.hxx:29-99): ``fn`` maps id tensors to
value tensors; a mask selects which results land.
"""

from __future__ import annotations

from typing import Callable

import torch

from essentials_tpu_torch.graph.graph import Graph


def _masked(vals, mask, default):
    fill = (torch.zeros_like(vals) if default is None
            else torch.full_like(vals, default))
    return torch.where(mask, vals, fill)


def for_each_vertex(g: Graph, fn: Callable, *,
                    frontier: torch.Tensor | None = None,
                    default=None) -> torch.Tensor:
    """Apply ``fn(v_ids) -> values`` over all (or active) real vertices.

    Returns values with ``default`` (or 0) in masked-out/pad slots.
    """
    ids = torch.arange(g.n_vertices_padded, dtype=torch.int32,
                       device=g.device)
    mask = g.vertex_mask() if frontier is None else frontier & g.vertex_mask()
    return _masked(fn(ids), mask, default)


def for_each_edge(g: Graph, fn: Callable, *,
                  frontier: torch.Tensor | None = None,
                  default=None) -> torch.Tensor:
    """Apply ``fn(src, dst, edge_ids, weights) -> values`` over (active)
    edges in CSR edge-id order."""
    eids = torch.arange(g.n_edges_padded, dtype=torch.int32, device=g.device)
    vals = fn(g.src_indices, g.col_indices, eids, g.values)
    mask = g.edge_mask() if frontier is None else frontier & g.edge_mask()
    return _masked(vals, mask, default)
