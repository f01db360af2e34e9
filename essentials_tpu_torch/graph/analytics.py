"""Graph analytics: degree statistics on the graph's device.

Counterpart of ``essentials_tpu/graph/analytics.py`` (reference parity:
graph.hxx get_average_degree :326-333, get_degree_standard_deviation
:346-356, build_degree_histogram :371-404), in the same float32 arithmetic.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch.graph.graph import Graph


def _real_degrees(g: Graph) -> torch.Tensor:
    return torch.where(g.vertex_mask(), g.out_degrees(), 0)


def average_degree(g: Graph) -> float:
    return float(_real_degrees(g).sum().float() / g.n_vertices)


def degree_standard_deviation(g: Graph) -> float:
    mask = g.vertex_mask()
    deg = _real_degrees(g).float()
    mean = deg.sum() / g.n_vertices
    var = torch.where(mask, (deg - mean) ** 2, 0.0).sum() / g.n_vertices
    return float(torch.sqrt(var))


def degree_histogram(g: Graph, n_bins: int = 32) -> torch.Tensor:
    """[n_bins] int32 on ``g``'s device, log2-scale: bin k counts the
    vertices with degree in [2^(k-1), 2^k); bin 0 the degree-0 vertices."""
    deg = _real_degrees(g)
    bins = torch.where(deg > 0, torch.floor(torch.log2(deg.float())) + 1, 0)
    bins = bins.to(torch.int32).clamp(0, n_bins - 1)
    return torch.zeros(n_bins, dtype=torch.int32, device=g.device).index_add_(
        0, bins, g.vertex_mask().to(torch.int32))
