"""Single-source shortest paths on Bellman-Ford sweeps.

Counterpart of ``essentials_tpu/algorithms/sssp.py`` for the variants
``fused`` (edge-axis sweeps, ``ops/fused_sssp.py``) and ``windowed``
(vertex-axis sweeps on the windowed SpMV engine, ``ops/windowed_sssp.py``);
reference parity: gunrock ``sssp.hxx:110-151``, whose atomicMin relaxation
becomes a deterministic min per sweep. Both variants compute the same
float32 additions and compare them exactly, so they give the same bits and
the same sweep count. Predecessors are derived afterwards in one pass: the
smallest-id in-neighbour whose distance plus the edge's weight is the
vertex's distance in float32.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_sssp as FS
from essentials_tpu_torch.ops import windowed_sssp as WS
from essentials_tpu_torch.utils.timer import Timer

VARIANTS = {"fused": FS.run_fused_sssp, "windowed": WS.run_windowed_sssp}
# variants of the JAX package that this package does not run yet, and the
# ROADMAP.md queue-1 item that brings them
_UNPORTED = {"adaptive": 8}


class SsspResult(NamedTuple):
    distances: torch.Tensor      # [V] float32, +inf where unreached
    predecessors: torch.Tensor   # [V] int32, -1 at source / unreached
    iterations: int
    elapsed_ms: float


def fused_supported(g: Graph) -> bool:
    """The edge-axis sweep needs the symmetric layout: each in-neighbour's
    distance sits at the start of its own segment."""
    return bool(g.symmetric_layout)


def windowed_supported(g: Graph) -> bool:
    """The windowed sweep relaxes by out-edges, which is the relaxation by
    in-edges only on an undirected graph (symmetric edges and weights)."""
    return bool(g.symmetric_layout and not g.properties.directed)


def predecessors_from_distances(g: Graph, dist: torch.Tensor) -> torch.Tensor:
    """pred[v] = smallest-id in-neighbour u with dist[u] + w(u, v) ==
    dist[v] in float32 (-1 at the source and unreached vertices). One
    full-graph pass (the ``sssp_predecessors`` kernel)."""
    throw_if(not g.has_csc, "predecessors need the CSC view")
    return kernels.sssp_predecessors(dist, g.csc_offsets, g.csc_src_indices,
                                     FS.csc_weights(g), g.n_edges)


def run(g: Graph, source: int, *, max_iterations: int | None = None,
        warmup: bool = True, variant: str = "auto") -> SsspResult:
    """SSSP from ``source`` on ``g``'s device.

    variant: 'fused', 'windowed', or 'auto', which is 'windowed' where
    ``windowed_supported`` holds and 'fused' elsewhere: both give the same
    bits and sweeps, and windowed sweeps took a third of the fused sweeps'
    time on the H100 at RMAT scale 20 (PERF.md). The JAX package's 'auto'
    is 'fused'. ``elapsed_ms`` covers the sweeps and the collapse to
    distances, not the predecessors, on the device's clock (CUDA events) or
    the host's (CPU)."""
    if variant in _UNPORTED:
        raise EssentialsError(
            f"sssp variant {variant!r} is not ported yet "
            f"(ROADMAP.md queue 1, item {_UNPORTED[variant]})")
    if variant == "auto":
        variant = "windowed" if windowed_supported(g) else "fused"
    throw_if(variant not in VARIANTS, f"unknown sssp variant {variant!r}")
    throw_if(not fused_supported(g),
             "sssp on a graph without a symmetric layout needs the adaptive "
             "frontier, which is not ported yet (ROADMAP.md queue 1, item 8)")
    throw_if(variant == "windowed" and not windowed_supported(g),
             "windowed sssp relaxes by out-edges and needs an undirected "
             "graph; use variant 'fused'")
    throw_if(not 0 <= source < g.n_vertices,
             f"source {source} out of range [0, {g.n_vertices})")
    max_it = max_iterations if max_iterations is not None else g.n_vertices + 1
    search = VARIANTS[variant]

    if warmup:
        search(g, source, max_it)
    timer = Timer(g.device).begin()
    dist, it = search(g, source, max_it)
    elapsed = timer.end()

    v = g.n_vertices
    pred = predecessors_from_distances(g, dist)[:v]
    return SsspResult(dist[:v], pred, it, elapsed)


def cpu_reference(csr, source: int) -> np.ndarray:
    """Host Dijkstra in float64, returned as float32 (reference parity:
    examples/algorithms/sssp/sssp_cpu.hxx, priority-queue Dijkstra)."""
    n = csr.n_rows
    offsets = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values, dtype=np.float64)
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for e in range(offsets[u], offsets[u + 1]):
            vtx, nd = cols[e], d + vals[e]
            if nd < dist[vtx]:
                dist[vtx] = nd
                heapq.heappush(heap, (nd, vtx))
    return dist.astype(np.float32)
