"""Fused edge-axis SSSP on symmetric-layout graphs.

Counterpart of ``essentials_tpu/ops/fused_sssp.py`` (``init_dist_exp``,
``fused_sssp_superstep``, ``collapse_dist_exp``, ``run_fused_sssp``).
Distances live on the edge axis as IEEE-754 float32 bit patterns in int32
(non-negative floats order as their bits do), start-authoritative as in
``ops/fused_bfs.py``: only each segment's start ``row_offsets[v]`` is read
or written. One sweep is one ``sssp_sweep`` call, a Bellman-Ford
relaxation with the result of relaxing every edge; it reads one state
buffer and writes the other, so each sweep sees only the previous sweep's
distances, as the JAX package's sweeps do. The buffer it writes holds the
distances of the sweep before (+inf before the first), from which the
kernel knows which vertices changed: only their out-edges are relaxed.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.fused_spmv import edge_weights
from essentials_tpu_torch.runtime import span

INF_BITS = kernels.INF_BITS       # float32 +inf as int32 bits


def csc_weights(g: Graph) -> torch.Tensor:
    """The graph's CSC weights as float32: the weight of each CSC slot (the
    graph's own tensor when it is float32 already), for the
    predecessors."""
    return g.csc_values.to(torch.float32).contiguous()


def init_dist_exp(g: Graph, source: int) -> torch.Tensor:
    """dist_exp[p] = 0.0 bits where segment(p) == source, else +inf bits, on
    ``g``'s device. The source's segment is the contiguous CSR range
    [row_offsets[source], row_offsets[source+1])."""
    o0, o1 = g.row_offsets[source:source + 2].tolist()
    dist = torch.full((g.n_edges_padded,), INF_BITS, dtype=torch.int32,
                      device=g.device)
    dist[o0:o1] = 0
    return dist


def init_spare(g: Graph) -> torch.Tensor:
    """The second state buffer of a search: +inf bits, the distances
    "before" the first sweep."""
    return torch.full((g.n_edges_padded,), INF_BITS, dtype=torch.int32,
                      device=g.device)


def fused_sssp_superstep(g: Graph, dist_in: torch.Tensor,
                         dist_out: torch.Tensor) -> torch.Tensor:
    """One Bellman-Ford sweep (the ``sssp_sweep`` kernel) from ``dist_in``
    into ``dist_out`` at segment starts; ``dist_out`` holds the distances
    of the sweep before ``dist_in``'s (``init_spare`` before the first).
    Returns the improvement count, int32 [1]. The JAX fallback writes whole
    segments; the two agree at segment starts, which is all either
    reads."""
    return kernels.sssp_sweep(dist_in, dist_out, g.row_offsets,
                              g.col_indices, edge_weights(g))


def collapse_dist_exp(g: Graph, dist_exp: torch.Tensor,
                      source: int) -> torch.Tensor:
    """dist_exp bits -> per-vertex float32 distances [Vp] (the
    ``collapse_starts`` kernel): +inf at empty segments, 0 at the source."""
    return kernels.collapse_starts(dist_exp, g.row_offsets, INF_BITS,
                                   source).view(torch.float32)


def read_sweep(g: Graph, cnt: torch.Tensor) -> int:
    """A full sweep's improvement count ``cnt`` read to the host (the span
    ``sssp.sweep.read``: the sweep's one wait on the device), and counted
    in ``kernels.counters`` with the sweep's V relaxed vertices
    (``sssp.improved``, ``sssp.swept``)."""
    with span("sssp.sweep.read"):
        improved = int(cnt.item())
    kernels.counters["sssp.swept"] += g.n_vertices
    kernels.counters["sssp.improved"] += improved
    return improved


def run_fused_sssp(g: Graph, source: int, max_it: int) -> tuple:
    """Whole SSSP as Bellman-Ford sweeps on the edge axis, on the host's
    loop: one ``sssp_sweep`` per sweep and one ``.item()`` to read its
    count; stops after the first sweep that improves nothing or after
    ``max_it`` sweeps. Returns (dist float32 [Vp], sweeps)."""
    dist = init_dist_exp(g, source)
    spare = init_spare(g)
    it = 0
    while it < max_it:
        with span("sssp.sweep"):
            cnt = fused_sssp_superstep(g, dist, spare)
            dist, spare = spare, dist
            improved = read_sweep(g, cnt)
        it += 1
        if improved == 0:
            break
    return collapse_dist_exp(g, dist, source), it
