"""Windowed SSSP: Bellman-Ford sweeps on the windowed SpMV engine.

Counterpart of ``essentials_tpu/ops/windowed_sssp.py``. Each sweep is one
``windowed_pipeline(message="add", reduce="min")`` (the ``spmv_slabs``
kernel): cand[u] = min over u's out-edges (u, v) of
dist[v] + w(u, v), which on an undirected graph with symmetric weights is
the relaxation by in-neighbours. The JAX package holds the state in compact
rank space and collapses it through ``plan.y_route``; on a symmetric layout
the port's vertex axis is that rank space with the empty segments left in,
where cand is the identity +inf, so the state is [Vp] and nothing is
routed. The JAX reference path slices its output to ``plan.vp``, which
mismatches the state when vp > n_rseg + SLAB (``windowed_sssp.py:56``);
here both are [Vp].
"""

from __future__ import annotations

import torch

from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.fused_sssp import count_sweep
from essentials_tpu_torch.ops.windowed_spmv import INF_BITS, windowed_pipeline
from essentials_tpu_torch.runtime import span


def sweep(g: Graph, dist: torch.Tensor) -> tuple:
    """One relaxation sweep. dist: [Vp] int32 float32 bits. Returns (dist',
    improved count int32 0-d)."""
    cand = windowed_pipeline(g, dist.view(torch.float32), message="add",
                             reduce="min")
    improved = cand < dist                      # int order == f32 order
    return torch.where(improved, cand, dist), improved.sum(dtype=torch.int32)


def run_windowed_sssp(g: Graph, source: int, max_it: int) -> tuple:
    """Whole SSSP as vertex-axis Bellman-Ford sweeps on the host's loop,
    one ``.item()`` per sweep (``sssp.sweep.read``); stops after the first
    sweep that improves nothing or after ``max_it``. Each sweep reads every
    edge slot, so it counts ``g.n_edges`` in ``sssp.push_slots``. Returns
    (dist float32 [Vp], sweeps)."""
    dist = torch.full((g.n_vertices_padded,), INF_BITS, dtype=torch.int32,
                      device=g.device)
    dist[source] = 0
    it = 0
    while it < max_it:
        with span("sssp.sweep"):
            dist, cnt = sweep(g, dist)
            with span("sssp.sweep.read"):
                improved = int(cnt.item())
            count_sweep(g, improved, g.n_edges)
        it += 1
        if improved == 0:
            break
    return dist.view(torch.float32), it
