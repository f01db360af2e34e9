"""Single-source shortest paths on Bellman-Ford sweeps.

Counterpart of ``essentials_tpu/algorithms/sssp.py`` for the variants
``fused`` (edge-axis sweeps, ``ops/fused_sssp.py``), ``windowed``
(vertex-axis sweeps on the windowed SpMV engine, ``ops/windowed_sssp.py``)
and ``adaptive`` (frontier Bellman-Ford on the operator layer: each round
takes the tiny spray, the spray or the dense advance); reference parity:
gunrock ``sssp.hxx:110-151``, whose atomicMin relaxation becomes a
deterministic min. ``fused`` and ``windowed`` compute the same float32
additions and compare them exactly, so they give the same bits and the same
sweep count; their predecessors are derived afterwards in one pass, the
smallest-id in-neighbour whose distance plus the edge's weight is the
vertex's distance in float32. ``adaptive`` runs on any graph with a CSC
view and takes its predecessors from its rounds, as the JAX package does.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.framework.enactor import default_converged, enact
from essentials_tpu_torch.frontier import frontier_from_indices
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_sssp as FS
from essentials_tpu_torch.ops import sparse_advance as SA
from essentials_tpu_torch.ops import windowed_sssp as WS
from essentials_tpu_torch.ops.configs import Combine
from essentials_tpu_torch.ops.segment import combine_by_offsets, gather
from essentials_tpu_torch.runtime import span, spanned
from essentials_tpu_torch.utils.timer import Timer

# the sweep engines; 'adaptive' runs on the enactor
VARIANTS = {"fused": FS.run_fused_sssp, "windowed": WS.run_windowed_sssp}
IMAX = SA.IMAX


class SsspResult(NamedTuple):
    distances: torch.Tensor      # [V] float32, +inf where unreached
    predecessors: torch.Tensor   # [V] int32, -1 at source / unreached
    iterations: int
    elapsed_ms: float
    tiers: tuple = (0, 0, 0)     # adaptive rounds per tier (bfs.TIERS)


class SsspState(NamedTuple):
    """The adaptive frontier (see ``bfs.BfsState``): boolmap, index list,
    and the host values read once per round."""
    distances: torch.Tensor   # float32[Vp], +inf where unreached
    predecessors: torch.Tensor  # int32[Vp], -1 where none
    frontier: torch.Tensor    # bool[Vp]
    fidx: torch.Tensor        # int32[K]
    fcount: int
    fvalid: bool
    degsum: int
    live: int
    tiers: tuple


def init(g: Graph, source: int) -> SsspState:
    vp = g.n_vertices_padded
    dist = torch.full((vp,), float("inf"), dtype=torch.float32,
                      device=g.device)
    dist[source] = 0.0
    pred = torch.full((vp,), -1, dtype=torch.int32, device=g.device)
    fidx = torch.full((SA.spray_k(g),), g.pad_vertex, dtype=torch.int32,
                      device=g.device)
    fidx[0] = source
    lo, hi = g.row_offsets[source:source + 2].tolist()
    return SsspState(dist, pred, frontier_from_indices(g, [source]), fidx,
                     1, True, hi - lo, 1, (0, 0, 0))


def dense_relax(g: Graph, dist: torch.Tensor, frontier: torch.Tensor):
    """Two MIN combines over the frontier's in-edges of every destination,
    in CSC order: (cand, the min of dist[src] + w per destination;
    cand_pred, the smallest source that achieves min(cand, dist) there).
    The JAX package runs two ``advance`` calls, each gathering (dist,
    frontier) by source; here one gather serves both, and the per-edge
    candidate is computed once."""
    csrc, off = g.csc_src_indices, g.csc_offsets
    d_src, active = gather(csrc, dist, frontier)
    msg = torch.where(active, d_src + g.csc_values, float("inf"))
    cand = combine_by_offsets(msg, off, Combine.MIN)
    (nd_dst,) = gather(g.csc_dst_indices, torch.minimum(cand, dist))
    achieves = active & (msg == nd_dst)
    cand_pred = combine_by_offsets(torch.where(achieves, csrc, IMAX), off,
                                   Combine.MIN)
    return cand, cand_pred


@spanned("sssp.sweep")
def step(g: Graph, state: SsspState, it: int) -> SsspState:
    """One relaxation round, work-adaptive as ``bfs.step``: small frontiers
    relax exactly their out-edges through the budgeted spray, large ones run
    the dense advance (two MIN combines: distance, then the smallest-id
    predecessor)."""
    dist, pred, frontier, fidx = state[:4]
    k_all = SA.spray_k(g)
    spray = SA.spray_enabled(g)
    branch = SA.tier(state) if spray else 2
    if branch == 2:
        cand, cand_pred = dense_relax(g, dist, frontier)
    else:
        budget, k = ((SA.TINY_BUDGET, SA.TINY_K) if branch == 0
                     else (SA.SPRAY_BUDGET, k_all))
        offs, deg = SA.frontier_out_degree(g, fidx[:k])
        cand, cand_pred, nidx, fc = SA.spray_relax_min(
            g, fidx[:k], offs, deg, dist, budget, k)
        nidx = SA.pad_index_list(g, nidx, k_all)
    improved = cand < dist
    new_frontier = improved & g.vertex_mask()
    if branch == 2:
        fc, nidx = None, fidx
        if spray:
            fc = new_frontier.sum(dtype=torch.int32)
            nidx = SA.compact_if_fits(g, new_frontier, fc)
    with span("sssp.sweep.read"):
        live, degsum, fcount = SA.read_control(g, new_frontier, fc)
    kernels.counters["sssp.swept"] += state.live
    kernels.counters["sssp.improved"] += live
    tiers = tuple(n + (i == branch) for i, n in enumerate(state.tiers))
    return SsspState(torch.where(improved, cand, dist),
                     torch.where(improved, cand_pred, pred), new_frontier,
                     nidx, fcount, spray and fcount <= k_all, degsum, live,
                     tiers)


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


@spanned("sssp.run")
def run(g: Graph, source: int, *, max_iterations: int | None = None,
        warmup: bool = True, variant: str = "auto") -> SsspResult:
    """SSSP from ``source`` on ``g``'s device.

    variant: 'fused', 'windowed', 'adaptive', or 'auto', which is
    'windowed' where ``windowed_supported`` holds, 'fused' on other graphs
    with a symmetric layout and 'adaptive' elsewhere: 'fused' and
    'windowed' give the same bits and sweeps, and windowed sweeps took a
    third of the fused sweeps' time on the H100 at RMAT scale 20 (PERF.md).
    The JAX package's 'auto' is 'fused', or 'adaptive' where that does not
    run. ``elapsed_ms`` covers the sweeps and the collapse to distances
    (not the derived predecessors), or the adaptive rounds, on the device's
    clock (CUDA events) or the host's (CPU).

    Under a torch.profiler the call is the span ``sssp.run``, each sweep or
    round an ``sssp.sweep`` holding its kernels' ``kernel.*`` spans and its
    host read ``sssp.sweep.read`` (``runtime.span``); ``kernels.counters``
    counts the vertices each sweep relaxed and improved."""
    if variant == "auto":
        variant = ("windowed" if windowed_supported(g) else
                   "fused" if fused_supported(g) else "adaptive")
    throw_if(variant not in (*VARIANTS, "adaptive"),
             f"unknown sssp variant {variant!r}")
    throw_if(variant != "adaptive" and not fused_supported(g),
             f"sssp variant {variant!r} needs a graph with a symmetric "
             f"layout; use 'adaptive' or 'auto'")
    throw_if(variant == "windowed" and not windowed_supported(g),
             "windowed sssp relaxes by out-edges and needs an undirected "
             "graph; use variant 'fused'")
    throw_if(not 0 <= source < g.n_vertices,
             f"source {source} out of range [0, {g.n_vertices})")
    max_it = max_iterations if max_iterations is not None else g.n_vertices + 1
    v = g.n_vertices
    if variant == "adaptive":
        throw_if(not g.has_csc, "adaptive sssp needs the CSC view")
        res = enact(step, default_converged, g, init(g, source),
                    max_iterations=max_it, warmup=warmup)
        st = res.state
        return SsspResult(st.distances[:v], st.predecessors[:v],
                          res.iterations, res.elapsed_ms, st.tiers)
    search = VARIANTS[variant]

    if warmup:
        search(g, source, max_it)
    timer = Timer(g.device).begin()
    dist, it = search(g, source, max_it)
    elapsed = timer.end()

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
