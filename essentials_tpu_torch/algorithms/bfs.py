"""Breadth-first search: the fused edge-axis superstep and the adaptive
frontier.

Counterpart of ``essentials_tpu/algorithms/bfs.py`` for the variants
``fused``, ``fused8`` and ``adaptive`` (reference parity: gunrock
``bfs.hxx:110-178``, level-synchronous BFS). The loop computes only the
reached set per level; depths come from the level counter, and predecessors
are derived afterwards in one full-graph pass (the smallest-id in-neighbour
one level up), which makes them deterministic.

The level array is int8 for ``fused8`` when at most 126 levels are asked
for, and int32 otherwise; ``fused`` always runs the int32 form. Both forms
give the same distances. ``fused`` needs a symmetric layout; ``adaptive``
runs on any graph with a CSC view, on the operator layer: each level takes
the tiny spray, the spray or the dense advance (``step``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.framework.enactor import default_converged, enact
from essentials_tpu_torch.frontier import frontier_from_indices
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_bfs as FB
from essentials_tpu_torch.ops import sparse_advance as SA
from essentials_tpu_torch.ops.advance import advance_count
from essentials_tpu_torch.utils.timer import Timer

UNREACHED = np.iinfo(np.int32).max

VARIANTS = ("fused", "fused8", "adaptive")
# variants of the JAX package that this package does not run yet, and the
# ROADMAP.md queue-1 item that brings them
_UNPORTED = {"hybrid": 8, "phased": 8}
TIERS = ("tiny spray", "spray", "dense")


class BfsResult(NamedTuple):
    distances: torch.Tensor      # [V] int32, UNREACHED where not reached
    predecessors: torch.Tensor   # [V] int32, -1 at source / unreached
    iterations: int
    elapsed_ms: float
    tiers: tuple = (0, 0, 0)     # adaptive levels per tier (TIERS)


class BfsState(NamedTuple):
    """The adaptive frontier: the boolmap always, and an index list that is
    current when ``fvalid``. When it is, and the frontier's total
    out-degree fits a spray budget, the level runs the spray instead of the
    dense advance. fcount, fvalid, degsum and live are host values, read in
    one transfer at the end of each level (``sparse_advance.read_control``),
    from which the host picks the tier (``sparse_advance.tier``)."""
    distances: torch.Tensor   # int32[Vp], UNREACHED where not found yet
    frontier: torch.Tensor    # bool[Vp]
    fidx: torch.Tensor        # int32[K] frontier indices (pad_vertex-filled)
    fcount: int               # |frontier| as the last level counted it
    fvalid: bool              # fidx is in sync with frontier
    degsum: int               # total out-degree of the frontier
    live: int                 # frontier size (the convergence test)
    tiers: tuple              # levels run per tier so far


def init(g: Graph, source: int) -> BfsState:
    dist = torch.full((g.n_vertices_padded,), UNREACHED, dtype=torch.int32,
                      device=g.device)
    dist[source] = 0
    fidx = torch.full((SA.spray_k(g),), g.pad_vertex, dtype=torch.int32,
                      device=g.device)
    fidx[0] = source
    lo, hi = g.row_offsets[source:source + 2].tolist()
    return BfsState(dist, frontier_from_indices(g, [source]), fidx, 1, True,
                    hi - lo, 1, (0, 0, 0))


def step(g: Graph, state: BfsState, it: int) -> BfsState:
    """One level. Work-adaptive three-way choice on the frontier's total
    out-degree, as the JAX package's ``bfs.step``:

      tiny spray   sum(deg) <= 4K and <= 2K members
      spray        sum(deg) <= 32K
      dense        otherwise: the ``advance_count`` kernel over the CSC

    The dense tier also compacts the next index list when it fits, so every
    graph drops back to the spray for its small levels. Without
    ``spray_enabled`` every level is dense."""
    dist, frontier, fidx = state.distances, state.frontier, state.fidx
    k_all = SA.spray_k(g)
    unvisited = dist == UNREACHED
    spray = SA.spray_enabled(g)
    branch = SA.tier(state) if spray else 2
    if branch == 2:
        newly = (advance_count(g, frontier) > 0) & unvisited
        if spray:
            fc = newly.sum(dtype=torch.int32)
            nidx = SA.compact_if_fits(g, newly, fc)
        else:
            fc, nidx = None, fidx
    else:
        budget, k = ((SA.TINY_BUDGET, SA.TINY_K) if branch == 0
                     else (SA.SPRAY_BUDGET, k_all))
        offs, deg = SA.frontier_out_degree(g, fidx[:k])
        newly, nidx, fc = SA.spray_reach(g, fidx[:k], offs, deg, unvisited,
                                         budget, k)
        nidx = SA.pad_index_list(g, nidx, k_all)
    live, degsum, fcount = SA.read_control(g, newly, fc)
    tiers = tuple(n + (i == branch) for i, n in enumerate(state.tiers))
    return BfsState(torch.where(newly, it + 1, dist), newly, nidx, fcount,
                    spray and fcount <= k_all, degsum, live, tiers)


def fused_supported(g: Graph) -> bool:
    """The edge-axis fused superstep needs the symmetric layout, so that the
    vertex<->edge moves cancel across levels."""
    return bool(g.symmetric_layout)


def run_fused_levels(g: Graph, source: int, max_it: int, *,
                     int8: bool = False) -> tuple:
    """Whole BFS on the edge axis: one ``bfs_level`` launch per level, on
    the host's loop. Stops after ``max_it`` levels or after the first level
    that reaches nothing (one ``.item()`` per level). Returns (lev_exp,
    iterations, unreached). ``int8`` runs the int8 form and needs
    ``max_it <= 126``."""
    throw_if(int8 and max_it > FB.UNREACHED_E - 1,
             f"int8 levels hold at most {FB.UNREACHED_E - 1} levels")
    unreached = FB.UNREACHED_E if int8 else FB.UNREACHED
    lev = FB.init_lev_exp(g, source, unreached)
    it = 0
    while it < max_it:
        _, cnt = FB.fused_superstep(g, lev, it, unreached=unreached)
        it += 1
        if cnt.item() == 0:
            break
    return lev, it, unreached


def predecessors_from_distances(g: Graph, dist: torch.Tensor) -> torch.Tensor:
    """pred[v] = smallest-id in-neighbour one BFS level up (-1 at source /
    unreached). One full-graph pass (the ``bfs_predecessors`` kernel)."""
    throw_if(not g.has_csc, "predecessors need the CSC view")
    return kernels.bfs_predecessors(dist, g.csc_offsets, g.csc_src_indices,
                                    g.n_edges)


def _search(g: Graph, source: int, max_it: int, int8: bool):
    lev, it, unreached = run_fused_levels(g, source, max_it, int8=int8)
    return FB.collapse_lev_exp(g, lev, source, unreached), it


def run(g: Graph, source: int, *, max_iterations: int | None = None,
        compute_predecessors: bool = True, warmup: bool = True,
        variant: str = "auto") -> BfsResult:
    """BFS from ``source`` on ``g``'s device.

    variant: 'fused' (int32 levels), 'fused8' (int8 levels when
    ``max_iterations <= 126``), 'adaptive' (the spray/dense frontier on the
    operator layer), or 'auto', which is 'fused' on a graph with a
    symmetric layout and 'adaptive' elsewhere (the JAX package's 'auto'
    times its candidates; this one does not). ``elapsed_ms`` covers the
    levels (and, for the fused variants, the collapse to distances), on the
    device's clock (CUDA events) or the host's (CPU)."""
    if variant in _UNPORTED:
        raise EssentialsError(
            f"bfs variant {variant!r} is not ported yet "
            f"(ROADMAP.md queue 1, item {_UNPORTED[variant]})")
    if variant == "auto":
        variant = "fused" if fused_supported(g) else "adaptive"
    throw_if(variant not in VARIANTS, f"unknown bfs variant {variant!r}")
    throw_if(variant != "adaptive" and not fused_supported(g),
             f"bfs variant {variant!r} needs a graph with a symmetric "
             f"layout; use 'adaptive' or 'auto'")
    throw_if(not 0 <= source < g.n_vertices,
             f"source {source} out of range [0, {g.n_vertices})")
    max_it = max_iterations if max_iterations is not None else g.n_vertices + 1
    tiers = (0, 0, 0)
    if variant == "adaptive":
        throw_if(not g.has_csc, "adaptive bfs needs the CSC view")
        res = enact(step, default_converged, g, init(g, source),
                    max_iterations=max_it, warmup=warmup)
        dist, it, elapsed = res.state.distances, res.iterations, \
            res.elapsed_ms
        tiers = res.state.tiers
    else:
        int8 = variant == "fused8" and max_it <= FB.UNREACHED_E - 1
        if warmup:
            _search(g, source, max_it, int8)
        timer = Timer(g.device).begin()
        dist, it = _search(g, source, max_it, int8)
        elapsed = timer.end()

    v = g.n_vertices
    if compute_predecessors:
        pred = predecessors_from_distances(g, dist)[:v]
    else:
        pred = torch.full((v,), -1, dtype=torch.int32, device=g.device)
    return BfsResult(dist[:v], pred, it, elapsed, tiers)


def cpu_reference(csr, source: int) -> np.ndarray:
    """Host BFS distances (reference parity: examples/algorithms/bfs/
    bfs_cpu.hxx), level-synchronous over NumPy arrays: BFS distances are
    unique, so the order in which a level's vertices are visited is moot."""
    n = csr.n_rows
    offsets = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices)
    dist = np.full(n, UNREACHED, np.int32)
    dist[source] = 0
    frontier = np.array([source], np.int64)
    level = 0
    while frontier.size:
        level += 1
        starts, lens = offsets[frontier], offsets[frontier + 1] - offsets[frontier]
        total = int(lens.sum())
        # positions of every out-edge of the frontier, segment by segment
        pos = (np.repeat(starts - np.cumsum(lens) + lens, lens)
               + np.arange(total, dtype=np.int64))
        nbrs = np.unique(cols[pos])
        frontier = nbrs[dist[nbrs] == UNREACHED].astype(np.int64)
        dist[frontier] = level
    return dist
