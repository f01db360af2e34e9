"""Breadth-first search: the fused edge-axis superstep, its spray hybrids,
and the adaptive frontier.

Counterpart of ``essentials_tpu/algorithms/bfs.py`` (reference parity:
gunrock ``bfs.hxx:110-178``, level-synchronous BFS). The loop computes only
the reached set per level; depths come from the level counter, and
predecessors are derived afterwards in one full-graph pass (the
smallest-id in-neighbour one level up), which makes them deterministic.

Variants:

* ``fused`` and ``fused8``: one ``bfs_level`` launch per level on the edge
  axis. The level array is int8 for ``fused8`` when at most 126 levels are
  asked for, and int32 otherwise; both give the same distances.
* ``hybrid``: each level is a spray level (the frontier's out-edges
  enumerated into a budget of slots) or a dense ``bfs_level``, chosen on
  the host per level (``run_hybrid_levels``).
* ``phased``: spray, dense with a tail exit, spray, then dense as a
  safety net, each phase its own loop (``run_phased_levels``).
* ``adaptive``: the spray/dense frontier on the operator layer, on any
  graph with a CSC view (``step``).
* ``auto``: on a graph with a symmetric layout, one warm search of each
  candidate timed on the device's clock, the fastest cached by graph
  shape (``_auto_variant``); ``adaptive`` elsewhere.

All but ``adaptive`` need a symmetric layout. ``hybrid`` and ``phased``
run the int32 level form, as the JAX package does off the TPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.framework.enactor import default_converged, enact
from essentials_tpu_torch.frontier import frontier_from_indices
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_bfs as FB
from essentials_tpu_torch.ops import sparse_advance as SA
from essentials_tpu_torch.ops.advance import advance_count
from essentials_tpu_torch.ops.segment import expand_vertex_to_edges
from essentials_tpu_torch.runtime import span, spanned
from essentials_tpu_torch.utils.timer import Timer

UNREACHED = np.iinfo(np.int32).max

VARIANTS = ("fused", "fused8", "adaptive", "hybrid", "phased")
TIERS = ("tiny spray", "spray", "dense")


class LevelCounts(NamedTuple):
    """What one hybrid or phased search ran: its spray and dense levels,
    and its moves between the axes: level arrays expanded from distances,
    collapses of the level array to distances, and index-list
    compactions."""
    spray: int = 0
    dense: int = 0
    expands: int = 0
    collapses: int = 0
    compactions: int = 0


class BfsResult(NamedTuple):
    distances: torch.Tensor      # [V] int32, UNREACHED where not reached
    predecessors: torch.Tensor   # [V] int32, -1 at source / unreached
    iterations: int
    elapsed_ms: float
    tiers: tuple = (0, 0, 0)     # adaptive levels per tier (TIERS)
    modes: LevelCounts | None = None   # hybrid and phased


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


@spanned("bfs.level")
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
    with span("bfs.level.read"):
        live, degsum, fcount = SA.read_control(g, newly, fc)
    tiers = tuple(n + (i == branch) for i, n in enumerate(state.tiers))
    return BfsState(torch.where(newly, it + 1, dist), newly, nidx, fcount,
                    spray and fcount <= k_all, degsum, live, tiers)


def fused_supported(g: Graph) -> bool:
    """The edge-axis fused superstep needs the symmetric layout, so that the
    vertex<->edge moves cancel across levels."""
    return bool(g.symmetric_layout)


def read_level(cnt: torch.Tensor) -> int:
    """The vertices a dense level reached, from its ``bfs_level`` count
    ``cnt``: the level's one host read (the span ``bfs.level.read``), which
    counts its form. The caller holds ``cnt``, and with it the level's
    scratch, until the next level's launch has taken its own."""
    with span("bfs.level.read"):
        return kernels.bfs_level_count(cnt)


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
        with span("bfs.level"):
            _, cnt = FB.fused_superstep(g, lev, it, unreached=unreached)
            reached = read_level(cnt)
        it += 1
        if reached == 0:
            break
    return lev, it, unreached


HYBRID_BUDGET = 1 << 15          # spray level: sum(deg(frontier)) cap
HYBRID_K = 1 << 15               # frontier index-list capacity
_SPRAY, _DENSE, _DONE = 0, 1, 2


def _spray_level(g: Graph, dist: torch.Tensor, fidx: torch.Tensor,
                 offs: torch.Tensor, deg: torch.Tensor, it: int) -> tuple:
    """One spray level from the index list ``fidx`` and its rows' starts
    and out-degrees: (dist with the newly reached at it + 1, their index
    list [HYBRID_K], their count, the new list's starts and out-degrees)."""
    newly, nidx, nc = SA.spray_reach(g, fidx, offs, deg, dist == UNREACHED,
                                     HYBRID_BUDGET, HYBRID_K)
    offs2, deg2 = SA.frontier_out_degree(g, nidx)
    return torch.where(newly, it + 1, dist), nidx, nc, offs2, deg2


def _start_state(g: Graph, source: int) -> tuple:
    """(dist [Vp] int32, index list [HYBRID_K]) holding the source."""
    dist = torch.full((g.n_vertices_padded,), UNREACHED, dtype=torch.int32,
                      device=g.device)
    dist[source] = 0
    fidx = torch.full((HYBRID_K,), g.pad_vertex, dtype=torch.int32,
                      device=g.device)
    fidx[0] = source
    return dist, fidx


def touch_up(g: Graph, lev_buf: torch.Tensor, fidx: torch.Tensor,
             offs: torch.Tensor, level: int) -> None:
    """Write ``level`` at ``offs``, the segment start of each vertex of the
    index list ``fidx``, into ``lev_buf`` ([Ep + 1]: the level array and
    one slot past it, which takes the list's pad entries, as the JAX
    package's scatter drops them)."""
    tgt = torch.where(fidx != g.pad_vertex, offs, g.n_edges_padded)
    lev_buf.index_fill_(0, tgt.long(), level)


def run_hybrid_levels(g: Graph, source: int, max_it: int,
                      spray_override: bool | None = None) -> tuple:
    """Whole BFS with a mode per level (JAX ``run_hybrid_levels``):

      spray   sum(deg(frontier)) <= HYBRID_BUDGET: the spray, plus a
              scatter that keeps the level array's segment starts current
      dense   one ``bfs_level`` launch on the edge axis

    spray -> dense is free (the scatter runs every spray level); dense ->
    spray collapses the level array to distances and compacts the new
    frontier, taken only when the dense level found 0 < cnt <= HYBRID_K
    vertices. The mode is chosen on the host from one read a level (two on
    a dense level that hands over). Returns (dist [Vp] int32, iterations,
    LevelCounts)."""
    pad, ep = g.pad_vertex, g.n_edges_padded
    use_spray = (SA.spray_enabled(g) if spray_override is None
                 else spray_override)
    unreached = FB.UNREACHED
    # init_lev_exp's array with one slot past the edge axis, which takes
    # the touch-up's pad entries
    lo, hi = g.row_offsets[source:source + 2].tolist()
    lev_buf = torch.full((ep + 1,), unreached, dtype=torch.int32,
                         device=g.device)
    lev = lev_buf[:ep]
    lev[lo:hi] = 0
    dist, fidx = _start_state(g, source)
    offs, deg = SA.frontier_out_degree(g, fidx)
    mode = _SPRAY if use_spray and hi - lo <= HYBRID_BUDGET else _DENSE
    fresh, it, counts = True, 0, dict.fromkeys(LevelCounts._fields, 0)
    while mode != _DONE and it < max_it:
        with span("bfs.level"):
            if mode == _SPRAY:
                dist, fidx, nc, offs, deg = _spray_level(g, dist, fidx, offs,
                                                         deg, it)
                touch_up(g, lev_buf, fidx, offs, it + 1)
                with span("bfs.level.read"):
                    nc, nds = torch.stack([nc.long(),
                                           deg.sum(dtype=torch.int64)]
                                          ).tolist()
                mode = (_DONE if nc == 0 else
                        _SPRAY if nds <= HYBRID_BUDGET else _DENSE)
                fresh = True
                counts["spray"] += 1
            else:
                _, cnt = FB.fused_superstep(g, lev, it, unreached=unreached)
                reached = read_level(cnt)
                counts["dense"] += 1
                if use_spray and 0 < reached <= HYBRID_K:
                    dist = FB.collapse_lev_exp(g, lev, source, unreached)
                    fidx = SA.compact_frontier(dist == it + 1, HYBRID_K, pad)
                    offs, deg = SA.frontier_out_degree(g, fidx)
                    with span("bfs.level.read"):
                        nds = int(deg.sum(dtype=torch.int64))
                    mode = _SPRAY if nds <= HYBRID_BUDGET else _DENSE
                    fresh = True
                    counts["collapses"] += 1
                    counts["compactions"] += 1
                else:
                    mode = _DONE if reached == 0 else _DENSE
                    fresh = False
        it += 1
    if not fresh:
        # the last level ran dense without handing over: merge the edge
        # axis's levels (the spray-found ones are exact already)
        dist = torch.minimum(dist, FB.collapse_lev_exp(g, lev, source,
                                                       unreached))
        counts["collapses"] += 1
    return dist, it, LevelCounts(**counts)


def run_phased_levels(g: Graph, source: int, max_it: int,
                      spray_override: bool | None = None) -> tuple:
    """Whole BFS as four phases (JAX ``run_phased_levels``): spray A from
    the source while the frontier's out-degree sum fits HYBRID_BUDGET;
    dense B until a level reaches no more than a degree-scaled tail count
    (it hands the tail to C) or nothing; spray C on the tail; dense D, with
    no tail exit, where the tail outgrew the budget. B and D start from the
    distances expanded onto the edge axis (the ``expand_segments``
    kernel); the levels that B and D find are min-merged into the
    distances by a collapse, once on each path where they are stale.
    Returns (dist [Vp] int32, iterations, LevelCounts)."""
    pad, ep, vp = g.pad_vertex, g.n_edges_padded, g.n_vertices_padded
    use_spray = (SA.spray_enabled(g) if spray_override is None
                 else spray_override)
    unreached = FB.UNREACHED
    # dense -> spray handoff: the next level's edge work is estimated from
    # the newly count; C re-checks the real degree sum
    avg_deg = max(1, ep // max(vp, 1))
    tail_cnt = max(256, min(HYBRID_K, (4 * HYBRID_BUDGET) // avg_deg))
    counts = dict.fromkeys(LevelCounts._fields, 0)

    def spray_loop(dist, fidx, it, go):
        """go: 1 run, 0 done, 2 the frontier outgrew the budget."""
        if go == 1 and it < max_it:
            offs, deg = SA.frontier_out_degree(g, fidx)
            nds = int(deg.sum(dtype=torch.int64))
        while go == 1 and it < max_it:
            if nds > HYBRID_BUDGET:
                return dist, fidx, 2, it
            with span("bfs.level"):
                dist, fidx, nc, offs, deg = _spray_level(g, dist, fidx, offs,
                                                         deg, it)
                with span("bfs.level.read"):
                    nc, nds = torch.stack([nc.long(),
                                           deg.sum(dtype=torch.int64)]
                                          ).tolist()
            go = 0 if nc == 0 else 1
            it += 1
            counts["spray"] += 1
        return dist, fidx, go, it

    def dense_loop(lev, it, go, tail_exit):
        """go: 1 run, 0 done, 2 the tail handed to the spray."""
        while go == 1 and it < max_it:
            with span("bfs.level"):
                _, cnt = FB.fused_superstep(g, lev, it, unreached=unreached)
                reached = read_level(cnt)
            go = (0 if reached == 0 else
                  2 if tail_exit and reached <= tail_cnt else 1)
            it += 1
            counts["dense"] += 1
        return go, it

    def to_edge_axis(dist):
        counts["expands"] += 1
        return expand_vertex_to_edges(dist, g.row_offsets, ep)

    def merged(dist, lev):
        counts["collapses"] += 1
        return torch.minimum(dist, FB.collapse_lev_exp(g, lev, source,
                                                       unreached))

    dist, fidx = _start_state(g, source)
    # A: spray from the source
    dist, fidx, go_a, it = spray_loop(dist, fidx, 0, 1 if use_spray else 2)
    # B: dense levels with the tail exit
    enter_b = go_a == 2
    lev = to_edge_axis(dist) if enter_b else None   # read only if B ran
    go_b, it = dense_loop(lev, it, 1 if enter_b else 0, use_spray)
    # B -> C: collapse and compact, only on the tail handoff
    if go_b == 2:
        dist = merged(dist, lev)
        fidx = SA.compact_frontier(dist == it, HYBRID_K, pad)
        counts["compactions"] += 1
    else:
        fidx = torch.full_like(fidx, pad)
    # C: spray the tail
    dist, fidx, go_c, it = spray_loop(dist, fidx, it, 1 if go_b == 2 else 0)
    # D: dense to the end where the tail regrew
    enter_d = go_c == 2
    if enter_d:
        lev = to_edge_axis(dist)
    _, it = dense_loop(lev, it, 1 if enter_d else 0, False)
    # the dense-found levels are stale in dist unless the B -> C handoff
    # merged them and D never ran
    if enter_b and not (go_b == 2 and not enter_d):
        dist = merged(dist, lev)
    return dist, it, LevelCounts(**counts)


def predecessors_from_distances(g: Graph, dist: torch.Tensor) -> torch.Tensor:
    """pred[v] = smallest-id in-neighbour one BFS level up (-1 at source /
    unreached). One full-graph pass (the ``bfs_predecessors`` kernel)."""
    throw_if(not g.has_csc, "predecessors need the CSC view")
    return kernels.bfs_predecessors(dist, g.csc_offsets, g.csc_src_indices,
                                    g.n_edges)


def _search(g: Graph, source: int, max_it: int, int8: bool):
    lev, it, unreached = run_fused_levels(g, source, max_it, int8=int8)
    return FB.collapse_lev_exp(g, lev, source, unreached), it


_auto_cache: dict = {}


def _graph_key(g: Graph) -> tuple:
    return (g.n_vertices_padded, g.n_edges_padded, g.symmetric_layout,
            bool(g.properties.weighted), g.device.type)


def _variant_fn(cand: str):
    """(g, source, max_it) -> (dist [Vp], iterations) for a candidate of
    the timed ``auto``."""
    if cand in ("fused", "fused8"):
        return lambda g, s, m: _search(g, s, m, cand == "fused8")
    levels = {"phased": run_phased_levels, "hybrid": run_hybrid_levels}[cand]
    return lambda g, s, m: levels(g, s, m)[:2]


def auto_candidates(max_it: int) -> tuple:
    """The variants the timed ``auto`` probes: the int8 form too where it
    holds ``max_it`` levels (the JAX package adds it only where its SWAR
    form runs, on a TPU)."""
    if max_it <= FB.UNREACHED_E - 1:
        return ("fused8", "fused", "phased", "hybrid")
    return ("fused", "phased", "hybrid")


def _auto_variant(g: Graph, source: int, max_it: int) -> tuple:
    """JAX ``_auto_variant``: time one warm search of each candidate on the
    device's clock and cache the fastest by graph shape; without a
    symmetric layout there is nothing to probe (adaptive). Returns (the
    variant, {candidate: ms} of this call's probe, empty where the choice
    was cached or nothing was timed)."""
    key = ("bfs",) + _graph_key(g)
    v = _auto_cache.get(key)
    if v is not None:
        return v, {}
    if not fused_supported(g):
        _auto_cache[key] = "adaptive"
        return "adaptive", {}
    probe = {}
    for cand in auto_candidates(max_it):
        fn = _variant_fn(cand)
        fn(g, source, max_it)                        # warm
        timer = Timer(g.device).begin()
        fn(g, source, max_it)
        probe[cand] = timer.end()
    _auto_cache[key] = min(probe, key=probe.get)
    return _auto_cache[key], probe


@spanned("bfs.run")
def run(g: Graph, source: int, *, max_iterations: int | None = None,
        compute_predecessors: bool = True, warmup: bool = True,
        variant: str = "auto") -> BfsResult:
    """BFS from ``source`` on ``g``'s device.

    variant: 'fused' (int32 levels), 'fused8' (int8 levels when
    ``max_iterations <= 126``), 'hybrid' and 'phased' (spray and dense
    levels), 'adaptive' (the spray/dense frontier on the operator layer),
    or 'auto' (the timed probe of ``_auto_variant`` on a graph with a
    symmetric layout, 'adaptive' elsewhere). ``elapsed_ms`` covers the
    levels (and, for the edge-axis variants, the collapse to distances), on
    the device's clock (CUDA events) or the host's (CPU).

    Under a torch.profiler the call is the span ``bfs.run``, each level a
    ``bfs.level`` holding its kernels' ``kernel.*`` spans and its host read
    ``bfs.level.read`` (``runtime.span``); ``kernels.counters`` counts
    each ``bfs_level``'s form on the card."""
    throw_if(not 0 <= source < g.n_vertices,
             f"source {source} out of range [0, {g.n_vertices})")
    max_it = max_iterations if max_iterations is not None else g.n_vertices + 1
    if variant == "auto":
        variant, _ = _auto_variant(g, source, max_it)
    throw_if(variant not in VARIANTS, f"unknown bfs variant {variant!r}")
    throw_if(variant != "adaptive" and not fused_supported(g),
             f"bfs variant {variant!r} needs a graph with a symmetric "
             f"layout; use 'adaptive' or 'auto'")
    tiers, modes = (0, 0, 0), None
    if variant == "adaptive":
        throw_if(not g.has_csc, "adaptive bfs needs the CSC view")
        res = enact(step, default_converged, g, init(g, source),
                    max_iterations=max_it, warmup=warmup)
        dist, it, elapsed = res.state.distances, res.iterations, \
            res.elapsed_ms
        tiers = res.state.tiers
    elif variant in ("hybrid", "phased"):
        levels = (run_hybrid_levels if variant == "hybrid"
                  else run_phased_levels)
        if warmup:
            levels(g, source, max_it)
        timer = Timer(g.device).begin()
        dist, it, modes = levels(g, source, max_it)
        elapsed = timer.end()
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
    return BfsResult(dist[:v], pred, it, elapsed, tiers, modes)


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
