"""Minimum spanning forest (Borůvka).

Counterpart of ``essentials_tpu/algorithms/mst.py`` (reference parity:
gunrock::mst, mst.hxx:95-260). Each round, on the CSR edge axis:

* each edge's source and destination component: ``comp`` expanded over the
  CSR segments (the ``expand_segments`` kernel) and gathered through
  ``col_indices`` (the ``gather_payloads`` kernel; the JAX package expands
  over the CSC segments and routes to CSR order);
* per vertex, the lexicographic-min cross edge (weight, then destination),
  its edge id and its target component: four MINs over the CSR segments
  (the ``segment_reduce`` kernel) and two expansions of their results;
* per component, the winner of the (comp, weight, cu, cv) order by two
  stable ``torch.sort`` passes over packed int64 keys, then the hooks, the
  mutual-hook break and the chosen edges by ``index_put_``, and a fixed
  number of pointer jumps.

Weight ties break on the canonical undirected edge key (cu, cv), so both
endpoints of a tie agree on one edge and the result is deterministic. The
round's one host read is ``converged``.

Works on undirected graphs stored with both directed copies present.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.framework.enactor import enact
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.configs import Combine
from essentials_tpu_torch.ops.segment import (combine_by_offsets,
                                              expand_vertex_to_edges, gather)

INT_MAX = 2**31 - 1


class MstState(NamedTuple):
    comp: torch.Tensor       # int32[Vp] component (root) per vertex
    in_mst: torch.Tensor     # bool[Ep] chosen edges (CSR edge-id order)
    changed: torch.Tensor    # bool []: did the last round merge anything
    eid: torch.Tensor        # int32[Ep] CSR edge ids, made once by init


class MstResult(NamedTuple):
    in_mst: torch.Tensor     # bool[E] over CSR edge ids (one direction chosen)
    total_weight: float
    iterations: int
    elapsed_ms: float


def init(g: Graph) -> MstState:
    dev = g.device
    comp = torch.arange(g.n_vertices_padded, dtype=torch.int32, device=dev)
    return MstState(comp, torch.zeros(g.n_edges_padded, dtype=torch.bool,
                                      device=dev),
                    torch.tensor(True, device=dev),
                    torch.arange(g.n_edges_padded, dtype=torch.int32,
                                 device=dev))


def jump_depth(vp: int) -> int:
    """Pointer jumps a round: enough to flatten any forest of ``vp``
    vertices, and a bound that turns a hook cycle (an "undirected" input
    with asymmetric weights) into a wrong but terminating answer."""
    return max(int(np.ceil(np.log2(max(vp, 2)))), 1) + 2


def _float_order_key(w: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> int32 map (signed comparison)."""
    i = w.float().contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _expand(g: Graph, v: torch.Tensor) -> torch.Tensor:
    return expand_vertex_to_edges(v, g.row_offsets, g.n_edges_padded)


def _combine_min(g: Graph, vals: torch.Tensor) -> torch.Tensor:
    return combine_by_offsets(vals, g.row_offsets, Combine.MIN)


def _lexsort_rows(comp, wmin, cu, cv) -> torch.Tensor:
    """The order of the [Vp] rows by (comp, wmin, cu, cv): a stable sort on
    (cu << 32 | cv), then one on (comp << 32 | wmin + 2^31) (wmin offset so
    that it orders as unsigned). The four keys are distinct across the rows
    (two vertices of one component cannot share {cu, cv} across a cross
    edge, and a row that does not win has cu equal to its own id), so any
    correct lexicographic order equals the JAX package's sort."""
    inner = (cu.long() << 32) | cv.long()
    o1 = torch.sort(inner, stable=True).indices
    outer = (comp.long() << 32) | (wmin.long() + 2**31)
    o2 = torch.sort(outer[o1], stable=True).indices
    return o1[o2]


def step(g: Graph, state: MstState, it: int) -> MstState:
    """One Borůvka round: per vertex its lexicographic-min cross edge
    (weight, then destination; valid before the component level because
    comp is constant over a vertex's out-edges), per component the winner
    of one (comp, w, cu, cv) order, then the hooks and the jumps."""
    comp, in_mst, _, eid = state
    vp, ep = g.n_vertices_padded, g.n_edges_padded
    dev = g.device
    iota_v = torch.arange(vp, dtype=torch.int32, device=dev)
    col = g.col_indices

    # --- edge level: min over each vertex's CSR segment ---
    comp_src = _expand(g, comp)
    comp_dst = gather(col, comp)[0]
    cross = (comp_src != comp_dst) & (eid < g.n_edges)

    wkey = torch.where(cross, _float_order_key(g.values), INT_MAX)
    wmin_v = _combine_min(g, wkey)                          # [Vp]
    wmin_e = _expand(g, torch.where(wmin_v == INT_MAX, INT_MAX - 1, wmin_v))
    at_min = cross & (wkey == wmin_e)
    dmin_v = _combine_min(g, torch.where(at_min, col, INT_MAX))
    dmin_e = _expand(g, torch.where(dmin_v == INT_MAX, INT_MAX - 1, dmin_v))
    at_win = at_min & (col == dmin_e)
    emin_v = _combine_min(g, torch.where(at_win, eid, INT_MAX))   # winner eid
    tcomp_v = _combine_min(g, torch.where(at_win, comp_dst, INT_MAX))

    # --- vertex level: per-component lexicographic (w, cu, cv) winner;
    # group heads are the argmins ---
    cu = torch.minimum(iota_v, dmin_v)
    cv = torch.maximum(iota_v, dmin_v)
    order = _lexsort_rows(comp, wmin_v, cu, cv)
    comp_s, w_s = comp[order], wmin_v[order]
    e_s, t_s = emin_v[order], tcomp_v[order]
    head = torch.ones(vp, dtype=torch.bool, device=dev)
    head[1:] = comp_s[1:] != comp_s[:-1]
    winner = head & (w_s < INT_MAX)

    # hook each winning root under its target root (unique root slots; the
    # others write a spare last slot)
    parent = torch.cat([iota_v, iota_v[:1]])
    parent.index_put_((torch.where(winner, comp_s, vp).long(),),
                      torch.where(winner, t_s, 0))
    parent = parent[:vp]

    # resolve mutual hooks: the smaller root stays a root
    mutual = (parent[parent.long()] == iota_v) & (iota_v < parent)
    parent = torch.where(mutual, iota_v, parent)

    # record each actually-hooking component's chosen edge (the mutual
    # winner stays a root; its partner records their shared edge)
    hooked_root = parent != iota_v                          # [Vp] by root id
    rec = winner & hooked_root[comp_s.long()]
    chosen = torch.zeros(ep + 1, dtype=torch.bool, device=dev)
    chosen[torch.where(rec, e_s, ep).long()] = True
    in_mst = in_mst | chosen[:ep]

    # pointer jumping, a fixed number of jumps with no host read: a flat
    # forest stays flat, so this equals the JAX package's loop that stops
    # when flat or at the same bound
    p = parent.long()
    for _ in range(jump_depth(vp)):
        p = p[p]
    return MstState(p[comp.long()].int(), in_mst, winner.any(), eid)


def converged(g: Graph, state: MstState, it: int) -> bool:
    return not bool(state.changed)


def run(g: Graph, *, max_iterations: int | None = None,
        warmup: bool = True) -> MstResult:
    """Borůvka rounds until none merges. ``elapsed_ms`` covers the rounds,
    on the device's clock (CUDA events) or the host's (CPU);
    ``total_weight`` is the float32 sum of the chosen weights."""
    max_it = max_iterations if max_iterations is not None else \
        max(int(np.ceil(np.log2(max(g.n_vertices, 2)))) + 2, 3)
    res = enact(step, converged, g, init(g), max_iterations=max_it,
                warmup=warmup)
    in_mst = res.state.in_mst[:g.n_edges]
    total = float(torch.where(in_mst, g.values[:g.n_edges], 0.0).sum())
    return MstResult(in_mst, total, res.iterations, res.elapsed_ms)


def _one_copy(csr) -> tuple:
    """(u, v, w) with u < v, one entry per undirected vertex pair, the
    lightest of its copies."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    vals = np.asarray(csr.values, np.float64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(off))
    keep = src < cols
    u, v, w = src[keep], cols[keep], vals[keep]
    key = u * n + v
    if np.all(key[1:] > key[:-1]):          # sorted and without multi-edges
        return u, v, w
    order = np.lexsort((w, v, u))
    u, v, w = u[order], v[order], w[order]
    first = np.ones(u.size, bool)
    first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    return u[first], v[first], w[first]


def cpu_reference(csr) -> float:
    """Host minimum spanning forest total in float64, vectorised:
    ``scipy.sparse.csgraph.minimum_spanning_tree`` over one copy of each
    undirected edge (the lightest of its copies, as the JAX package's
    Kruskal takes it). scipy drops zero weights; the generators' weights
    are at least 1."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    n = csr.n_rows
    u, v, w = _one_copy(csr)
    if w.size == 0:
        return 0.0
    tree = minimum_spanning_tree(csr_matrix((w, (u, v)), shape=(n, n)))
    return float(np.sum(tree.data, dtype=np.float64))


def forest_check(csr, in_mst: np.ndarray) -> tuple:
    """(edges chosen, components of the graph, components of the chosen
    edges): ``in_mst`` is a spanning forest where the three are
    (V - c, c, c)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(off))
    ones = np.ones(cols.size, np.int8)
    c_graph = connected_components(csr_matrix((ones, cols, off),
                                              shape=(n, n)),
                                   directed=False)[0]
    pick = np.asarray(in_mst, bool)
    c_tree = connected_components(csr_matrix(
        (ones[pick], (src[pick], cols[pick])), shape=(n, n)),
        directed=False)[0]
    return int(pick.sum()), int(c_graph), int(c_tree)
