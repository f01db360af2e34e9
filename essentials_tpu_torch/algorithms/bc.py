"""Betweenness centrality (Brandes).

Counterpart of ``essentials_tpu/algorithms/bc.py`` (reference parity:
gunrock::bc, bc.hxx:136-269): a forward BFS that accumulates the
shortest-path counts sigma level by level, then a backward pass that
accumulates the dependencies delta from the deepest level up. The levels
are implied by the depth labels. Both passes are host loops with one read
a level.

* ``generic`` runs on the operator layer, on any graph with a CSC view:
  a forward level is one ``advance`` SUM of sigma from the frontier (the
  ``gather_payloads`` and ``segment_reduce`` kernels), a backward level
  one ``neighbor_reduce`` SUM over the out-edges into the next level.
* ``spmv`` runs each level as one unit product of the SpMV engine
  (``spmv_fused``, the ``spmv_rows`` kernel), which computes the
  source-keyed sum: it needs A == A^T, a symmetric layout, and refuses
  other graphs (the JAX package quietly runs ``generic`` there).
* ``auto`` is ``spmv`` on a symmetric layout and ``generic`` elsewhere.

``run_all`` sums the single-source dependencies of many sources on the
generic path, chunk by chunk (``ops.batch.batch_execute``); it does not
pad the last chunk, as the JAX package does for its vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.advance import advance
from essentials_tpu_torch.ops.batch import batch_execute
from essentials_tpu_torch.ops.configs import Combine
from essentials_tpu_torch.ops.fused_spmv import spmv_fused
from essentials_tpu_torch.ops.neighborreduce import neighbor_reduce
from essentials_tpu_torch.utils.timer import Timer

UNSEEN = np.iinfo(np.int32).max
VARIANTS = ("spmv", "generic")


class BcResult(NamedTuple):
    bc_values: torch.Tensor      # [V] float32
    iterations: int              # BFS levels (run_all: sources)
    elapsed_ms: float


def _forward(g: Graph, source: int, max_depth: int, sigma_in) -> tuple:
    """(depth [Vp] int32, sigma [Vp] float32, levels): the BFS levels from
    ``source`` and each vertex's count of shortest paths, ``sigma_in(
    frontier, sigma)`` giving each vertex's sum of sigma over its in-edges
    from the frontier."""
    vp = g.n_vertices_padded
    mask = g.vertex_mask()
    depth = torch.full((vp,), UNSEEN, dtype=torch.int32, device=g.device)
    depth[source] = 0
    sigma = torch.zeros(vp, dtype=torch.float32, device=g.device)
    sigma[source] = 1.0
    frontier = torch.zeros(vp, dtype=torch.bool, device=g.device)
    frontier[source] = True
    it, live = 0, True
    while it < max_depth and live:
        sig = sigma_in(frontier, sigma)
        newly = (depth == UNSEEN) & (sig > 0) & mask
        depth = torch.where(newly, it + 1, depth)
        sigma = torch.where(newly, sig, sigma)
        frontier = newly
        live = bool(newly.any())
        it += 1
    return depth, sigma, it


def _single_source_deps(g: Graph, source: int, max_depth: int) -> tuple:
    """JAX ``_single_source_deps``: (delta [Vp] float32, depth, levels) on
    the operator layer."""
    def sigma_in(frontier, sigma):
        return advance(g, lambda e: e.src_vals[0], frontier,
                       src_values=(sigma,), combine=Combine.SUM,
                       with_frontier=False)

    depth, sigma, levels = _forward(g, source, max_depth, sigma_in)
    delta = torch.zeros_like(sigma)
    for d in range(levels, 0, -1):
        # contribution to the vertices at depth d - 1 from their
        # successors at depth d
        ratio = (1.0 + delta) / torch.clamp(sigma, min=1e-30)

        def edge_val(e, d=d):
            ok = (e.src_vals[0] == d - 1) & (e.dst_vals[0] == d)
            return torch.where(ok, e.src_vals[1] * e.dst_vals[1], 0.0)

        contrib = neighbor_reduce(g, edge_val, src_values=(depth, sigma),
                                  dst_values=(depth, ratio),
                                  combine=Combine.SUM)
        delta = torch.where(depth == d - 1, contrib, delta)
    delta[source] = 0.0
    return delta, depth, levels


def spmv_supported(g: Graph) -> bool:
    """The SpMV-engine levels need A == A^T (a symmetric layout)."""
    return bool(g.symmetric_layout)


def _single_source_deps_spmv(g: Graph, source: int, max_depth: int) -> tuple:
    """JAX ``_single_source_deps_spmv``: each forward and backward level is
    one unit SpMV (``spmv_fused``)."""
    def sigma_in(frontier, sigma):
        return spmv_fused(g, torch.where(frontier, sigma, 0.0), unit=True)

    depth, sigma, levels = _forward(g, source, max_depth, sigma_in)
    delta = torch.zeros_like(sigma)
    for d in range(levels, 0, -1):
        ratio = (1.0 + delta) / torch.clamp(sigma, min=1e-30)
        y = spmv_fused(g, torch.where(depth == d, ratio, 0.0), unit=True)
        delta = torch.where(depth == d - 1, sigma * y, delta)
    delta[source] = 0.0
    return delta, depth, levels


def run(g: Graph, source: int, *, max_depth: int | None = None,
        warmup: bool = True, variant: str = "auto") -> BcResult:
    """Single-source BC contribution from ``source`` on ``g``'s device.
    variant: 'spmv' (needs a symmetric layout), 'generic', or 'auto'
    ('spmv' where it is supported). ``elapsed_ms`` is on the device's
    clock (CUDA events) or the host's (CPU)."""
    throw_if(not 0 <= source < g.n_vertices,
             f"source {source} out of range [0, {g.n_vertices})")
    md = max_depth or g.n_vertices + 1
    if variant == "auto":
        variant = "spmv" if spmv_supported(g) else "generic"
    throw_if(variant not in VARIANTS, f"unknown bc variant {variant!r}")
    throw_if(variant == "spmv" and not spmv_supported(g),
             "bc variant 'spmv' needs a graph with a symmetric layout (on "
             "another graph it would give wrong values); use 'generic' or "
             "'auto'")
    deps = (_single_source_deps_spmv if variant == "spmv"
            else _single_source_deps)
    if warmup:
        deps(g, source, md)
    timer = Timer(g.device).begin()
    delta, _, levels = deps(g, source, md)
    ms = timer.end()
    return BcResult(delta[:g.n_vertices], levels, ms)


def run_all(g: Graph, *, sources=None, chunk: int = 32,
            max_depth: int | None = None, normalize_undirected: bool = True,
            warmup: bool = True) -> BcResult:
    """BC summed over ``sources`` (every vertex by default) on the generic
    path: each chunk's single-source dependencies stacked and summed, the
    chunks' sums added in order, as the JAX package's vmapped chunks;
    halved when ``normalize_undirected``."""
    md = max_depth or g.n_vertices + 1
    sources = np.arange(g.n_vertices) if sources is None else \
        np.asarray(sources)

    def deps(s):
        return _single_source_deps(g, s, md)[0]

    if warmup:
        deps(int(sources[0]))
    timer = Timer(g.device).begin()
    total = torch.zeros(g.n_vertices_padded, dtype=torch.float32,
                        device=g.device)
    for i in range(0, len(sources), chunk):
        total = total + batch_execute(deps, sources[i:i + chunk]).sum(0)
    if normalize_undirected:
        total = total * 0.5
    ms = timer.end()
    return BcResult(total[:g.n_vertices], len(sources), ms)


def cpu_reference(csr, sources=None, normalize_undirected: bool = True
                  ) -> np.ndarray:
    """Host Brandes in float64 (reference parity: examples/algorithms/bc/
    bc_cpu.hxx), vectorised over NumPy arrays level by level: sigma and
    delta move along every out-edge of a level at once (bincounts over the
    edges, each edge counted)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    sources = range(n) if sources is None else sources
    bc = np.zeros(n)

    def out_edges(u):
        lens = off[u + 1] - off[u]
        pos = (np.repeat(off[u] - np.cumsum(lens) + lens, lens)
               + np.arange(int(lens.sum()), dtype=np.int64))
        return np.repeat(u, lens), cols[pos]

    for s in sources:
        dist = np.full(n, -1, np.int64)
        dist[s] = 0
        sigma = np.zeros(n)
        sigma[s] = 1.0
        levels = [np.asarray([s], np.int64)]
        while True:
            u, v = out_edges(levels[-1])
            d = len(levels) - 1
            fresh = np.unique(v[dist[v] < 0])
            dist[fresh] = d + 1
            on = dist[v] == d + 1
            sigma += np.bincount(v[on], weights=sigma[u[on]], minlength=n)
            if fresh.size == 0:
                break
            levels.append(fresh)
        delta = np.zeros(n)
        for d in range(len(levels) - 2, -1, -1):
            u, v = out_edges(levels[d])
            on = dist[v] == d + 1
            delta += np.bincount(u[on], weights=sigma[u[on]] / sigma[v[on]]
                                 * (1.0 + delta[v[on]]), minlength=n)
        delta[s] = 0.0
        bc += delta
    if normalize_undirected:
        bc *= 0.5
    return bc.astype(np.float32)
