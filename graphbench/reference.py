"""The plain reference: BFS and Bellman-Ford in PyTorch over the benchmark's
own CSR, with predecessors by the rules the program documents.

It imports nothing but torch: not JAX, not the JAX package and nothing of
the program under test (not its kernels' plain versions, not its
``cpu_reference``). It reads the benchmark's CSR (``graphs.Csr``: offsets,
columns, weights) and the [E] source row of each edge, walks the edges in
chunks so that it fits beside the graph, and runs after the measured
window.

* BFS: level-synchronous; a vertex's level is one more than the level of
  the first frontier that reaches it. Its predecessor is the smallest-id
  in-neighbour one level up; -1 at the source and at unreached vertices
  (``bfs.py:5-8`` and ``kernels.bfs_predecessors``).
* SSSP: Bellman-Ford sweeps (Jacobi) in float32, each candidate the float32
  sum dist[u] + w(u, v), until a sweep lowers nothing. Every order of
  relaxation reaches the same least fixpoint, the least float32 path sum
  folded from the source, so the distances are exact, bit for bit. The
  predecessor is the smallest-id in-neighbour u with dist[u] + w(u, v) ==
  dist[v] in float32; -1 unless dist[v] is finite and above 0
  (``sssp.py:9-13`` and ``kernels.sssp_predecessors``).

The controls are the same code with one guarantee broken: BFS predecessors
by the largest-id in-neighbour (a valid BFS tree that breaks the
smallest-id rule), and SSSP in bfloat16 (weights and sums), the nearest
precision below the configuration's float32.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
CHUNK = 1 << 26


def _chunks(n_edges: int):
    for lo in range(0, n_edges, CHUNK):
        yield slice(lo, min(lo + CHUNK, n_edges))


def bfs(csr, src: torch.Tensor, source: int, *, largest_parent: bool = False
        ) -> tuple:
    """(dist [V] int32, INT32_MAX where unreached; pred [V] int32)."""
    n, col = csr.n, csr.col
    dist = torch.full((n,), INT32_MAX, dtype=torch.int32, device=col.device)
    dist[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=col.device)
    frontier[source] = True
    level = 0
    while bool(frontier.any()):
        reached = torch.zeros(n, dtype=torch.bool, device=col.device)
        for c in _chunks(csr.n_edges):
            hit = col[c][frontier[src[c].long()]]
            reached[hit.long()] = True
        newly = reached & (dist == INT32_MAX)
        level += 1
        dist[newly] = level
        frontier = newly
    return dist, _bfs_parents(csr, src, dist, largest_parent)


def _bfs_parents(csr, src, dist, largest: bool) -> torch.Tensor:
    fill = -1 if largest else INT32_MAX
    best = torch.full((csr.n,), fill, dtype=torch.int64, device=dist.device)
    for c in _chunks(csr.n_edges):
        u, v = src[c].long(), csr.col[c].long()
        du = dist[u].long()
        ok = (du != INT32_MAX) & (du + 1 == dist[v].long())
        best.scatter_reduce_(0, v, torch.where(ok, u, fill),
                             "amax" if largest else "amin")
    valid = (dist != INT32_MAX) & (dist > 0) & (best != fill)
    return torch.where(valid, best, -1).int()


def bellman_ford(csr, src: torch.Tensor, source: int, *,
                 dtype: torch.dtype = torch.float32) -> tuple:
    """(dist [V] float32, +inf where unreached; pred [V] int32), the sums
    taken in ``dtype`` (float32; bfloat16 for the control)."""
    n, col = csr.n, csr.col
    inf = float("inf")
    dist = torch.full((n,), inf, dtype=dtype, device=col.device)
    dist[source] = 0
    while True:
        cand = torch.full((n,), inf, dtype=dtype, device=col.device)
        for c in _chunks(csr.n_edges):
            w = csr.values[c].to(dtype)
            cand.scatter_reduce_(0, src[c].long(), dist[col[c].long()] + w,
                                 "amin")
        new = torch.minimum(dist, cand)
        if torch.equal(new, dist):
            break
        dist = new
    best = torch.full((n,), INT32_MAX, dtype=torch.int64, device=col.device)
    for c in _chunks(csr.n_edges):
        u, v = src[c].long(), col[c].long()
        ok = dist[u] + csr.values[c].to(dtype) == dist[v]
        best.scatter_reduce_(0, v, torch.where(ok, u, INT32_MAX), "amin")
    valid = torch.isfinite(dist) & (dist > 0) & (best != INT32_MAX)
    return dist.float(), torch.where(valid, best, -1).int()
