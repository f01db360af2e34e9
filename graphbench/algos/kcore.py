"""k-core queries: the program's entry, what a query counts, and its check.

A query is the user's call ``essentials_tpu_torch.algorithms.kcore.run(g,
warmup=False)`` with its default ``variant="auto"`` (``fused`` on the
symmetric layout); its answer is the core number of every vertex. Every
query asks the same question of the whole graph, so a query's source only
names the component whose edges ``gteps`` credits it with: on ``kron24``
the giant component holds 260,375,411 of the 260,378,274 undirected edges
(PERF.md §4), so a query is credited with the whole graph in all but about
0.06% of the draws.
"""

from __future__ import annotations

from graphbench import reference_kcore

ANSWER = ("core",)
# bytes a query must move, per undirected edge of the source's component
# (its two CSR slots read once, 4 B each) and per vertex (its offsets read
# and its core number written once)
EDGE_BYTES = 8
VERTEX_BYTES = 8

_last = None             # (csr, its core numbers): one reference a check


def _entry():
    from essentials_tpu_torch.algorithms import kcore
    return kcore


def warm(g, source: int, variant: str) -> tuple:
    """The set-up's first call, one decomposition without the program's
    own warm-up run: that one run builds the kernels and fills the caching
    allocator, and a second would only repeat it."""
    kcore = _entry()
    note = f"variant {variant}"
    if variant == "auto":
        note += " (fused)" if kcore.fused_supported(g) else " (adaptive)"
    return kcore.run(g, variant=variant, warmup=False), note


def query(g, source: int, variant: str):
    return _entry().run(g, variant=variant, warmup=False)


def answer(result) -> tuple:
    return (result.core,)


def levels(result) -> int:
    """The query's peel waves, one host read each."""
    return int(result.iterations)


def query_bytes(n_vertices: int, component_edges: int) -> int:
    """The least bytes a k-core query moves: each undirected edge's two
    CSR slots read once (8 B), each vertex's offsets read and its core
    number written once (8 B)."""
    return EDGE_BYTES * component_edges + VERTEX_BYTES * n_vertices


def expected(csr, src, source: int) -> tuple:
    """The reference's core numbers, computed once for ``csr`` and reused
    for every sampled answer: every query asks the same question."""
    global _last
    if _last is None or _last[0] is not csr:
        _last = (csr, reference_kcore.kcore(csr))
    return (_last[1],)


def control(csr, src, source: int) -> tuple:
    """The reference with one wave a level: no cascade inside a level k,
    so the vertices it would peel there are peeled a level late."""
    return (reference_kcore.kcore(csr, cascade=False),)
