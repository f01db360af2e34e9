"""BFS queries: the program's entry, what a query counts, and its check.

A query is the user's call ``essentials_tpu_torch.algorithms.bfs.run(g,
source, warmup=False)`` with its default predecessors, as the program's CLI
makes it after its first call; its answer is the distances and the
predecessors. The set-up's warm call is the CLI's first call
(``warmup=True``), in which ``variant="auto"`` times its candidates once per
process.
"""

from __future__ import annotations

from graphbench import reference

ANSWER = ("dist", "pred")
# bytes a query must move, per undirected edge of the source's component
# (one vertex id read) and per vertex (a distance and a predecessor written)
EDGE_BYTES = 4
VERTEX_BYTES = 8


def _entry():
    from essentials_tpu_torch.algorithms import bfs
    return bfs


def warm(g, source: int, variant: str) -> tuple:
    """The set-up's first call: (result, a line on what ``auto`` chose and
    the times of its probe, where the program exposes them)."""
    bfs = _entry()
    note = f"variant {variant}"
    if variant == "auto":
        try:
            choice, probe = bfs._auto_variant(g, source, g.n_vertices + 1)
            note = (f"auto probe chose {choice}; probe ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in probe.items()))
        except (AttributeError, TypeError, ValueError) as err:
            note = f"auto probe not readable ({err!r})"
    return bfs.run(g, source, variant=variant), note


def query(g, source: int, variant: str):
    return _entry().run(g, source, variant=variant, warmup=False)


def answer(result) -> tuple:
    return result.distances, result.predecessors


def levels(result) -> int:
    return int(result.iterations)


def query_bytes(n_vertices: int, component_edges: int) -> int:
    """The least bytes a BFS query moves: each undirected edge of the
    source's component read once, the [V] distances and predecessors
    written once."""
    return EDGE_BYTES * component_edges + VERTEX_BYTES * n_vertices


def expected(csr, src, source: int) -> tuple:
    return reference.bfs(csr, src, source)


def control(csr, src, source: int) -> tuple:
    """The reference with the smallest-id predecessor rule broken (the
    largest-id in-neighbour one level up: still a BFS tree)."""
    return reference.bfs(csr, src, source, largest_parent=True)
