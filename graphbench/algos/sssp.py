"""SSSP queries: the program's entry, what a query counts, and its check.

A query is the user's call ``essentials_tpu_torch.algorithms.sssp.run(g,
source, warmup=False)`` with its default ``variant="auto"`` (a fixed rule:
``windowed`` on an undirected graph); its answer is the float32 distances
and the predecessors derived from them.
"""

from __future__ import annotations

import torch

from graphbench import reference

ANSWER = ("dist", "pred")
# bytes a query must move, per undirected edge of the source's component
# (a vertex id and a float32 weight read) and per vertex (a distance and a
# predecessor written)
EDGE_BYTES = 8
VERTEX_BYTES = 8


def _entry():
    from essentials_tpu_torch.algorithms import sssp
    return sssp


def warm(g, source: int, variant: str) -> tuple:
    sssp = _entry()
    note = f"variant {variant}"
    if variant == "auto":
        note += (" (windowed)" if sssp.windowed_supported(g)
                 else " (not windowed)")
    return sssp.run(g, source, variant=variant), note


def query(g, source: int, variant: str):
    return _entry().run(g, source, variant=variant, warmup=False)


def answer(result) -> tuple:
    return result.distances, result.predecessors


def levels(result) -> int:
    return int(result.iterations)


def query_bytes(n_vertices: int, component_edges: int) -> int:
    """The least bytes an SSSP query moves: each undirected edge of the
    source's component read once (an id and a weight), the [V] distances
    and predecessors written once."""
    return EDGE_BYTES * component_edges + VERTEX_BYTES * n_vertices


def expected(csr, src, source: int) -> tuple:
    return reference.bellman_ford(csr, src, source)


def control(csr, src, source: int) -> tuple:
    """The reference in bfloat16, the nearest precision below the
    configuration's float32."""
    return reference.bellman_ford(csr, src, source, dtype=torch.bfloat16)
