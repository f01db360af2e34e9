"""Operator configuration enums.

Counterpart of ``essentials_tpu/ops/configs.py:15-30`` (reference parity:
operators/configs.hxx:31-92). What remains of the reference's options is the
combine monoid and the kind of input an advance takes.
"""

from __future__ import annotations

import enum


class Combine(str, enum.Enum):
    """Deterministic segment-combine monoid replacing the reference's
    user-side atomics (atomicMin/Max/Add relaxations)."""
    MIN = "min"
    MAX = "max"
    SUM = "sum"
    OR = "or"
    AND = "and"


class AdvanceIO(str, enum.Enum):
    """Reference parity: advance_io_type_t {graph, vertices, edges, none}."""
    GRAPH = "graph"        # all edges active (frontier ignored)
    VERTICES = "vertices"  # vertex boolmap frontier
    EDGES = "edges"        # edge boolmap frontier (CSR edge-id order)
    NONE = "none"          # no output frontier materialized
