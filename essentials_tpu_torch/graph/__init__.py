"""Device graph: a frozen dataclass of tensors in CSR and CSC order.

Counterpart of ``essentials_tpu/graph`` (``graph.py`` only; ``analytics``,
``convert`` and ``validate`` are not ported yet).
"""

from essentials_tpu_torch.graph.graph import (
    Graph, GraphProperties, build_graph, graph_from_arrays)

__all__ = ["Graph", "GraphProperties", "build_graph", "graph_from_arrays"]
