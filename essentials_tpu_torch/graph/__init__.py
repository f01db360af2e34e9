"""Device graph: a frozen dataclass of tensors in CSR and CSC order.

Counterpart of ``essentials_tpu/graph``: ``graph`` (the padded Graph and its
builders), ``analytics`` (degree statistics), ``convert`` (offsets <->
indices) and ``validate`` (host checks of a Csr).
"""

from essentials_tpu_torch.graph.analytics import (
    average_degree, degree_histogram, degree_standard_deviation)
from essentials_tpu_torch.graph.graph import (
    Graph, GraphProperties, build_graph, graph_from_arrays)

__all__ = ["Graph", "GraphProperties", "build_graph", "graph_from_arrays",
           "average_degree", "degree_standard_deviation", "degree_histogram"]
