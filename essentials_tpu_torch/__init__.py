"""essentials_tpu_torch — the PyTorch and CUDA port of essentials_tpu.

The JAX package ``essentials_tpu`` stays the reference; this package runs the
same system with PyTorch around hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``). It mirrors the JAX package's layout and names, module for
module, and imports neither JAX nor the JAX package.

Ported so far: the host inputs (``formats``, ``io``), the padded ``graph``,
BFS on the fused edge-axis superstep (``csrc/bfs_kernels.cu``), SpMV with
PageRank and HITS on it (``csrc/spmv_kernels.cu``), SSSP and k-core
(``csrc/sssp_kcore_kernels.cu``), and the operator layer (``ops`` advance,
neighbor_reduce, segment, scans, the spray tiers; ``frontier``;
``framework``) with BFS and SSSP ``adaptive`` and SpMV ``pull``/``push`` on
it (``csrc/operator_kernels.cu``), PageRank ``fused`` on the segment fill
of ``csrc/bfs_kernels.cu``, triangle counting with the intersection
operator (``csrc/tc_kernels.cu``), and on the kernels above the rest of the
thirteen algorithms (BFS ``hybrid``/``phased``, k-core ``adaptive``, color,
BC, PPR, MST, geolocation, SpGEMM); ``kernels`` builds and binds the CUDA
sources. Every function takes its device from its arguments: a graph's or a
tensor's, or, for the entry points that start from a host ``Csr``
(``tc.run``, ``intersect``, ``spgemm``), a ``device`` argument that
defaults to CUDA.
"""

__version__ = "0.1.0"

from essentials_tpu_torch import (algorithms, formats, framework, frontier,
                                  graph, io, ops, utils)
from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.graph import Graph, build_graph, graph_from_arrays

__all__ = [
    "algorithms", "formats", "framework", "frontier", "graph", "io", "ops",
    "utils", "Graph", "build_graph",
    "graph_from_arrays", "EssentialsError", "throw_if",
]
