"""essentials_tpu_torch — the PyTorch and CUDA port of essentials_tpu.

The JAX package ``essentials_tpu`` stays the reference; this package runs the
same system with PyTorch around hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``). It mirrors the JAX package's layout and names, module for
module, and imports neither JAX nor the JAX package.

Every module of the JAX package's single-chip path is ported: the host
inputs (``formats``, ``io`` with the native ``.mtx`` parser of ``native``),
the padded ``graph`` with its ``analytics``, ``convert`` and ``validate``,
the operator layer (``ops``: advance, filter, parallel_for, uniquify,
neighbor_reduce, segment, scans, the spray tiers, batch; ``frontier``;
``framework`` with its ``Problem`` wrapper), the thirteen algorithms on the
CUDA kernels of ``csrc/`` (``kernels`` builds and binds them), ``runtime``
(device properties, ``torch.profiler`` traces), ``utils`` (compare, timer,
stats, checkpoints) and the command-line driver ``cli``
(``essentials-tpu-torch``), and the scale-out layer ``parallel``: 1-D
vertex partitions (``partition_graph``) and ``dist_bfs`` / ``dist_sssp`` /
``dist_pagerank`` with one process per device over ``torch.distributed``
(NCCL between cards, gloo between CPU processes). Every function takes its
device from its arguments: a graph's or a tensor's, or, for the entry
points that start from a host ``Csr`` (``tc.run``, ``intersect``,
``spgemm``, ``DistGraph.local``, ``multihost.initialize``), a ``device``
argument that defaults to CUDA; the CLI runs on the card unless ``--cpu``
is given.
"""

__version__ = "0.1.0"

from essentials_tpu_torch import (algorithms, formats, framework, frontier,
                                  graph, io, ops, parallel, runtime, utils)
from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.graph import Graph, build_graph, graph_from_arrays

__all__ = [
    "algorithms", "formats", "framework", "frontier", "graph", "io", "ops",
    "parallel", "runtime", "utils", "Graph", "build_graph",
    "graph_from_arrays", "EssentialsError", "throw_if",
]
