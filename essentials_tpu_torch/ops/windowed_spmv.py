"""Windowed SpMV: y = A @ x balanced by edges, slab by slab.

Counterpart of ``essentials_tpu/ops/windowed_spmv.py``. The JAX pipeline
cuts the edge axis into 131,072-edge slabs and, per slab, windows a
compacted x table, places it with a static Beneš permutation, routes CSC ->
CSR and reduces; a ``WindowedSpmvPlan`` carries those permutations and the
vertex-axis compaction routes. All of that is TPU staging. Here one launch of
the ``spmv_slabs`` kernel gives each block a fixed range of SLAB_EDGES CSR
edges, loads ``x[col[p]]`` directly, scans over the segment flags and
stores y by vertex; a row that crosses slab boundaries is folded in slab
order by a hand-off from slab to slab. So the port takes no plan, and x and y are on the vertex axis,
where the JAX functions take and return compact rank-space vectors.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.fused_spmv import edge_weights, vertex_vector

INF_BITS = kernels.INF_BITS        # identity of ``min`` (float32 +inf bits)


def windowed_pipeline(g: Graph, x: torch.Tensor, *, message: str,
                      reduce: str, w: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The edge-axis pipeline: message, then reduce per CSR row.

    Returns [Vp] int32 bits: y[s] = reduce over CSR segment s of
    ``message(x[col[e]], w[e])``, the identity at empty rows (0 for
    ``sum``, INF_BITS for ``min``). message: ``mul`` (x * w, SpMV and
    PageRank), ``add`` (x + w, the SSSP relax) or ``none`` (x alone,
    unweighted HITS and BC sums, which read no weights). reduce: ``sum`` in
    float32 (the bits of the float) or ``min`` of the int32 bit patterns,
    which is the float order for non-negative values. ``w`` is [Ep]
    float32 in CSR order; None means the graph's weights. The pad vertex
    owns the pad edges, whose weight is 0, so y[pad] reduces
    ``message(x[pad], 0)`` over them; compare y[:V]."""
    if message == "none":
        w = None
    elif w is None:
        w = edge_weights(g)
    return kernels.spmv_slabs(g.row_offsets, g.col_indices, w,
                              g.csr_seg_flags, vertex_vector(g, x), message,
                              reduce)


def spmv_windowed(g: Graph, x: torch.Tensor, *, unit: bool = False
                  ) -> torch.Tensor:
    """y = A @ x on the windowed pipeline: [Vp] float32, the same contract
    as ``fused_spmv.spmv_fused``. ``unit=True`` drops the weight."""
    y = windowed_pipeline(g, x, message="none" if unit else "mul",
                          reduce="sum")
    return y.view(torch.float32)
