"""Operators. Counterpart of ``essentials_tpu/ops``: the operator layer
(``advance``, ``neighbor_reduce``, the ``segment`` engine,
``scan_kernels``, the ``sparse_advance`` spray tiers), the fused engines
``fused_bfs``, ``fused_spmv``, ``windowed_spmv``, ``fused_sssp``,
``windowed_sssp`` and ``fused_kcore``, the intersection operator
``intersect`` on ``bitmap_intersect``, ``batch`` (a host loop over seeds),
``filter``, ``parallel_for``, ``uniquify`` and ``advance_edges``. Not
carried: ``bucketed`` and ``swar``, TPU schedules (ROADMAP.md, queue 1)."""

from essentials_tpu_torch.ops import (batch, bitmap_intersect, fused_bfs,
                                      fused_kcore, fused_sssp, fused_spmv,
                                      intersect, scan_kernels, segment,
                                      sparse_advance, windowed_spmv,
                                      windowed_sssp)
from essentials_tpu_torch.ops.advance import (Edges, advance, advance_count,
                                              advance_edges, advance_multi)
from essentials_tpu_torch.ops.batch import batch_execute
from essentials_tpu_torch.ops.configs import AdvanceIO, Combine
from essentials_tpu_torch.ops.filter import filter_frontier
from essentials_tpu_torch.ops.neighborreduce import neighbor_reduce
from essentials_tpu_torch.ops.parallel_for import (for_each_edge,
                                                   for_each_vertex)
from essentials_tpu_torch.ops.segment import (apply_permutation,
                                              combine_by_offsets,
                                              combine_minmax_multi,
                                              expand_vertex_to_edges,
                                              segment_combine)
from essentials_tpu_torch.ops.uniquify import uniquify

__all__ = [
    "Combine", "AdvanceIO", "advance", "advance_multi", "advance_edges",
    "advance_count", "Edges", "filter_frontier", "for_each_vertex",
    "for_each_edge", "uniquify", "neighbor_reduce", "batch_execute",
    "combine_by_offsets", "combine_minmax_multi", "expand_vertex_to_edges", "apply_permutation", "segment_combine",
    "batch", "bitmap_intersect", "fused_bfs", "fused_kcore",
    "fused_sssp", "fused_spmv", "intersect", "scan_kernels", "segment",
    "sparse_advance", "windowed_spmv", "windowed_sssp",
]
