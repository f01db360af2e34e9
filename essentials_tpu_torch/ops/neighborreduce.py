"""neighbor_reduce: per-vertex reduction over incident out-edges.

Counterpart of ``essentials_tpu/ops/neighborreduce.py:27-77`` (reference
parity: operators::neighborreduce::execute). The mirror of advance on the
CSR side: source-keyed arrays are gathered through ``src_indices`` and
destination-keyed ones through ``col_indices`` (the ``gather_payloads``
kernel), and the combine runs per source over ``row_offsets`` (the
``segment_reduce`` kernel). This is SpMV's engine: y[s] = reduce over
(s->d, w) of w * x[d].
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.advance import Edges, edge_array
from essentials_tpu_torch.ops.configs import Combine
from essentials_tpu_torch.ops.segment import (combine_by_offsets,
                                              combine_identity, gather)


def neighbor_reduce(g: Graph, message_fn: Callable, *,
                    src_values: Sequence[torch.Tensor] = (),
                    dst_values: Sequence[torch.Tensor] = (),
                    combine: Combine = Combine.SUM) -> torch.Tensor:
    """``message_fn(Edges) -> per-edge values`` ([Ep], CSR order: src
    sorted); returns the [Vp] per-source combine (the identity at sourceless
    and pad slots)."""
    src_vals = gather(g.src_indices, *src_values) if src_values else ()
    dst_vals = gather(g.col_indices, *dst_values) if dst_values else ()
    eids = torch.arange(g.n_edges_padded, dtype=torch.int32, device=g.device)
    edges = Edges(src=g.src_indices, dst=g.col_indices, eid=eids,
                  weight=g.values, active=g.edge_mask(), src_vals=src_vals,
                  dst_vals=dst_vals)
    vals = edge_array(message_fn(edges), edges.active)
    vals = torch.where(edges.active, vals,
                       combine_identity(Combine(combine), vals.dtype))
    return combine_by_offsets(vals, g.row_offsets, combine)
