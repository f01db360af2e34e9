"""Fused SpMV: y = A @ x in one kernel, one warp per CSR row.

Counterpart of ``essentials_tpu/ops/fused_spmv.py``. The JAX package runs
the product as a 7-kernel chain: expand x over the CSC offsets by an int32
telescoping cumsum, multiply by the CSC-ordered weights, route CSC -> CSR,
segmented sum, shift and boundary pick. Its routes exist because the TPU's
gathers are element-serialized. Here the ``spmv_rows`` kernel loads
``x[col[p]]`` directly in CSR order and sums each row in registers, so the
port needs none of the graph's router plans.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.graph.graph import Graph


def vertex_vector(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the [Vp] float32 vector the SpMV kernels take: cast, and
    padded with zeros when shorter, as the JAX package pads. A [Vp]
    float32 contiguous x on ``g``'s device is returned as it is."""
    vp = g.n_vertices_padded
    x = x.to(device=g.device, dtype=torch.float32)
    throw_if(x.dim() != 1 or x.numel() > vp,
             f"x must be a vector of at most Vp = {vp} values")
    if x.numel() < vp:
        x = F.pad(x, (0, vp - x.numel()))
    return x.contiguous()


def edge_weights(g: Graph) -> torch.Tensor:
    """The graph's CSR weights as float32 (0 on the pad edges)."""
    return g.values.to(torch.float32).contiguous()


def fused_spmv_supported(g: Graph) -> bool:
    """Whether ``spmv_fused`` runs on ``g``: always, for a Graph. Kept
    for the JAX package's API, whose chain needs the graph's router plans;
    ``spmv_rows`` reads only the CSR arrays, which every Graph has."""
    return isinstance(g, Graph)


def spmv_fused(g: Graph, x: torch.Tensor, *, unit: bool = False
               ) -> torch.Tensor:
    """y[s] = sum over CSR segment s of w[e] * x[col[e]]; [Vp] float32, 0
    at empty segments. ``unit=True`` drops the weight (y[s] = sum of
    x[col[e]]) and skips the weight read. The pad vertex owns the pad
    edges: y[pad] is 0 with weights, and (Ep - E) * x[pad] with
    ``unit``."""
    return kernels.spmv_rows(g.row_offsets, g.col_indices,
                             None if unit else edge_weights(g),
                             vertex_vector(g, x))
