"""Sparse matrix-vector multiply y = A @ x.

Counterpart of ``essentials_tpu/algorithms/spmv.py`` (reference parity:
gunrock::spmv, ``spmv.hxx:77-131``) for the variants ``fused`` (one warp
per row, ``ops/fused_spmv.py``), ``windowed`` (edge-balanced slabs,
``ops/windowed_spmv.py``), ``pull`` (``neighbor_reduce``) and ``push``
(``advance``, which computes A^T @ x). All compute y[s] = sum over the
out-edges (s, d) of w * x[d] in float32 (push: over the in-edges), each in
a fixed order, so a variant gives the same bits on every run; the variants
and the JAX package sum in different orders and agree to a tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_spmv as FS
from essentials_tpu_torch.ops import windowed_spmv as WS
from essentials_tpu_torch.ops.advance import advance
from essentials_tpu_torch.ops.configs import AdvanceIO, Combine
from essentials_tpu_torch.ops.neighborreduce import neighbor_reduce
from essentials_tpu_torch.utils.timer import Timer


def spmv_pull(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """y[row] = sum over row's edges of w * x[col]: a source-keyed segment
    sum (``neighbor_reduce``)."""
    return neighbor_reduce(g, lambda e: e.weight * e.dst_vals[0],
                           dst_values=(x,), combine=Combine.SUM)


def spmv_push(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """y[dst] = sum over dst's in-edges of w * x[src] (``advance`` over the
    whole graph): A^T @ x, equal to pull on a symmetric A."""
    return advance(g, lambda e: e.weight * e.src_vals[0], None,
                   src_values=(x,), input_kind=AdvanceIO.GRAPH,
                   combine=Combine.SUM, with_frontier=False)


VARIANTS = {"fused": FS.spmv_fused, "windowed": WS.spmv_windowed,
            "pull": spmv_pull, "push": spmv_push}


class SpmvResult(NamedTuple):
    y: torch.Tensor              # [V] float32
    elapsed_ms: float


def fused_supported(g: Graph) -> bool:
    """Always True for a Graph; the JAX package's API (see
    ``fused_spmv.fused_spmv_supported``)."""
    return FS.fused_spmv_supported(g)


def random_x(g: Graph, seed: int = 0) -> torch.Tensor:
    """The default x of ``run``: [Vp] float32 uniform in [0, 1) from a
    ``torch.Generator`` seeded with ``seed``, 0 outside the real vertices,
    on ``g``'s device. Its values differ from the JAX package's
    ``jax.random.PRNGKey(seed)`` stream."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(g.n_vertices_padded, generator=gen, dtype=torch.float32)
    return x.to(g.device) * g.vertex_mask()


def run(g: Graph, x: torch.Tensor | None = None, *, variant: str = "auto",
        seed: int = 0, warmup: bool = True) -> SpmvResult:
    """y = A @ x on ``g``'s device. variant: 'fused', 'windowed', 'pull',
    'push' (A^T @ x), or 'auto', which is 'fused' (the JAX package's choice
    off the TPU). ``x`` defaults to ``random_x(g, seed)``. ``elapsed_ms`` is
    one product on the device's clock (CUDA events) or the host's (CPU)."""
    if variant == "auto":
        variant = "fused"
    throw_if(variant not in VARIANTS, f"unknown spmv variant {variant!r}")
    fn = VARIANTS[variant]
    x = random_x(g, seed) if x is None else x
    if warmup:
        fn(g, x)
    timer = Timer(g.device).begin()
    y = fn(g, x)
    elapsed = timer.end()
    return SpmvResult(y[:g.n_vertices], elapsed)


def cpu_reference(csr, x) -> np.ndarray:
    """Host y = A @ x, summed in float64 and returned as float32."""
    off = np.asarray(csr.row_offsets, np.int64)
    src = np.repeat(np.arange(csr.n_rows), np.diff(off))
    prod = (np.asarray(csr.values, np.float64)
            * np.asarray(x, np.float64)[np.asarray(csr.col_indices)])
    return np.bincount(src, weights=prod,
                       minlength=csr.n_rows).astype(np.float32)
