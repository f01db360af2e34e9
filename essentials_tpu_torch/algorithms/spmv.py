"""Sparse matrix-vector multiply y = A @ x.

Counterpart of ``essentials_tpu/algorithms/spmv.py`` (reference parity:
gunrock::spmv, ``spmv.hxx:77-131``) for the variants ``fused`` (one warp
per row, ``ops/fused_spmv.py``) and ``windowed`` (edge-balanced slabs,
``ops/windowed_spmv.py``). Both compute y[s] = sum over the out-edges
(s, d) of w * x[d] in float32, each in a fixed order, so a variant gives
the same bits on every run; the two variants and the JAX package sum in
different orders and agree to a tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_spmv as FS
from essentials_tpu_torch.ops import windowed_spmv as WS
from essentials_tpu_torch.utils.timer import Timer

VARIANTS = {"fused": FS.spmv_fused, "windowed": WS.spmv_windowed}
# variants of the JAX package that this package does not run yet, and the
# ROADMAP.md queue-1 item that brings them (they run on the operator layer)
_UNPORTED = {"pull": 8, "push": 8}


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
    """y = A @ x on ``g``'s device. variant: 'fused', 'windowed', or
    'auto', which is 'fused' (the JAX package's choice off the TPU).
    ``x`` defaults to ``random_x(g, seed)``. ``elapsed_ms`` is one product
    on the device's clock (CUDA events) or the host's (CPU)."""
    if variant in _UNPORTED:
        raise EssentialsError(
            f"spmv variant {variant!r} is not ported yet "
            f"(ROADMAP.md queue 1, item {_UNPORTED[variant]})")
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
