"""k-core decomposition by peeling waves.

Counterpart of ``essentials_tpu/algorithms/kcore.py`` for the variant
``fused`` (edge-axis waves, ``ops/fused_kcore.py``); reference parity:
gunrock ``kcore.hxx:148-199``. A vertex's core number is k - 1 for the
level k at which it is peeled; levels at which nothing can peel are
jumped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_kcore as FK
from essentials_tpu_torch.utils.timer import Timer

VARIANTS = ("fused",)
# variants of the JAX package that this package does not run yet, and the
# ROADMAP.md queue-1 item that brings them
_UNPORTED = {"adaptive": 8}


class KcoreResult(NamedTuple):
    core: torch.Tensor           # [V] int32
    iterations: int              # peel waves
    elapsed_ms: float


def fused_supported(g: Graph) -> bool:
    """The edge-axis wave needs the symmetric layout: each in-neighbour's
    degree sits at the start of its own segment, and a vertex's CSR row
    lies at the positions of its segment, so that its push along the CSR
    columns reaches the vertices whose pull counts it (directed graphs
    with in-degree equal to out-degree included)."""
    return bool(g.symmetric_layout)


def run(g: Graph, *, max_iterations: int | None = None, warmup: bool = True,
        variant: str = "auto") -> KcoreResult:
    """Core numbers of every vertex on ``g``'s device. variant: 'fused', or
    'auto', which is 'fused' (the JAX package's choice on a symmetric
    layout). ``elapsed_ms`` covers the waves and the collapse, on the
    device's clock (CUDA events) or the host's (CPU)."""
    if variant in _UNPORTED:
        raise EssentialsError(
            f"kcore variant {variant!r} is not ported yet "
            f"(ROADMAP.md queue 1, item {_UNPORTED[variant]})")
    if variant == "auto":
        variant = "fused"
    throw_if(variant not in VARIANTS, f"unknown kcore variant {variant!r}")
    throw_if(not fused_supported(g),
             "kcore on a graph without a symmetric layout needs the "
             "adaptive sweeps, which are not ported yet (ROADMAP.md queue "
             "1, item 8)")
    max_it = (max_iterations if max_iterations is not None
              else 4 * g.n_vertices + 8)

    if warmup:
        FK.run_fused_kcore(g, max_it)
    timer = Timer(g.device).begin()
    core, it = FK.run_fused_kcore(g, max_it)
    elapsed = timer.end()
    return KcoreResult(core[:g.n_vertices], it, elapsed)


def cpu_reference(csr) -> np.ndarray:
    """Host peeling (Matula-Beck style), vectorised over NumPy arrays: at
    each level k, every alive vertex of remaining degree below k is peeled
    at once (core k - 1) and each of its out-edges takes one from its
    target's degree, until none is left below k; a level where nothing
    peels is jumped to the smallest alive degree + 1. The same waves as the
    JAX package's edge-by-edge loop."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    deg = np.diff(off)
    alive = np.ones(n, bool)
    core = np.zeros(n, np.int32)
    k = 1
    while alive.any():
        peel = alive & (deg < k)
        if not peel.any():
            k = int(deg[alive].min()) + 1
            continue
        core[peel] = k - 1
        alive &= ~peel
        u = np.nonzero(peel)[0]
        starts, lens = off[u], off[u + 1] - off[u]
        # positions of every out-edge of the peeled vertices
        pos = (np.repeat(starts - np.cumsum(lens) + lens, lens)
               + np.arange(int(lens.sum()), dtype=np.int64))
        deg -= np.bincount(cols[pos], minlength=n)
    return core
