"""PageRank on the SpMV engine (power iteration with dangling-mass
redistribution).

Counterpart of ``essentials_tpu/algorithms/pr.py`` for the variant ``spmv``
(``_run_spmv_compiled``, reference parity: gunrock::pr, ``pr.hxx:77-216``).
Each iteration spreads ``rank * alpha / out-weight-sum`` with one product
of the ``fused`` SpMV engine (``spmv_rows``), which computes the src-keyed
sum; that equals PageRank's dst-keyed spread only when A == A^T, so the
variant runs on graphs with a symmetric layout and refuses the others. (The
JAX package's ``variant="spmv"`` skips that check and gives wrong ranks on
a directed graph.) The loop runs on the host with one ``.item()`` per
iteration, on the L1 change ``err``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.fused_spmv import spmv_fused
from essentials_tpu_torch.utils.timer import Timer

VARIANTS = ("spmv",)
# variants of the JAX package that this package does not run yet, and the
# ROADMAP.md item that brings them
_UNPORTED = {"fused": "queue 2, item 5 (segment_broadcast_total)",
             "generic": "queue 1, item 8 (the operator layer)"}


class PrResult(NamedTuple):
    ranks: torch.Tensor          # [V] float32
    iterations: int
    elapsed_ms: float


def inverse_weights(g: Graph, alpha: float = 0.85) -> torch.Tensor:
    """[Vp] float32 alpha / (sum of v's out-edge weights), 0 where the sum
    is 0 (``init``, ``pr.py:39-43``; reference ``pr.hxx:77-90``). The sum
    is ``spmv_fused`` of the vector that is 1 on the real vertices."""
    wsum = spmv_fused(g, g.vertex_mask().float())
    # a float32 divide, as JAX's alpha / wsum (torch's alpha / wsum would
    # multiply by the reciprocal)
    alpha32 = torch.full_like(wsum, alpha)
    return torch.where(wsum > 0, alpha32 / wsum, 0.0)


def run_spmv(g: Graph, iweights: torch.Tensor, alpha: float, tol: float,
             max_iterations: int) -> tuple:
    """The power iteration of ``_run_spmv_compiled`` (``pr.py:158-189``),
    in float32 as there. Stops when the L1 change ``err`` is no longer
    above ``tol`` (both float32) or after ``max_iterations``. Returns
    (ranks [Vp] float32, iterations)."""
    n = g.n_vertices
    mask = g.vertex_mask()
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=g.device)
    tol32 = float(np.float32(tol))
    r = torch.where(mask, 1.0 / n, 0.0).float()
    dang_mask = (iweights == 0.0) & mask
    it, err = 0, float("inf")
    while it < max_iterations and err > tol32:
        dangling = torch.where(dang_mask, r, 0.0).sum()
        base = (1.0 - alpha32) / n + alpha32 * dangling / n
        spread = spmv_fused(g, r * iweights)
        r_new = torch.where(mask, base + spread, 0.0)
        err = (r_new - r).abs().sum().item()
        r = r_new
        it += 1
    return r, it


def run(g: Graph, *, alpha: float = 0.85, tol: float = 1e-6,
        max_iterations: int = 500, warmup: bool = True,
        variant: str = "auto") -> PrResult:
    """PageRank on ``g``'s device. variant: 'spmv', or 'auto', which is
    'spmv' (the JAX package's choice on a symmetric layout). Both need a
    symmetric layout. ``elapsed_ms`` covers the iterations, not the weight
    sums, on the device's clock (CUDA events) or the host's (CPU)."""
    if variant in _UNPORTED:
        raise EssentialsError(f"pr variant {variant!r} is not ported yet "
                              f"(ROADMAP.md {_UNPORTED[variant]})")
    if variant == "auto":
        variant = "spmv"
    throw_if(variant not in VARIANTS, f"unknown pr variant {variant!r}")
    throw_if(not g.symmetric_layout,
             "pr on a graph without a symmetric layout needs the push "
             "formulation (variant 'generic'), which is not ported yet "
             "(ROADMAP.md queue 1, item 8): the spmv variant would give "
             "wrong ranks")
    iweights = inverse_weights(g, alpha)
    if warmup:
        run_spmv(g, iweights, alpha, tol, max_iterations)
    timer = Timer(g.device).begin()
    ranks, it = run_spmv(g, iweights, alpha, tol, max_iterations)
    elapsed = timer.end()
    return PrResult(ranks[:g.n_vertices], it, elapsed)


def cpu_run(csr, alpha: float = 0.85, tol: float = 1e-6,
            max_iterations: int = 500) -> tuple:
    """Host power iteration in float64 with weighted spread and dangling
    redistribution. Returns (ranks float32 [V], iterations)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values, np.float64)
    src = np.repeat(np.arange(n), np.diff(off))
    wsum = np.bincount(src, weights=vals, minlength=n)
    pr = np.full(n, 1.0 / n)
    for it in range(1, max_iterations + 1):
        contrib = np.where(wsum > 0, alpha * pr / np.maximum(wsum, 1e-300),
                           0.0)
        nxt = np.bincount(cols, weights=contrib[src] * vals, minlength=n)
        dangling = pr[wsum == 0].sum()
        new = (1 - alpha) / n + alpha * dangling / n + nxt
        if np.abs(new - pr).sum() < tol:
            return new.astype(np.float32), it
        pr = new
    return pr.astype(np.float32), max_iterations


def cpu_reference(csr, alpha: float = 0.85, tol: float = 1e-6,
                  max_iterations: int = 500) -> np.ndarray:
    """Host PageRank ranks (float32 [V])."""
    return cpu_run(csr, alpha, tol, max_iterations)[0]
