"""PageRank (power iteration with dangling-mass redistribution).

Counterpart of ``essentials_tpu/algorithms/pr.py`` for the variants
``spmv`` (``_run_spmv_compiled``), ``fused`` (``_run_fused_compiled``) and
``generic`` (``step``, ``converged``); reference parity: gunrock::pr,
``pr.hxx:77-216``.

* ``spmv`` spreads ``rank * alpha / out-weight-sum`` with one product of
  the ``fused`` SpMV engine (``spmv_rows``) per iteration, which computes
  the src-keyed sum; that equals PageRank's dst-keyed spread only when A ==
  A^T.
* ``fused`` keeps the ranks on the edge axis (``r_exp[p] = rank[segment
  (p)]``): per iteration the contributions move CSR->CSC through
  ``csc_edge_ids`` (``gather_payloads``), are weighted, summed per
  destination by a segmented ``scan`` and broadcast back over each segment
  (``segment_broadcast_total``). Isolated vertices share one scalar rank.
* ``generic`` is the push formulation on the operator layer, for any graph
  with a CSC view: the out-weight sums are one ``neighbor_reduce`` and each
  iteration one ``advance`` (``gather_payloads`` of the contributions into
  CSC order, ``segment_reduce`` SUM per destination), through ``enact``.

``spmv`` and ``fused`` need a symmetric layout and refuse the others (the
JAX package's ``variant="spmv"`` skips that check and gives wrong ranks on
a directed graph); ``auto`` is ``spmv`` on a symmetric layout and
``generic`` elsewhere, as the JAX package's. The loops run on the host with
one ``.item()`` per iteration, on the L1 change ``err``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.framework.enactor import enact
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.advance import advance
from essentials_tpu_torch.ops.configs import AdvanceIO, Combine
from essentials_tpu_torch.ops.fused_bfs import segment_broadcast_total
from essentials_tpu_torch.ops.fused_spmv import spmv_fused
from essentials_tpu_torch.ops.neighborreduce import neighbor_reduce
from essentials_tpu_torch.ops.scan_kernels import segmented_scan
from essentials_tpu_torch.ops.segment import expand_vertex_to_edges, gather
from essentials_tpu_torch.utils.timer import Timer


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


def run_fused(g: Graph, iweights: torch.Tensor, alpha: float, tol: float,
              max_iterations: int) -> tuple:
    """The edge-axis power iteration of ``_run_fused_compiled``
    (``pr.py:72-125``), in float32 as there, with the same stop rule as
    ``run_spmv``. Returns (ranks [Vp] float32, iterations)."""
    ep, n = g.n_edges_padded, g.n_vertices
    iw_exp = expand_vertex_to_edges(iweights, g.row_offsets, ep)
    valid = torch.arange(ep, device=g.device) < g.n_edges
    rep = g.csc_seg_flags & valid                   # segment representatives
    nonempty = g.row_offsets[1:] > g.row_offsets[:-1]
    n_iso = (~nonempty & g.vertex_mask()).sum().float()
    dang = rep & (iw_exp == 0.0)
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=g.device)
    tol32 = float(np.float32(tol))
    r_exp = torch.full((ep,), 1.0 / n, dtype=torch.float32, device=g.device)
    r_iso = torch.tensor(1.0 / n, dtype=torch.float32, device=g.device)
    it, err = 0, float("inf")
    while it < max_iterations and err > tol32:
        dangling = torch.where(dang, r_exp, 0.0).sum() + n_iso * r_iso
        base = (1.0 - alpha32) / n + alpha32 * dangling / n
        z, = gather(g.csc_edge_ids, r_exp * iw_exp)
        m = torch.where(valid, z * g.csc_values, 0.0)
        pulled = segment_broadcast_total(
            segmented_scan(m, g.csc_seg_flags, "add"), g.csc_seg_flags)
        r_new = torch.where(valid, base + pulled, r_exp)
        err = (torch.where(rep, (r_new - r_exp).abs(), 0.0).sum()
               + n_iso * (base - r_iso).abs()).item()
        r_exp, r_iso = r_new, base
        it += 1
    # collapse to the vertex axis: each segment's start holds its rank
    starts = kernels.collapse_starts(r_exp.view(torch.int32), g.row_offsets,
                                     0).view(torch.float32)
    ranks = torch.where(nonempty, starts, r_iso)
    return torch.where(g.vertex_mask(), ranks, 0.0), it


SYMMETRIC_VARIANTS = {"spmv": run_spmv, "fused": run_fused}
VARIANTS = (*SYMMETRIC_VARIANTS, "generic")


# --------------------------------------------------------------- generic --

class PrState(NamedTuple):
    ranks: torch.Tensor          # float32[Vp]
    err: float                   # L1 change of the last step (host)
    iweights: torch.Tensor       # float32[Vp]: alpha / out-weight sum
    alpha: torch.Tensor          # float32 scalar
    tol: float                   # float32 value


def init(g: Graph, alpha: float = 0.85, tol: float = 1e-6) -> PrState:
    """``pr.py:39-46``: the out-weight sums by ``neighbor_reduce``, uniform
    ranks on the real vertices."""
    wsum = neighbor_reduce(g, lambda e: e.weight, combine=Combine.SUM)
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=g.device)
    iweights = torch.where(wsum > 0, alpha32 / wsum, 0.0)
    ranks = torch.where(g.vertex_mask(), 1.0 / g.n_vertices, 0.0).float()
    return PrState(ranks, float("inf"), iweights, alpha32,
                   float(np.float32(tol)))


def step(g: Graph, state: PrState, it: int) -> PrState:
    """``pr.py:49-60``: the dangling mass spread evenly, then each
    destination's sum over its in-edges of contribution * weight."""
    ranks, _, iweights, alpha, tol = state
    mask, n = g.vertex_mask(), g.n_vertices
    dangling = torch.where((iweights == 0.0) & mask, ranks, 0.0).sum()
    base = (1.0 - alpha) / n + alpha * dangling / n
    spread = advance(g, lambda e: e.src_vals[0] * e.weight, None,
                     src_values=(ranks * iweights,),
                     input_kind=AdvanceIO.GRAPH, combine=Combine.SUM,
                     with_frontier=False)
    new_ranks = torch.where(mask, base + spread, 0.0)
    err = (new_ranks - ranks).abs().sum().item()
    return PrState(new_ranks, err, iweights, alpha, tol)


def converged(g: Graph, state: PrState, it: int) -> bool:
    return state.err < state.tol


def run(g: Graph, *, alpha: float = 0.85, tol: float = 1e-6,
        max_iterations: int = 500, warmup: bool = True,
        variant: str = "auto") -> PrResult:
    """PageRank on ``g``'s device. variant: 'spmv', 'fused', 'generic', or
    'auto', which is 'spmv' on a symmetric layout and 'generic' elsewhere
    (the JAX package's choice); 'spmv' and 'fused' need a symmetric layout.
    ``elapsed_ms`` covers the iterations, not the weight sums, on the
    device's clock (CUDA events) or the host's (CPU)."""
    if variant == "auto":
        variant = "spmv" if g.symmetric_layout else "generic"
    throw_if(variant not in VARIANTS, f"unknown pr variant {variant!r}")
    if variant == "generic":
        throw_if(not g.has_csc, "pr generic needs the CSC view")
        res = enact(step, converged, g, init(g, alpha, tol),
                    max_iterations=max_iterations, warmup=warmup)
        return PrResult(res.state.ranks[:g.n_vertices], res.iterations,
                        res.elapsed_ms)
    throw_if(not g.symmetric_layout,
             f"pr variant {variant!r} needs a graph with a symmetric layout "
             f"(on another graph it would give wrong ranks); use 'generic' "
             f"or 'auto'")
    iweights = inverse_weights(g, alpha)
    iterate = SYMMETRIC_VARIANTS[variant]
    if warmup:
        iterate(g, iweights, alpha, tol, max_iterations)
    timer = Timer(g.device).begin()
    ranks, it = iterate(g, iweights, alpha, tol, max_iterations)
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
