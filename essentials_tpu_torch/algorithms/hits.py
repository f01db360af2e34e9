"""HITS (hubs and authorities).

Counterpart of ``essentials_tpu/algorithms/hits.py`` for the variants
``spmv`` (``_run_spmv_compiled``, ``hits.py:69-98``) and ``generic``
(``step``, ``converged``, ``hits.py:36-57``); reference parity:
gunrock::hits, ``hits.hxx:118-271``. Each iteration computes auth[d] =
sum of hub[s] over the edges (s -> d), then hub[s] = sum of auth[d] over
them, then L2 normalisation.

* ``spmv``: on a graph with a symmetric layout (A == A^T) both half-steps
  are the same unweighted y = A @ x, one ``unit`` product each of the
  ``fused`` SpMV engine (``spmv_rows`` without weights).
* ``generic``, for any graph with a CSC view: the first half-step is an
  ``advance`` (``gather_payloads`` into CSC order, ``segment_reduce`` SUM
  per destination), the second a ``neighbor_reduce`` (``gather_payloads``
  through the columns, ``segment_reduce`` SUM per source), through
  ``enact``.

``auto`` is ``spmv`` on a symmetric layout and ``generic`` elsewhere, as the
JAX package's; ``spmv`` refuses a graph without one. The loops run on the
host with one ``.item()`` per iteration, on ``delta``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.framework.enactor import enact
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.advance import advance
from essentials_tpu_torch.ops.configs import AdvanceIO, Combine
from essentials_tpu_torch.ops.fused_spmv import spmv_fused
from essentials_tpu_torch.ops.neighborreduce import neighbor_reduce
from essentials_tpu_torch.utils.timer import Timer

VARIANTS = ("spmv", "generic")
DELTA_STOP = float(np.float32(1e-7))   # stop once delta < this (float32)


class HitsResult(NamedTuple):
    auth: torch.Tensor           # [V] float32
    hub: torch.Tensor            # [V] float32
    iterations: int
    elapsed_ms: float


def spmv_supported(g: Graph) -> bool:
    """The SpMV-engine iteration needs A == A^T (symmetric layout): both
    half-steps are then the same unweighted y = A @ x."""
    return bool(g.symmetric_layout)


def _normalized(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)


def run_spmv(g: Graph, max_iterations: int) -> tuple:
    """The loop of ``hits.py:69-98`` in float32. Returns (auth [Vp], hub
    [Vp], iterations)."""
    mask = g.vertex_mask()
    auth = hub = mask.float()
    it, delta = 0, float("inf")
    while it < max_iterations and delta >= DELTA_STOP:
        new_auth = torch.where(mask, spmv_fused(g, hub, unit=True), 0.0)
        new_hub = torch.where(mask, spmv_fused(g, new_auth, unit=True), 0.0)
        na, nh = _normalized(new_auth), _normalized(new_hub)
        delta = ((na - auth).abs().sum() + (nh - hub).abs().sum()).item()
        auth, hub = na, nh
        it += 1
    return auth, hub, it


class HitsState(NamedTuple):
    auth: torch.Tensor           # float32[Vp]
    hub: torch.Tensor            # float32[Vp]
    delta: float                 # L1 change of the last step (host)


def init(g: Graph) -> HitsState:
    ones = g.vertex_mask().float()
    return HitsState(ones, ones, float("inf"))


def step(g: Graph, state: HitsState, it: int) -> HitsState:
    """``hits.py:41-53``: auth by ``advance`` over the in-edges, hub by
    ``neighbor_reduce`` over the out-edges, both L2-normalised."""
    new_auth = advance(g, lambda e: e.src_vals[0], None,
                       src_values=(state.hub,), input_kind=AdvanceIO.GRAPH,
                       combine=Combine.SUM, with_frontier=False)
    new_hub = neighbor_reduce(g, lambda e: e.dst_vals[0],
                              dst_values=(new_auth,), combine=Combine.SUM)
    na, nh = _normalized(new_auth), _normalized(new_hub)
    delta = ((na - state.auth).abs().sum()
             + (nh - state.hub).abs().sum()).item()
    return HitsState(na, nh, delta)


def converged(g: Graph, state: HitsState, it: int) -> bool:
    return state.delta < DELTA_STOP


def run(g: Graph, *, max_iterations: int = 50, warmup: bool = True,
        variant: str = "auto") -> HitsResult:
    """HITS on ``g``'s device. variant: 'spmv' (needs a symmetric layout),
    'generic', or 'auto', which is 'spmv' on a symmetric layout and
    'generic' elsewhere. ``elapsed_ms`` covers the iterations on the
    device's clock (CUDA events) or the host's (CPU)."""
    if variant == "auto":
        variant = "spmv" if spmv_supported(g) else "generic"
    throw_if(variant not in VARIANTS, f"unknown hits variant {variant!r}")
    v = g.n_vertices
    if variant == "generic":
        throw_if(not g.has_csc, "hits generic needs the CSC view")
        res = enact(step, converged, g, init(g),
                    max_iterations=max_iterations, warmup=warmup)
        return HitsResult(res.state.auth[:v], res.state.hub[:v],
                          res.iterations, res.elapsed_ms)
    throw_if(not spmv_supported(g),
             "hits variant 'spmv' needs a graph with a symmetric layout; "
             "use 'generic' or 'auto'")
    if warmup:
        run_spmv(g, max_iterations)
    timer = Timer(g.device).begin()
    auth, hub, it = run_spmv(g, max_iterations)
    elapsed = timer.end()
    return HitsResult(auth[:v], hub[:v], it, elapsed)


def rank(result: HitsResult, k: int = 10):
    """Top-k vertex ids by authority / hub score (reference: stable sort
    ranking, hits.hxx:54-64)."""
    auth = result.auth.detach().cpu().numpy()
    hub = result.hub.detach().cpu().numpy()
    return (np.argsort(-auth, kind="stable")[:k],
            np.argsort(-hub, kind="stable")[:k])


def cpu_run(csr, max_iterations: int = 50) -> tuple:
    """Host HITS in float64. Returns (auth float32 [V], hub float32 [V],
    iterations)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices)
    src = np.repeat(np.arange(n), np.diff(off))
    auth = np.ones(n)
    hub = np.ones(n)
    for it in range(1, max_iterations + 1):
        na = np.bincount(cols, weights=hub[src], minlength=n)
        nh = np.bincount(src, weights=na[cols], minlength=n)
        na /= max(np.linalg.norm(na), 1e-12)
        nh /= max(np.linalg.norm(nh), 1e-12)
        delta = np.abs(na - auth).sum() + np.abs(nh - hub).sum()
        auth, hub = na, nh
        if delta < 1e-7:
            return auth.astype(np.float32), hub.astype(np.float32), it
    return auth.astype(np.float32), hub.astype(np.float32), max_iterations


def cpu_reference(csr, max_iterations: int = 50):
    """Host (auth, hub), float32 [V] each."""
    return cpu_run(csr, max_iterations)[:2]
