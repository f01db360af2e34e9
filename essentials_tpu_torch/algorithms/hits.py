"""HITS (hubs and authorities) on the SpMV engine.

Counterpart of ``essentials_tpu/algorithms/hits.py`` for the variant
``spmv`` (``_run_spmv_compiled``, ``hits.py:69-98``; reference parity:
gunrock::hits, ``hits.hxx:118-271``). On a graph with a symmetric layout
(A == A^T) both half-steps, auth[d] += hub[s] and hub[s] += auth[d], are
the same unweighted y = A @ x: one ``unit`` product each of the ``fused``
SpMV engine (``spmv_rows`` without weights), then L2 normalisation. The
loop runs on the host with one ``.item()`` per iteration, on ``delta``.
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
_UNPORTED = {"generic": 8}     # ROADMAP.md queue-1 item (operator layer)
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


def run(g: Graph, *, max_iterations: int = 50, warmup: bool = True,
        variant: str = "auto") -> HitsResult:
    """HITS on ``g``'s device. variant: 'spmv', or 'auto', which is 'spmv';
    both need a symmetric layout. ``elapsed_ms`` covers the iterations on
    the device's clock (CUDA events) or the host's (CPU)."""
    if variant in _UNPORTED:
        raise EssentialsError(
            f"hits variant {variant!r} is not ported yet "
            f"(ROADMAP.md queue 1, item {_UNPORTED[variant]})")
    if variant == "auto":
        variant = "spmv"
    throw_if(variant not in VARIANTS, f"unknown hits variant {variant!r}")
    throw_if(not spmv_supported(g),
             "hits on a graph without a symmetric layout needs the generic "
             "variant, which is not ported yet (ROADMAP.md queue 1, item 8)")
    if warmup:
        run_spmv(g, max_iterations)
    timer = Timer(g.device).begin()
    auth, hub, it = run_spmv(g, max_iterations)
    elapsed = timer.end()
    v = g.n_vertices
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
