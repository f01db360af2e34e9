"""Personalized PageRank (Andersen push), from one seed or from many.

Counterpart of ``essentials_tpu/algorithms/ppr.py:38-95`` (reference
parity: gunrock::ppr, ppr.hxx:121-201): each frontier vertex moves
2a/(1+a) of its residual into p and spreads (1-a)/(1+a) of it over its
out-edges; the next frontier is every vertex whose residual reaches eps
times its out-degree. One iteration is one ``advance`` SUM (the
``gather_payloads`` and ``segment_reduce`` kernels), on the host's loop
(``framework.enactor``). ``run_batch`` runs each seed to its own end
through ``ops.batch.batch_execute``, where the JAX package vmaps them.

The frontier test is a float32 compare: where a sum lands within a
rounding of eps * deg, another order of summation (the card's against the
plain version's) can move a vertex in or out of the frontier.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.framework.enactor import default_converged, enact
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.advance import advance
from essentials_tpu_torch.ops.batch import batch_execute
from essentials_tpu_torch.ops.configs import Combine


class PprState(NamedTuple):
    p: torch.Tensor          # float32[Vp] personalized PageRank mass
    r: torch.Tensor          # float32[Vp] residual
    frontier: torch.Tensor   # bool[Vp]
    alpha: torch.Tensor      # float32 []
    eps: torch.Tensor        # float32 []
    live: int                # frontier size, read with the step


class PprResult(NamedTuple):
    p: torch.Tensor          # [V] float32
    iterations: int
    elapsed_ms: float


def init(g: Graph, seed_vertex: int, alpha: float = 0.15,
         eps: float = 1e-6) -> PprState:
    vp = g.n_vertices_padded
    p = torch.zeros(vp, dtype=torch.float32, device=g.device)
    r = p.clone()
    r[seed_vertex] = 1.0
    frontier = torch.zeros(vp, dtype=torch.bool, device=g.device)
    frontier[seed_vertex] = True
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=g.device)
    return PprState(p, r, frontier, scalar(alpha), scalar(eps), 1)


def step(g: Graph, state: PprState, it: int) -> PprState:
    p, r, frontier, alpha, eps, _ = state
    deg = g.out_degrees().float()
    c_keep = 2.0 * alpha / (1.0 + alpha)
    c_push = (1.0 - alpha) / (1.0 + alpha)
    p = p + torch.where(frontier, c_keep * r, 0.0)
    push = torch.where(frontier & (deg > 0),
                       c_push * r / torch.clamp(deg, min=1.0), 0.0)
    inflow = advance(g, lambda e: e.src_vals[0], frontier,
                     src_values=(push,), combine=Combine.SUM,
                     with_frontier=False)
    r = torch.where(frontier, 0.0, r) + inflow
    new_frontier = (r >= eps * deg) & (deg > 0) & g.vertex_mask()
    return PprState(p, r, new_frontier, alpha, eps,
                    int(new_frontier.sum()))


def run(g: Graph, seed_vertex: int, *, alpha: float = 0.15,
        eps: float = 1e-6, max_iterations: int = 1000,
        warmup: bool = True) -> PprResult:
    """PPR from ``seed_vertex`` on ``g``'s device. ``elapsed_ms`` covers the
    iterations, on the device's clock (CUDA events) or the host's (CPU)."""
    res = enact(step, default_converged, g,
                init(g, seed_vertex, alpha, eps),
                max_iterations=max_iterations, warmup=warmup)
    return PprResult(res.state.p[:g.n_vertices], res.iterations,
                     res.elapsed_ms)


def run_batch(g: Graph, seeds, *, alpha: float = 0.15, eps: float = 1e-6,
              max_iterations: int = 1000) -> torch.Tensor:
    """[S, V] float32: PPR from each seed, each run to its own end."""
    return batch_execute(lambda s: run(g, s, alpha=alpha, eps=eps,
                                       max_iterations=max_iterations,
                                       warmup=False).p, seeds)


def cpu_reference(csr, seed: int, alpha: float = 0.15, eps: float = 1e-6,
                  max_iterations: int = 1000) -> np.ndarray:
    """Host Andersen push in float64, vectorised over NumPy arrays: each
    iteration's frontier spreads over every out-edge at once (a bincount
    over the edges, each edge counted, multi-edges too)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices)
    deg = np.diff(off)
    p, r = np.zeros(n), np.zeros(n)
    r[seed] = 1.0
    c_keep = 2 * alpha / (1 + alpha)
    c_push = (1 - alpha) / (1 + alpha)
    frontier = np.asarray([seed])
    for _ in range(max_iterations):
        if frontier.size == 0:
            break
        p[frontier] += c_keep * r[frontier]
        push = np.where(deg[frontier] > 0,
                        c_push * r[frontier] / np.maximum(deg[frontier], 1),
                        0.0)
        lens = deg[frontier]
        pos = (np.repeat(off[frontier] - np.cumsum(lens) + lens, lens)
               + np.arange(int(lens.sum()), dtype=np.int64))
        r[frontier] = 0.0
        r += np.bincount(cols[pos], weights=np.repeat(push, lens),
                         minlength=n)
        frontier = np.nonzero((r >= eps * deg) & (deg > 0))[0]
    return p.astype(np.float32)
