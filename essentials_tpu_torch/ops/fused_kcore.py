"""Fused edge-axis k-core peeling on symmetric-layout graphs.

Counterpart of ``essentials_tpu/ops/fused_kcore.py`` (``init_deg_exp``,
``fused_kcore_sweep``, ``collapse_core_exp``, ``run_fused_kcore``). The
remaining degree (-1 once peeled) and the core number live on the edge
axis, start-authoritative, in one buffer each, updated in place. A wave
peels every alive vertex of degree below k and subtracts each survivor's
peeled in-neighbours; on the card it pushes from the peeled vertices, so a
run reads each edge about once.

The k schedule is the JAX package's: k0 = smallest start degree + 1, and
after each wave k stays while some survivor's degree is below it, else
jumps to the smallest alive degree + 1; the loop ends when nothing
survives. So every wave peels, and a level k takes one wave and one more
for each cascade, its survivors' degrees fallen below k by the wave
before's peel. The two kinds of wave are two kernels: the first wave at a
level (``kcore_level_wave``) finds k on the card from the alive degrees and
reads every vertex; each cascade (``kcore_cascade_wave``) reads only the
candidate list that the wave before wrote, which holds exactly the
survivors that fell below k. A wave that lists no candidate ends its
level.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.runtime import span

IMAX = kernels.INT32_MAX


def init_deg_exp(g: Graph) -> torch.Tensor:
    """deg_exp[p] = out-degree of segment(p), -1 on the pad vertices' rows
    (the ``expand_segments`` kernel); only the segment starts are read."""
    deg = torch.where(g.vertex_mask(), g.out_degrees(), -1).int()
    return kernels.expand_segments(deg, g.row_offsets, g.n_edges_padded)


def alive_vertices(g: Graph) -> int:
    """The real vertices with edges, the ones the waves peel, read to the
    host."""
    return int((g.vertex_mask() & (g.out_degrees() > 0)).sum())


def wave_buffers(g: Graph) -> tuple:
    """A run's two [Vp] int32 candidate lists, which the waves take in
    turns as input and output, and the waves' scratch
    (``kernels.kcore_wave_scratch``)."""
    vp = g.n_vertices_padded
    cand = torch.empty(2, vp, dtype=torch.int32, device=g.device)
    return (cand[0], cand[1],
            kernels.kcore_wave_scratch(vp, g.n_edges_padded, g.device))


def fused_kcore_sweep(g: Graph, deg: torch.Tensor, core: torch.Tensor,
                      k: int, n_in: int, cand_in: torch.Tensor,
                      cand_out: torch.Tensor,
                      scratch: torch.Tensor) -> torch.Tensor:
    """One peel wave in place: the first of a level where ``n_in`` is 0
    (``kcore_level_wave``: k found on the card, ``k`` unused), else a
    cascade at ``k`` from the ``n_in`` vertices of ``cand_in``
    (``kcore_cascade_wave``). ``cand_out`` receives the next wave's peel
    set. Returns int32 [4]: (peeled, candidates listed, ranges listed,
    k)."""
    adj = (g.row_offsets, g.csc_src_indices, g.col_indices)
    if n_in:
        return kernels.kcore_cascade_wave(deg, core, *adj, k, cand_in, n_in,
                                          cand_out, scratch)
    return kernels.kcore_level_wave(deg, core, *adj, cand_out, scratch)


def collapse_core_exp(g: Graph, core_exp: torch.Tensor) -> torch.Tensor:
    """core_exp -> per-vertex core numbers [Vp] int32 (the
    ``collapse_starts`` kernel); empty segments (degree 0) get 0."""
    return kernels.collapse_starts(core_exp, g.row_offsets, 0)


def peel_wave(g: Graph, deg: torch.Tensor, core: torch.Tensor, k: int,
              n_in: int, cand_in: torch.Tensor, cand_out: torch.Tensor,
              scratch: torch.Tensor) -> list:
    """One wave (``fused_kcore_sweep``) and its one host read, the span
    ``kcore.wave.read``: [peeled, candidates listed, ranges listed, k]."""
    scalars = fused_kcore_sweep(g, deg, core, k, n_in, cand_in, cand_out,
                                scratch)
    with span("kcore.wave.read"):
        return kernels.kcore_wave_read(scalars)


def count_wave(peeled: int, new_level: bool) -> None:
    """A wave counted in ``kernels.counters``: one wave (``kcore.waves``),
    the vertices it peeled (``kcore.peeled``), and one level
    (``kcore.levels``) where it is the first wave to peel at its k."""
    kernels.counters["kcore.waves"] += 1
    kernels.counters["kcore.peeled"] += peeled
    kernels.counters["kcore.levels"] += new_level


def run_fused_kcore(g: Graph, max_it: int) -> tuple:
    """Whole k-core decomposition on the edge axis, on the host's loop: one
    ``expand_segments`` for the initial degrees, then per wave one
    ``fused_kcore_sweep`` and one read of its scalars (``peel_wave``, in
    the span ``kcore.wave``; each wave counted by ``count_wave``): a level
    wave where the wave before listed no candidate, else a cascade from its
    list. The loop ends when every vertex with edges is peeled.
    Returns (core int32 [Vp], waves)."""
    deg = init_deg_exp(g)
    core = torch.zeros_like(deg)
    cand_in, cand_out, scratch = wave_buffers(g)
    alive = alive_vertices(g)
    it, k, listed = 0, IMAX, 0
    while it < max_it and alive:
        with span("kcore.wave"):
            peeled, n_out, _, k = peel_wave(g, deg, core, k, listed, cand_in,
                                            cand_out, scratch)
            count_wave(peeled, not listed)
        cand_in, cand_out, listed = cand_out, cand_in, n_out
        alive -= peeled
        it += 1
    return collapse_core_exp(g, core), it
