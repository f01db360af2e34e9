"""Fused edge-axis k-core peeling on symmetric-layout graphs.

Counterpart of ``essentials_tpu/ops/fused_kcore.py`` (``init_deg_exp``,
``fused_kcore_sweep``, ``collapse_core_exp``, ``run_fused_kcore``). The
remaining degree (-1 once peeled) and the core number live on the edge
axis, start-authoritative. One wave is one ``kcore_sweep`` call, which
peels every alive vertex of degree below k, subtracts each survivor's
peeled in-neighbours and returns (peeled count, smallest surviving degree);
on the card it pushes from the peeled vertices, so a run reads each edge
about once. It reads one pair of state buffers and writes the other: a
neighbour peeled earlier in the same wave must still count as peeled.

The k schedule is the JAX package's: k0 = smallest start degree + 1, and
after each wave k stays while some survivor's degree is below it, else
jumps to that degree + 1; the loop ends when nothing survives. So every
wave peels, and a level k takes one wave and one more for each cascade,
its survivors' degrees fallen below k by the wave before's peel.
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


def fused_kcore_sweep(g: Graph, deg_in: torch.Tensor, core_in: torch.Tensor,
                      k: int, deg_out: torch.Tensor,
                      core_out: torch.Tensor) -> torch.Tensor:
    """One peel wave (the ``kcore_sweep`` kernel) from (deg_in, core_in)
    into (deg_out, core_out) at segment starts. Returns int32 [2]: (peeled
    count, smallest surviving degree or IMAX)."""
    return kernels.kcore_sweep(deg_in, core_in, deg_out, core_out,
                               g.row_offsets, g.csc_src_indices,
                               g.col_indices, k)


def collapse_core_exp(g: Graph, core_exp: torch.Tensor) -> torch.Tensor:
    """core_exp -> per-vertex core numbers [Vp] int32 (the
    ``collapse_starts`` kernel); empty segments (degree 0) get 0."""
    return kernels.collapse_starts(core_exp, g.row_offsets, 0)


def first_level(g: Graph) -> int:
    """k0: the smallest degree of a real vertex with edges, + 1 (IMAX when
    there is none), so that the first wave peels."""
    deg = g.out_degrees()
    start_deg = torch.where(g.vertex_mask() & (deg > 0), deg, IMAX)
    return min(int(start_deg.min().item()) + 1, IMAX)


def next_level(k: int, min_alive: int) -> int:
    """The level after a wave at ``k`` whose smallest surviving degree is
    ``min_alive``: k again while a survivor can still peel at it, else that
    degree + 1 (IMAX when nothing survives)."""
    if min_alive < k:
        return k
    return IMAX if min_alive == IMAX else min_alive + 1


def peel_wave(g: Graph, deg_in: torch.Tensor, core_in: torch.Tensor,
              k: int, deg_out: torch.Tensor, core_out: torch.Tensor) -> list:
    """One wave (``fused_kcore_sweep``) and its one host read, the span
    ``kcore.wave.read``: [peeled count, smallest surviving degree]. The
    scalars are a view of the wave's scratch, which goes with them."""
    scalars = fused_kcore_sweep(g, deg_in, core_in, k, deg_out, core_out)
    with span("kcore.wave.read"):
        return scalars.tolist()


def count_wave(peeled: int, new_level: bool) -> None:
    """A wave counted in ``kernels.counters``: one wave (``kcore.waves``),
    the vertices it peeled (``kcore.peeled``) and, where it is the first
    wave to peel at its k, one level (``kcore.levels``)."""
    kernels.counters["kcore.waves"] += 1
    kernels.counters["kcore.peeled"] += peeled
    kernels.counters["kcore.levels"] += new_level


def run_fused_kcore(g: Graph, max_it: int) -> tuple:
    """Whole k-core decomposition on the edge axis, on the host's loop: one
    ``expand_segments`` for the initial degrees, then one ``kcore_sweep``
    per wave and one ``.tolist()`` to read its two scalars (``peel_wave``,
    in the span ``kcore.wave``; each wave counted by ``count_wave``).
    Returns (core int32 [Vp], sweeps)."""
    deg = init_deg_exp(g)
    core = torch.zeros_like(deg)
    spare_deg, spare_core = deg.clone(), core.clone()
    k = first_level(g)
    it, peel_k = 0, None
    while it < max_it and k < IMAX:
        with span("kcore.wave"):
            peeled, min_alive = peel_wave(g, deg, core, k, spare_deg,
                                          spare_core)
            deg, spare_deg = spare_deg, deg
            core, spare_core = spare_core, core
            count_wave(peeled, peeled > 0 and k != peel_k)
        if peeled:
            peel_k = k
        k = next_level(k, min_alive)
        it += 1
    return collapse_core_exp(g, core), it
