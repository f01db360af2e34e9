"""Fused edge-axis BFS on symmetric-layout graphs.

Counterpart of ``essentials_tpu/ops/fused_bfs.py`` (``init_lev_exp``,
``fused_superstep``, ``collapse_lev_exp``, and the segment fills and route
OR ``segment_broadcast_total``, ``suffix_fill_update``, ``fused_route_or``).
On a symmetric layout (``csc_offsets == row_offsets``) an array indexed by
"segment of position" means the same on the CSR and the CSC axis, so BFS
state lives on the edge axis as ``lev_exp[p] = level[segment(p)]``. The
state is start-authoritative: only each segment's start position
``row_offsets[v]`` is read or written.

Two forms of the level array: int32 with sentinel ``UNREACHED`` (int32 max),
and int8 with sentinel ``UNREACHED_E`` = 127, for searches of at most 126
levels. The int8 form moves a quarter of the bytes per level.

The JAX package's 5-pass level (``fused_bfs.py:11-14``) is also here,
``five_pass_superstep``, on a level array that holds each vertex's level at
every position of its segment (``init_lev_exp``'s int32 form is one):
``fused_route_or`` (frontier test, CSR->CSC move, segmented OR), the
segmented sum ``scan``, then ``suffix_fill_update``. ``bfs.run`` runs the
one ``bfs_level`` kernel instead; PageRank ``fused`` uses
``segment_broadcast_total``.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.scan_kernels import segmented_scan

UNREACHED = kernels.INT32_MAX
UNREACHED_E = 127           # int8-form sentinel (levels <= 126)


def init_lev_exp(g: Graph, source: int,
                 unreached: int = UNREACHED) -> torch.Tensor:
    """lev_exp[p] = 0 where segment(p) == source else ``unreached``, on
    ``g``'s device: int8 when ``unreached`` fits a byte (the int8 form),
    int32 otherwise. The source's segment is the contiguous CSR range
    [row_offsets[source], row_offsets[source+1])."""
    o0, o1 = g.row_offsets[source:source + 2].tolist()
    dtype = torch.int8 if unreached <= UNREACHED_E else torch.int32
    lev = torch.full((g.n_edges_padded,), unreached, dtype=dtype,
                     device=g.device)
    lev[o0:o1] = 0
    return lev


def fused_superstep(g: Graph, lev_exp: torch.Tensor, it: int, *,
                    unreached: int = UNREACHED) -> tuple:
    """One BFS level (the ``bfs_level`` kernel: a push along the CSR
    columns from the frontier or a pull over the CSC sources into the
    unreached vertices). Updates ``lev_exp`` IN PLACE at segment starts and
    returns (lev_exp, newly-reached count int32 [1]). The JAX fallback
    writes whole segments; the two agree at segment starts, which is all
    either reads."""
    cnt = kernels.bfs_level(lev_exp, g.row_offsets, g.csc_src_indices,
                            g.col_indices, it, unreached)
    return lev_exp, cnt


def collapse_lev_exp(g: Graph, lev_exp: torch.Tensor, source: int,
                     unreached: int = UNREACHED) -> torch.Tensor:
    """lev_exp -> per-vertex distances [Vp] int32 (the ``collapse_levels``
    kernel), translating the edge-axis sentinel to UNREACHED. Empty segments
    are UNREACHED except the source itself."""
    return kernels.collapse_levels(lev_exp, g.row_offsets, source, unreached)


def segment_broadcast_total(S: torch.Tensor,
                            start_flags: torch.Tensor) -> torch.Tensor:
    """Broadcast each segment's END value (e.g. its inclusive-scan total)
    to every position of the segment (the ``segment_broadcast_total``
    kernel). [Ep] int32 or float32 in, the same out."""
    return kernels.segment_broadcast_total(S, start_flags)


def suffix_fill_update(S: torch.Tensor, start_flags: torch.Tensor,
                       lev: torch.Tensor, it: int) -> tuple:
    """(new lev_exp, any newly-reached int32 [1]): each position whose
    segment's END value of the int32 ``S`` is above 0 and whose level is
    UNREACHED takes ``it`` (the ``suffix_fill_update`` kernel). All arrays
    [Ep]; the level array must hold whole segments."""
    return kernels.suffix_fill_update(S, start_flags, lev, it)


def fused_route_or(g: Graph, lev_exp: torch.Tensor, it: int) -> torch.Tensor:
    """(lev_exp == it) -> CSR->CSC move -> segmented OR over the CSC
    segments (the ``fused_route_or`` kernel): [Ep] int32, 1 at slot q when
    some in-edge of q's destination at or before q comes from level ``it``.
    The move is a gather through ``g.csc_edge_ids``."""
    return kernels.fused_route_or(lev_exp, g.csc_edge_ids, g.csc_seg_flags,
                                  it)


def five_pass_superstep(g: Graph, lev_exp: torch.Tensor, it: int) -> tuple:
    """One BFS level on whole-segment int32 levels (``fused_bfs.py:11-14``):
    every vertex with an in-neighbour at level ``it`` that is UNREACHED gets
    ``it + 1`` at every position of its segment. Returns (the new lev_exp,
    any newly-reached int32 [1])."""
    s = segmented_scan(fused_route_or(g, lev_exp, it), g.csc_seg_flags, "add")
    return suffix_fill_update(s, g.csc_seg_flags, lev_exp, it + 1)
