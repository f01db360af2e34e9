"""Fused edge-axis BFS on symmetric-layout graphs.

Counterpart of ``essentials_tpu/ops/fused_bfs.py`` (``init_lev_exp``,
``fused_superstep``, ``collapse_lev_exp``). On a symmetric layout
(``csc_offsets == row_offsets``) an array indexed by "segment of position"
means the same on the CSR and the CSC axis, so BFS state lives on the edge
axis as ``lev_exp[p] = level[segment(p)]``. The state is start-authoritative:
only each segment's start position ``row_offsets[v]`` is read or written.

Two forms of the level array: int32 with sentinel ``UNREACHED`` (int32 max),
and int8 with sentinel ``UNREACHED_E`` = 127, for searches of at most 126
levels. The int8 form moves a quarter of the bytes per level.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.graph.graph import Graph

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
    """One BFS level (the ``bfs_level`` kernel). Updates ``lev_exp`` IN
    PLACE at segment starts and returns (lev_exp, newly-reached count int32
    [1]). The JAX fallback writes whole segments; the two agree at segment
    starts, which is all either reads."""
    cnt = kernels.bfs_level(lev_exp, g.row_offsets, g.csc_src_indices, it,
                            unreached)
    return lev_exp, cnt


def collapse_lev_exp(g: Graph, lev_exp: torch.Tensor, source: int,
                     unreached: int = UNREACHED) -> torch.Tensor:
    """lev_exp -> per-vertex distances [Vp] int32 (the ``collapse_levels``
    kernel), translating the edge-axis sentinel to UNREACHED. Empty segments
    are UNREACHED except the source itself."""
    return kernels.collapse_levels(lev_exp, g.row_offsets, source, unreached)
