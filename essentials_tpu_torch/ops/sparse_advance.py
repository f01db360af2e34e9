"""Sparse-frontier advance: work proportional to the frontier's edges.

Counterpart of the spray tiers of ``essentials_tpu/ops/sparse_advance.py``
(:75, :160-271, its ``with_src`` as ``spray_sources``; reference parity:
the vector frontier and thread-mapped advance,
framework/frontier/vector_frontier.hxx, advance/thread_mapped.hxx).
The constants are the JAX package's, so that every step takes the same tier
in both packages: ``spray_enabled`` gates on ``_MIN_EDGES`` and the
algorithms choose per step (``tier``) between the tiny spray (sum of
degrees <= TINY_BUDGET and <= TINY_K members), the spray (<= SPRAY_BUDGET)
and the dense advance. The JAX package's candidate-matrix tier
(``sparse_reach``, ``sparse_relax_min`` and their gates) has no caller
there and is not carried.

The spray enumerates exactly the frontier's out-edges into ``budget``
static slots: member i owns slots [pfx[i], pfx[i] + deg[i]), and a
per-member constant reaches its slots by scattering its differences at the
members' first slots and an inclusive cumsum (int32 wrap-around makes the
telescoping exact, floats travel as bits). The cumsums and the members'
prefix run on the ``scan`` kernel; the gathers, scatters and sorts around
them are PyTorch glue, as XLA ran them in the JAX package.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.scan_kernels import cumsum

_MIN_EDGES = 1 << 21

SPRAY_BUDGET = 1 << 15        # candidate edge slots
SPRAY_K = 1 << 14             # index-list capacity
TINY_BUDGET = 1 << 12
TINY_K = 1 << 11
_BIG = 2 ** 30                # sort sentinel above every vertex id
IMAX = 2 ** 31 - 1


def compact_frontier(frontier: torch.Tensor, k: int,
                     fill: int) -> torch.Tensor:
    """[k] int32: the first <= k set indices, ascending, ``fill`` beyond.
    Each set index lands at its rank, an inclusive cumsum of the frontier
    minus one (the JAX package sorts; the output is the same)."""
    vp = frontier.numel()
    pos = cumsum(frontier) - 1
    slot = torch.where(frontier & (pos < k), pos, k).long()
    out = torch.full((k + 1,), fill, dtype=torch.int32,
                     device=frontier.device)
    out.scatter_(0, slot, torch.arange(vp, dtype=torch.int32,
                                       device=frontier.device))
    return out[:k]


def frontier_degree_sum(g: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """Total out-degree of a boolmap frontier, an int32 device scalar: the
    spray gate, computed without the index list."""
    deg = g.row_offsets[1:] - g.row_offsets[:-1]
    return torch.where(frontier, deg, 0).sum(dtype=torch.int32)


def spray_enabled(g: Graph) -> bool:
    """The graph must be big enough that a dense superstep costs more than
    the spray path's fixed floor."""
    return g.n_edges > _MIN_EDGES


def spray_k(g: Graph) -> int:
    return SPRAY_K


def frontier_out_degree(g: Graph, idx: torch.Tensor):
    """(offs [K], deg [K] int32) of an index-list frontier (pad slots get
    degree 0)."""
    offs = g.row_offsets[idx.long()]
    deg = torch.where(idx == g.pad_vertex, 0,
                      g.row_offsets[idx.long() + 1] - offs)
    return offs, deg.int()


def _expand_const(per_seg: torch.Tensor, pfx: torch.Tensor,
                  budget: int) -> torch.Tensor:
    """[budget] int32: per_seg[i] at every slot of member i. Its
    differences land at the members' first slots (a first slot equal to
    ``budget``, from trailing members of degree 0, is dropped), then an
    inclusive cumsum."""
    d = per_seg.clone()
    d[1:] -= per_seg[:-1]
    z = torch.zeros(budget + 1, dtype=torch.int32, device=per_seg.device)
    z.index_add_(0, torch.clamp(pfx, max=budget).long(), d)
    return cumsum(z[:budget])


def _prefix(deg: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of the members' degrees: each member's first
    slot."""
    return cumsum(deg) - deg


def spray_candidates(g: Graph, idx: torch.Tensor, offs: torch.Tensor,
                     deg: torch.Tensor, budget: int):
    """Every out-edge of the frontier in ``budget`` static slots; needs
    sum(deg) <= budget. Returns (e [B] edge ids, nb [B] destinations, valid
    [B], pfx [K] each member's first slot)."""
    pfx = _prefix(deg)
    total = pfx[-1] + deg[-1]
    j = torch.arange(budget, dtype=torch.int32, device=idx.device)
    valid = j < total
    e = torch.where(valid, j + _expand_const(offs - pfx, pfx, budget), 0)
    nb = g.col_indices[e.long()]
    return e, nb, valid, pfx


def spray_sources(idx: torch.Tensor, pfx: torch.Tensor,
                  budget: int) -> torch.Tensor:
    """[budget] int32: the source (frontier member) of each slot of
    ``spray_candidates``, from its ``pfx``; the JAX package's ``with_src``
    (:212). Pad members give ``pad_vertex``; slots past the last valid one
    hold some member's id."""
    return _expand_const(idx, pfx, budget)


def spray_dedup(nb: torch.Tensor, keep: torch.Tensor, k: int, fill: int):
    """Distinct kept candidates: (sorted_all [B] with 2^30 sentinels and
    duplicates last, idx [k] the first k distinct, count)."""
    s1 = torch.sort(torch.where(keep, nb, _BIG)).values
    dup = torch.zeros_like(keep)
    dup[1:] = s1[1:] == s1[:-1]
    s2 = torch.sort(torch.where(dup, _BIG, s1)).values
    count = (s2 < _BIG).sum(dtype=torch.int32)
    head = s2[:k]
    return s2, torch.where(head < _BIG, head, fill), count


def _mark(vp: int, ids: torch.Tensor) -> torch.Tensor:
    """bool[vp], True at the ids below vp (sentinels are dropped)."""
    out = torch.zeros(vp + 1, dtype=torch.bool, device=ids.device)
    out[torch.clamp(ids, max=vp).long()] = True
    return out[:vp]


def spray_reach(g: Graph, idx: torch.Tensor, offs: torch.Tensor,
                deg: torch.Tensor, unvisited: torch.Tensor, budget: int,
                k: int):
    """BFS reach over the sprayed out-edges: (newly bool[Vp], the unvisited
    vertices with an in-edge from the frontier; nidx [k], the first k of
    them; ncount)."""
    _, nb, valid, _ = spray_candidates(g, idx, offs, deg, budget)
    fresh = valid & unvisited[nb.long()]
    uniq, nidx, ncount = spray_dedup(nb, fresh, k, g.pad_vertex)
    return _mark(g.n_vertices_padded, uniq), nidx, ncount


def spray_relax_min(g: Graph, idx: torch.Tensor, offs: torch.Tensor,
                    deg: torch.Tensor, dist: torch.Tensor, budget: int,
                    k: int):
    """SSSP relaxation over the sprayed out-edges. Returns (cand f32[Vp],
    the min over frontier in-edges of dist[src] + w, +inf elsewhere; pred
    int32[Vp], the smallest source achieving cand; nidx [k], the first k
    distinct improved destinations; ncount). Tie-breaks match the dense
    advance."""
    e, nb, valid, pfx = spray_candidates(g, idx, offs, deg, budget)
    pad = idx == g.pad_vertex
    src_d = torch.where(pad, 0.0, dist[idx.long()])
    d_e = _expand_const(src_d.view(torch.int32), pfx,
                        budget).view(torch.float32)
    cand_e = torch.where(valid, d_e + g.values[e.long()], float("inf"))
    nbl = nb.long()
    vp = g.n_vertices_padded
    cand = torch.full((vp,), float("inf"), dtype=dist.dtype,
                      device=dist.device).scatter_reduce_(0, nbl, cand_e,
                                                          "amin")
    achieves = valid & (cand_e == cand[nbl])
    src_e = _expand_const(torch.where(pad, 0, idx), pfx, budget)
    pred = torch.full((vp,), IMAX, dtype=torch.int32, device=dist.device)
    pred.scatter_reduce_(0, nbl, torch.where(achieves, src_e, IMAX), "amin")
    improved_nb = valid & (cand_e <= cand[nbl]) & (cand[nbl] < dist[nbl])
    _, nidx, ncount = spray_dedup(nb, improved_nb, k, g.pad_vertex)
    return cand, pred, nidx, ncount


# ------------------------------------------------------------ tier choice --
# The JAX package keeps the index list's count and validity on the device
# and picks each step's tier with ``lax.switch``. Here they, the frontier's
# degree sum and its size are host values, read in one transfer at the end
# of each step (``read_control``), and the host picks the tier.

def tier(state) -> int:
    """The tier of the next step (0 tiny spray, 1 spray, 2 dense), as the
    JAX package's branch: tiny spray when the index list is current
    (``fvalid``), its degree sum fits TINY_BUDGET and it holds at most
    TINY_K members; spray when the sum fits SPRAY_BUDGET; dense otherwise."""
    if state.fvalid and state.degsum <= TINY_BUDGET \
            and state.fcount <= TINY_K:
        return 0
    return 1 if state.fvalid and state.degsum <= SPRAY_BUDGET else 2


def pad_index_list(g: Graph, nidx: torch.Tensor, k: int) -> torch.Tensor:
    """``nidx`` extended to ``k`` entries with the pad vertex (a tiny-spray
    list is TINY_K long, the state's SPRAY_K)."""
    if nidx.numel() == k:
        return nidx
    return torch.cat([nidx, torch.full((k - nidx.numel(),), g.pad_vertex,
                                       dtype=torch.int32, device=g.device)])


def compact_if_fits(g: Graph, newly: torch.Tensor,
                    fc: torch.Tensor) -> torch.Tensor:
    """The next index list after a dense step: the first K members when
    the frontier fits K, else all pad (as the JAX package's lax.cond; the
    compaction runs either way, which saves a host read)."""
    k = spray_k(g)
    return torch.where(fc <= k, compact_frontier(newly, k, g.pad_vertex),
                       g.pad_vertex)


def read_control(g: Graph, frontier: torch.Tensor,
                 fc: torch.Tensor | None) -> tuple:
    """(live, degsum, fcount) on the host in one transfer; without the
    spray (``fc`` None) only the frontier's size is read."""
    size = frontier.sum(dtype=torch.int32)
    if fc is None:
        return int(size), 0, 0
    return tuple(torch.stack([size, frontier_degree_sum(g, frontier),
                              fc.to(torch.int32)]).tolist())
