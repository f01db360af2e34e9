"""The kernels of ``csrc/bfs_kernels.cu``: the fused BFS level, its collapse
to distances and its predecessors, and the segment fills of
``ops/fused_bfs.py`` (PageRank ``fused`` and the five-pass superstep). The
sizes of the predecessor walk (``csrc/first_hit.cuh``) and of the push
lists (``csrc/push_list.cuh``), which ``sssp_kcore``'s kernels share, are
here."""

from __future__ import annotations

import torch

from essentials_tpu_torch.errors import throw_if

from ._lib import (INT32_MAX, Kernel, P, I, _check, _check_flags,
                   _check_graph, _launch, _read_scalars, _route,
                   _segment_ids, _spanned, _start_values, counters, declare,
                   launches, pass_launches)
from .operators import advance_count_tier, bitmap_words

__all__ = ["BFS_FORMS", "BFS_LEVEL_SCALARS", "BFS_PULL_ALPHA",
           "BFS_PULL_BETA", "FILL_TILE", "PUSH_SPLIT", "bfs_level",
           "bfs_level_count", "bfs_level_plain", "bfs_level_pulls",
           "bfs_predecessors", "bfs_predecessors_plain", "collapse_levels",
           "collapse_levels_plain", "fill_scratch", "fill_tiles",
           "pred_ranges", "pred_scratch", "push_ranges",
           "segment_broadcast_total", "segment_broadcast_total_plain",
           "suffix_fill_update", "suffix_fill_update_plain"]

BFS_FORMS = ("device", "push", "pull")             # codes 0-2 in the .cu
# bfs_level pulls where the frontier's out-slots m_f times BFS_PULL_ALPHA
# pass the unreached vertices' in-slots m_u and its vertices n_f times
# BFS_PULL_BETA reach Vp (Beamer's direction-optimizing rules, with his
# alpha and beta): the push reads m_f slots, the pull at most m_u, and a
# small frontier is pushed, since the pull's fixed cost is a pass over
# every word of the unreached bitmap
BFS_PULL_ALPHA = 14
BFS_PULL_BETA = 24
BFS_LEVEL_SCALARS = 8          # words before bfs_level's bitmaps (the .cu's)
FILL_TILE = 4096               # positions per fill tile (kFillTile)
PUSH_SPLIT = 32                # slots per range of the push lists
# The predecessor kernels (csrc/first_hit.cuh): the first walk gives each
# reached vertex 8 lanes over at most the first PRED_SPLIT slots of its
# segment and lists the rest of a segment without a hit there as ranges of
# PRED_SPLIT slots, which the range walk spreads over the card, a warp a
# range. Measured by chip_ab.py's pred group (NVIDIA H100 80GB HBM3,
# 700 W): at rmat18 a split of 256 was 3% ahead of 512 for BFS and 10%
# for SSSP, and 1,024 19-37% behind; at gen:rmat20x16 all three were
# within 5% of one another
PRED_SPLIT = 256

declare(
    "bfs_kernels.cu",
    Kernel(launches={"bfs_level<int32>": "fused_bfs.py:327",
                     "bfs_level<int8>": "fused_bfs.py:425"},
           passes=("bfs_level_list_kernel", "bfs_level_push_kernel",
                   "bfs_level_pull_kernel"),
           entries={"etpu_bfs_level_i32": (P, P, P, P, I, I, I, I, I, I, I,
                                           P, P),
                    "etpu_bfs_level_i8": (P, P, P, P, I, I, I, I, I, I, I,
                                          P, P),
                    "etpu_read_level_scalars": (P, P, I, P)},
           constants={"etpu_bfs_level_scalars": ("BFS_LEVEL_SCALARS",
                                                 BFS_LEVEL_SCALARS)}),
    Kernel(launches={"collapse_levels<int32>": "cube_router.py:305",
                     "collapse_levels<int8>": "cube_router.py:305"},
           entries={"etpu_collapse_levels_i32": (P, P, I, I, I, P, P),
                    "etpu_collapse_levels_i8": (P, P, I, I, I, P, P)}),
    Kernel(launches={"bfs_predecessors": "cube_router.py:586"},
           passes=("bfs_predecessors_ranges_kernel",),
           entries={"etpu_bfs_predecessors": (P, P, P, I, I, I, P, P, P)}),
    Kernel(launches={"segment_broadcast_total": "fused_bfs.py:262",
                     "suffix_fill_update": "fused_bfs.py:137"},
           entries={"etpu_segment_fill": (P, P, I, P, I, P, P, P)},
           constants={"etpu_fill_tile": ("FILL_TILE", FILL_TILE)}))


def bfs_level_plain(lev, offsets, csc_src, col, it: int, unreached: int):
    """Plain version of ``bfs_level`` (same contract, same in-place write):
    the pull over ``csc_src``, the definition; ``col`` is only the
    kernel's."""
    nonempty, starts, lev_v = _start_values(lev, offsets, unreached)
    hit = torch.zeros(lev_v.numel(), dtype=torch.int32, device=lev.device)
    hit.index_add_(0, _segment_ids(offsets, lev.numel()),
                   (lev_v[csc_src.long()] == it).int())
    newly = nonempty & (lev_v == unreached) & (hit > 0)
    lev[starts[newly]] = it + 1
    return newly.sum(dtype=torch.int32).reshape(1)


def bfs_level_form() -> str:
    """The form every ``bfs_level`` launch takes, one of BFS_FORMS:
    "device", the card's choice per level from the pass's sums
    (``bfs_level_pulls``), or "push" or "pull" throughout. Tests and
    chip_smoke bind it to a constant to force a form (chip_smoke.bfs_form);
    the result is the same in every form."""
    return "device"


def bfs_level_pulls(m_f: int, m_u: int, n_f: int, vp: int) -> bool:
    """The card's choice under form "device": pull where the frontier's
    out-slots ``m_f`` times BFS_PULL_ALPHA pass the unreached vertices'
    in-slots ``m_u`` and its ``n_f`` vertices times BFS_PULL_BETA reach
    ``vp``, else push."""
    return m_f * BFS_PULL_ALPHA > m_u and n_f * BFS_PULL_BETA >= vp


def bfs_level_count(cnt: torch.Tensor) -> int:
    """The vertices a ``bfs_level`` call reached, read to the host from its
    count ``cnt``: the level's one wait on the device. On the kernel's
    route one copy into pinned memory (``_read_scalars``) brings the words
    that follow the count in the call's scratch (0-5: the count, the ranges
    listed, m_f, m_u, n_f, the form the card took, 1 push or 2 pull as in
    BFS_FORMS), and ``counters`` takes that form: ``bfs_level.push`` with
    m_f in ``.push_slots``, or ``bfs_level.pull`` with m_u in
    ``.pull_slots``. The plain version's count is read alone."""
    if not _route("bfs_level", cnt):
        return int(cnt.item())
    reached, _, m_f, m_u, _, form = _read_scalars(cnt, 6)
    pulls = BFS_FORMS[form] == "pull"
    tag = "bfs_level.pull" if pulls else "bfs_level.push"
    counters[tag] += 1
    counters[tag + "_slots"] += m_u if pulls else m_f
    return reached


def push_ranges(vp: int, ep: int) -> int:
    """The most ranges a sweep's push list can hold: a row of L slots is
    ceil(L / PUSH_SPLIT) ranges."""
    return vp + -(-ep // PUSH_SPLIT)


@_spanned
def bfs_level(lev: torch.Tensor, offsets: torch.Tensor,
              csc_src: torch.Tensor, col: torch.Tensor, it: int,
              unreached: int,
              max_shared_bytes: int | None = None) -> torch.Tensor:
    """One BFS level on the edge axis of a symmetric-layout graph.

    ``lev`` ([Ep] int32 or int8) holds each segment's level at its start
    position ``offsets[v]``; other positions are neither read nor written.
    Every vertex whose start holds ``unreached`` and that has an in-neighbour
    at level ``it`` gets ``it + 1``, IN PLACE. Returns the number of vertices
    reached, int32 [1], on ``lev``'s device.

    The plain version pulls over ``csc_src`` ([Ep] int32, the source of each
    CSC slot). The kernel is four device launches: a pass over the vertices
    (counted in ``launches``) that packs the frontier and the unreached
    vertices into bitmaps and sums them, then a list of the frontier's CSR
    rows and a push along them (``col``, [Ep] int32: on a symmetric layout
    a vertex's row lies at its segment, and its columns are the vertices
    whose pull finds it, directed or not), and a pull into the unreached
    vertices; the kernels of one form return at once (``pass_launches``):
    the card chooses by ``bfs_level_pulls`` unless ``bfs_level_form``
    forces one.
    The pull holds the frontier's bits in shared memory where
    ``advance_count_tier`` says "shared" (under ``max_shared_bytes`` when
    given; 0 forces "global")."""
    name = f"bfs_level<{'int8' if lev.dtype == torch.int8 else 'int32'}>"
    throw_if(lev.dtype not in (torch.int8, torch.int32) or lev.dim() != 1,
             f"{name}: lev must be [Ep] int8 or int32")
    throw_if(not (0 <= it and it + 1 < unreached
                  <= torch.iinfo(lev.dtype).max),
             f"{name}: need 0 <= it and it + 1 < unreached <= dtype max")
    ep = lev.numel()
    _check_graph(name, ep, offsets, csc_src)
    _check_graph(name, ep, offsets, col, "col")
    form = bfs_level_form()
    throw_if(form not in BFS_FORMS, f"{name}: form must be one of {BFS_FORMS}")
    if not _route(name, lev):
        return bfs_level_plain(lev, offsets, csc_src, col, it, unreached)
    dev = lev.device
    _check(name, dev, lev=lev, offsets=offsets, csc_src=csc_src, col=col)
    vp = offsets.numel() - 1
    shared = advance_count_tier(vp, dev, max_shared_bytes) == "shared"
    # the scalars (the count first), the frontier's and the unreached
    # vertices' bitmaps, then room for the listed ranges (int4) where the
    # push may run
    buf = torch.empty(BFS_LEVEL_SCALARS + 2 * bitmap_words(vp) + (
        4 * push_ranges(vp, ep) if form != "pull" else 0),
        dtype=torch.int32, device=dev)
    _launch("etpu_bfs_level_i8" if lev.dtype == torch.int8
            else "etpu_bfs_level_i32", dev, lev.data_ptr(),
            offsets.data_ptr(), csc_src.data_ptr(), col.data_ptr(), vp, it,
            unreached, BFS_FORMS.index(form), BFS_PULL_ALPHA, BFS_PULL_BETA,
            int(shared), buf.data_ptr())
    launches[name] += 1
    pass_launches["bfs_level_list"] += 1
    pass_launches["bfs_level_push"] += 1
    pass_launches["bfs_level_pull"] += 1
    return buf[:1]


def collapse_levels_plain(lev, offsets, source: int, unreached: int):
    """Plain version of ``collapse_levels``."""
    lv = _start_values(lev, offsets, unreached)[2]
    dist = torch.where(lv < unreached, lv.int(), INT32_MAX)
    dist[source] = 0
    return dist


@_spanned
def collapse_levels(lev: torch.Tensor, offsets: torch.Tensor, source: int,
                    unreached: int) -> torch.Tensor:
    """Edge-axis levels -> [Vp] int32 distances: the level at each non-empty
    segment's start when below ``unreached``, else INT32_MAX; 0 at
    ``source``."""
    name = f"collapse_levels<{'int8' if lev.dtype == torch.int8 else 'int32'}>"
    throw_if(lev.dtype not in (torch.int8, torch.int32) or lev.dim() != 1,
             f"{name}: lev must be [Ep] int8 or int32")
    _check_graph(name, lev.numel(), offsets)
    vp = offsets.numel() - 1
    throw_if(not 0 <= source < vp, f"{name}: source {source} out of range")
    if not _route(name, lev):
        return collapse_levels_plain(lev, offsets, source, unreached)
    _check(name, lev.device, lev=lev, offsets=offsets)
    dist = torch.empty(vp, dtype=torch.int32, device=lev.device)
    fn = ("etpu_collapse_levels_i8" if lev.dtype == torch.int8
          else "etpu_collapse_levels_i32")
    _launch(fn, lev.device, lev.data_ptr(), offsets.data_ptr(), vp, source,
            unreached, dist.data_ptr())
    launches[name] += 1
    return dist


def bfs_predecessors_plain(dist, offsets, csc_src, n_edges: int):
    """Plain version of ``bfs_predecessors``."""
    seg = _segment_ids(offsets, csc_src.numel())[:n_edges]
    src = csc_src[:n_edges].long()
    ds = dist[src].long()
    ok = (ds != INT32_MAX) & (ds + 1 == dist[seg].long())
    cand = torch.where(ok, src, INT32_MAX)
    best = torch.full((dist.numel(),), INT32_MAX, dtype=torch.int64,
                      device=dist.device)
    best.scatter_reduce_(0, seg, cand, "amin")
    valid = (dist != INT32_MAX) & (dist > 0) & (best < INT32_MAX)
    return torch.where(valid, best, -1).int()


@_spanned
def bfs_predecessors(dist: torch.Tensor, offsets: torch.Tensor,
                     csc_src: torch.Tensor, n_edges: int) -> torch.Tensor:
    """[Vp] int32: the smallest-id in-neighbour one level up over the real
    in-edges (CSC slots below ``n_edges``); -1 at the source, at unreached
    vertices and where there is none. ``offsets`` are the CSC offsets.

    Two device launches (``csrc/first_hit.cuh``): the first walk, counted
    in ``launches``, and the range walk, in ``pass_launches``."""
    name = "bfs_predecessors"
    vp = offsets.numel() - 1
    throw_if(dist.dtype != torch.int32 or dist.shape != (vp,),
             f"{name}: dist must be [Vp] int32")
    _check_graph(name, csc_src.numel(), offsets, csc_src)
    throw_if(not 0 <= n_edges <= csc_src.numel(),
             f"{name}: n_edges out of range")
    if not _route(name, dist):
        return bfs_predecessors_plain(dist, offsets, csc_src, n_edges)
    return _predecessors("etpu_bfs_predecessors", name, dist, offsets,
                         csc_src, n_edges)


def _predecessors(entry: str, name: str, dist, offsets, csc_src,
                  n_edges: int, *w) -> torch.Tensor:
    """Launch predecessor kernel ``entry`` (the two walks of
    ``csrc/first_hit.cuh``), with the weights ``w`` where it takes them."""
    _check(name, dist.device, dist=dist, offsets=offsets, csc_src=csc_src,
           **{"w": t for t in w})
    vp = offsets.numel() - 1
    pred = torch.empty(vp, dtype=torch.int32, device=dist.device)
    scratch = pred_scratch(csc_src.numel(), dist.device)
    _launch(entry, dist.device, dist.data_ptr(), offsets.data_ptr(),
            csc_src.data_ptr(), *(t.data_ptr() for t in w), vp, n_edges,
            PRED_SPLIT, pred.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    pass_launches[name + "_ranges"] += 1
    return pred


def pred_ranges(ep: int, split: int) -> int:
    """The most ranges the predecessors' first walk can list: a segment of
    L > split slots lists ceil((L - split) / split) <= L // split."""
    return ep // split + 1


def pred_scratch(ep: int, device: torch.device) -> torch.Tensor:
    """The predecessor kernels' scratch: the count of listed ranges and 3
    unused words, then room for every range (int4); the C call zeroes the
    count."""
    throw_if(PRED_SPLIT < 1,
             f"predecessors: PRED_SPLIT {PRED_SPLIT} must be positive")
    return torch.empty(4 + 4 * pred_ranges(ep, PRED_SPLIT),
                       dtype=torch.int32, device=device)


def _segment_ends(flags: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64: the END of each position's segment, the first p' >= p
    with p' = n - 1 or flags[p' + 1] set."""
    end = torch.ones(n, dtype=torch.bool, device=flags.device)
    end[:-1] = flags[1:].bool()
    pos = torch.where(end, torch.arange(n, device=flags.device), n)
    return torch.flip(torch.cummin(torch.flip(pos, (0,)), 0).values, (0,))


def fill_tiles(n: int) -> int:
    """Tiles of one segment fill launch over ``n`` positions, one block
    each."""
    return -(-n // FILL_TILE)


def fill_scratch(n: int, device) -> torch.Tensor:
    """The int32 scratch of one segment fill launch over ``n`` positions:
    the tiles' 64-bit status words, the ticket, and (last) the update's
    any-flag; the C call zeroes all of it."""
    return torch.empty(2 * fill_tiles(n) + 2, dtype=torch.int32,
                       device=device)


def _fill(name: str, S, flags, lev=None, it: int = 0):
    """Launch etpu_segment_fill: the broadcast (lev None) or the update,
    whose any-flag is returned as a view of the scratch."""
    dev, n = S.device, S.numel()
    _check(name, dev, S=S, start_flags=flags,
           **({} if lev is None else {"lev": lev}))
    out = torch.empty_like(S)
    scratch = fill_scratch(n, dev)
    any_ = None if lev is None else scratch[-1:]
    _launch("etpu_segment_fill", dev, S.data_ptr(), flags.data_ptr(), n,
            None if lev is None else lev.data_ptr(), it, out.data_ptr(),
            scratch.data_ptr())
    launches[name] += 1
    return out, any_


def segment_broadcast_total_plain(S, start_flags):
    """Plain version of ``segment_broadcast_total``."""
    if S.numel() == 0:
        return S.clone()
    return S[_segment_ends(start_flags, S.numel())]


@_spanned
def segment_broadcast_total(S: torch.Tensor,
                            start_flags: torch.Tensor) -> torch.Tensor:
    """[n] of S's dtype: every position takes S at its segment's END (the
    slot before the next start flag; the last position always ends one).
    S is [n] int32 or float32, moved as bits; ``start_flags`` [n] bool or
    uint8 mark segment starts (flags[0] is not read)."""
    name = "segment_broadcast_total"
    throw_if(S.dtype not in (torch.int32, torch.float32) or S.dim() != 1,
             f"{name}: S must be 1-D int32 or float32")
    _check_flags(name, start_flags, S.numel())
    if not _route(name, S):
        return segment_broadcast_total_plain(S, start_flags)
    return _fill(name, S, start_flags)[0]


def suffix_fill_update_plain(S, start_flags, lev, it: int):
    """Plain version of ``suffix_fill_update``."""
    fill = segment_broadcast_total_plain(S, start_flags)
    newly = (fill > 0) & (lev == INT32_MAX)
    return (torch.where(newly, it, lev).int(),
            newly.any().int().reshape(1))


@_spanned
def suffix_fill_update(S: torch.Tensor, start_flags: torch.Tensor,
                       lev: torch.Tensor, it: int) -> tuple:
    """The segment-end fill of the int32 ``S``, then a BFS level update:
    every position whose fill is above 0 and whose ``lev`` is INT32_MAX
    (unreached) takes ``it``. Returns (the new lev [n] int32, whether any
    position changed as int32 [1]); ``lev`` is not written."""
    name = "suffix_fill_update"
    throw_if(S.dtype != torch.int32 or S.dim() != 1,
             f"{name}: S must be 1-D int32")
    throw_if(lev.dtype != torch.int32 or lev.shape != S.shape,
             f"{name}: lev must be [n] int32 like S")
    _check_flags(name, start_flags, S.numel())
    throw_if(not -INT32_MAX - 1 <= it <= INT32_MAX, f"{name}: it out of range")
    if not _route(name, S):
        return suffix_fill_update_plain(S, start_flags, lev, it)
    return _fill(name, S, start_flags, lev, it)
