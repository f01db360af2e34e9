"""The kernels of ``csrc/sssp_kcore_kernels.cu``: the fused SSSP sweep and
its predecessors, the k-core peel waves, and the collapse and expansion of
edge-axis state that both searches' routed forms use. The push lists and
the predecessor walk are ``bfs``'s (its ``PUSH_SPLIT`` and ``PRED_SPLIT``)."""

from __future__ import annotations

import torch

from essentials_tpu_torch.errors import throw_if

from ._lib import (INF_BITS, INT32_MAX, Kernel, P, I, _check, _check_disjoint,
                   _check_graph, _check_state, _check_weights, _launch,
                   _read_scalars, _route, _segment_ids, _spanned,
                   _start_values, declare, launches, pass_launches)
from .bfs import PUSH_SPLIT, _predecessors, push_ranges

__all__ = ["EXPAND_TILE", "collapse_starts", "collapse_starts_plain",
           "expand_segments", "expand_segments_plain", "kcore_cascade_wave",
           "kcore_cascade_wave_plain", "kcore_level_wave",
           "kcore_level_wave_plain", "kcore_wave_read", "kcore_wave_scratch",
           "kcore_wave_words", "sssp_predecessors", "sssp_predecessors_plain",
           "sssp_sweep", "sssp_sweep_count", "sssp_sweep_plain"]

# merge places per expand_segments tile (kExpandTile). Measured by
# chip_ab.py's starts group (NVIDIA H100 80GB HBM3, 700 W): tiles of 2,048
# and 8,192 places took 3-21% more device time at weighted rmat18 and
# gen:rmat20x16
EXPAND_TILE = 4096

declare(
    "sssp_kcore_kernels.cu",
    Kernel(launches={"sssp_sweep": "fused_sssp.py:132"},
           passes=("sssp_sweep_push_kernel", "sssp_sweep_update_kernel"),
           entries={"etpu_sssp_sweep": (P, P, P, P, P, I, P, P)},
           constants={"etpu_push_split": ("PUSH_SPLIT", PUSH_SPLIT)}),
    Kernel(launches={"sssp_predecessors": "cube_router.py:586"},
           passes=("sssp_predecessors_ranges_kernel",),
           entries={"etpu_sssp_predecessors": (P, P, P, P, I, I, I, P, P,
                                               P)}),
    Kernel(launches={"kcore_level_wave": "fused_kcore.py:144"},
           passes=("kcore_level_peel_kernel", "kcore_wave_push_kernel"),
           entries={"etpu_kcore_level_wave": (P, P, P, P, I, P, P, P)}),
    Kernel(launches={"kcore_cascade_wave": "fused_kcore.py:144"},
           passes=("kcore_wave_push_kernel",),
           entries={"etpu_kcore_cascade_wave": (P, P, P, P, I, I, P, I, P, P,
                                                P)}),
    Kernel(launches={"collapse_starts": "cube_router.py:385"},
           entries={"etpu_collapse_starts": (P, P, I, I, I, P, P)}),
    Kernel(launches={"expand_segments": "scan_kernels.py:274"},
           entries={"etpu_expand_segments": (P, P, I, I, P, P)},
           constants={"etpu_expand_tile": ("EXPAND_TILE", EXPAND_TILE)}))


def sssp_sweep_plain(dist_in, dist_out, offsets, col, w):
    """Plain version of ``sssp_sweep`` (same contract, same writes): the
    messages of the changed vertices' rows, min-reduced per column. The
    count is the first of the kernel's scalar words, which follow it."""
    nonempty, starts, dv = _start_values(dist_in, offsets, INF_BITS)
    changed = nonempty & (dv != _start_values(dist_out, offsets,
                                              INF_BITS)[2])
    row = _segment_ids(offsets, w.numel())
    msg = (dv.view(torch.float32)[row] + w).view(torch.int32)
    s = torch.full_like(dv, INF_BITS).scatter_reduce_(
        0, col.long(), torch.where(changed[row], msg, INF_BITS), "amin")
    dist_out[starts[nonempty]] = torch.minimum(s, dv)[nonempty]
    lengths = torch.where(changed, offsets[1:] - offsets[:-1], 0)
    words = torch.stack((
        (nonempty & (s < dv)).sum(dtype=torch.int32),
        ((lengths + PUSH_SPLIT - 1) // PUSH_SPLIT).sum(dtype=torch.int32),
        lengths.sum(dtype=torch.int32),
        torch.zeros((), dtype=torch.int32, device=dv.device)))
    return words[:1]


@_spanned
def sssp_sweep(dist_in: torch.Tensor, dist_out: torch.Tensor,
               offsets: torch.Tensor, col: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """One Bellman-Ford sweep on the edge axis of a symmetric-layout graph.

    ``dist_in`` and ``dist_out`` ([Ep] int32, distinct buffers) hold float32
    distance bits at segment starts: ``dist_in`` the distances d_t after
    sweep t, ``dist_out`` those of the sweep before, d_{t-1} (+inf bits
    before the first sweep; the ping-pong buffers of a search hold just
    that). For each vertex v with a non-empty segment, ``dist_out[offsets[
    v]]`` becomes the smaller of d_t[v] and the bits of min f32(d_t[u] +
    w[q]) over the CSR slots q of the vertices u whose distance changed
    (d_t[u] != d_{t-1}[u]) with ``col[q]`` == v; ``col`` and ``w`` ([Ep]
    int32 and float32) are the CSR columns and weights. That is the full
    sweep's result (an unchanged u's messages were folded in sweep t). No
    other position is read or written. Returns the number of vertices
    whose distance fell, int32 [1], on the state's device, followed in
    memory by the ranges listed and the CSR slots the push read
    (``sssp_sweep_count``).

    The kernel is three device launches: the dense pass, counted in
    ``launches``, then the push from the changed rows into a [Vp] copy of
    the distances and the update of the starts from it, in
    ``pass_launches``."""
    name = "sssp_sweep"
    ep = col.numel()
    _check_state(name, ep, dist_in=dist_in, dist_out=dist_out)
    _check_weights(name, ep, w)
    _check_graph(name, ep, offsets, col, "col")
    kernel = _route(name, dist_in)
    _check_disjoint(name, dist_in=dist_in, dist_out=dist_out)
    if not kernel:
        return sssp_sweep_plain(dist_in, dist_out, offsets, col, w)
    dev = dist_in.device
    _check(name, dev, dist_in=dist_in, dist_out=dist_out, offsets=offsets,
           col=col, w=w)
    vp = offsets.numel() - 1
    vp4 = -(-vp // 4) * 4
    # the scalars (improved, ranges listed, slots listed, 1 unused), two
    # [Vp] copies of the distances, then room for every listed range
    # (int4)
    buf = torch.empty(4 + 2 * vp4 + 4 * push_ranges(vp, ep),
                      dtype=torch.int32, device=dev)
    _launch("etpu_sssp_sweep", dev, dist_in.data_ptr(), dist_out.data_ptr(),
            offsets.data_ptr(), col.data_ptr(), w.data_ptr(), vp,
            buf.data_ptr())
    launches[name] += 1
    pass_launches["sssp_sweep_push"] += 1
    pass_launches["sssp_sweep_update"] += 1
    return buf[:1]


def sssp_sweep_count(cnt: torch.Tensor) -> tuple:
    """(The vertices an ``sssp_sweep`` call improved, the CSR slots its
    push read: the changed vertices' row lengths), read to the host from
    its count ``cnt`` and the words that follow it: the sweep's one wait
    on the device. On the kernel's route one copy into pinned memory
    (``_read_scalars``) brings the scratch's first three words
    (the count, the ranges listed, the slots listed)."""
    if not _route("sssp_sweep", cnt):
        improved, _, slots = cnt.as_strided((3,), (1,)).tolist()
        return improved, slots
    words = _read_scalars(cnt, 3)
    return words[0], words[2]


def sssp_predecessors_plain(dist, offsets, csc_src, w, n_edges: int):
    """Plain version of ``sssp_predecessors``."""
    seg = _segment_ids(offsets, csc_src.numel())[:n_edges]
    src = csc_src[:n_edges].long()
    ok = dist[src] + w[:n_edges] == dist[seg]
    cand = torch.where(ok, src, INT32_MAX)
    best = torch.full((dist.numel(),), INT32_MAX, dtype=torch.int64,
                      device=dist.device)
    best.scatter_reduce_(0, seg, cand, "amin")
    valid = torch.isfinite(dist) & (dist > 0) & (best < INT32_MAX)
    return torch.where(valid, best, -1).int()


@_spanned
def sssp_predecessors(dist: torch.Tensor, offsets: torch.Tensor,
                      csc_src: torch.Tensor, w: torch.Tensor,
                      n_edges: int) -> torch.Tensor:
    """[Vp] int32: the smallest-id in-neighbour u over the real in-edges q
    (CSC slots below ``n_edges``) with f32(dist[u] + w[q]) == dist[v]; -1
    unless dist[v] is finite and above 0 and such an edge exists. ``dist``
    is [Vp] float32, ``offsets`` the CSC offsets, ``w`` [Ep] float32 in CSC
    order. Two device launches, as ``bfs_predecessors``: the first walk in
    ``launches``, the range walk in ``pass_launches``."""
    name = "sssp_predecessors"
    vp, ep = offsets.numel() - 1, csc_src.numel()
    throw_if(dist.dtype != torch.float32 or dist.shape != (vp,),
             f"{name}: dist must be [Vp] float32")
    _check_weights(name, ep, w)
    _check_graph(name, ep, offsets, csc_src)
    throw_if(not 0 <= n_edges <= ep, f"{name}: n_edges out of range")
    if not _route(name, dist):
        return sssp_predecessors_plain(dist, offsets, csc_src, w, n_edges)
    return _predecessors("etpu_sssp_predecessors", name, dist, offsets,
                         csc_src, n_edges, w)


def kcore_wave_words(vp: int, ep: int) -> int:
    """The int32 words of the k-core waves' scratch: 8 scalar words
    (peeled, candidates listed, ranges listed, k, then the card's own) and
    room for every listed range (int4)."""
    return 8 + 4 * push_ranges(vp, ep)


def kcore_wave_scratch(vp: int, ep: int, device) -> torch.Tensor:
    """The k-core waves' scratch (``kcore_wave_words``), kept across the
    waves of a run."""
    return torch.empty(kcore_wave_words(vp, ep), dtype=torch.int32,
                       device=device)


def _kcore_peel_plain(deg, core, offsets, csc_src, peel, k: int, cand_out,
                      scratch):
    """The plain waves' common part: the vertices of ``peel`` ([Vp] bool)
    marked peeled at k, every survivor's degree lowered by its peeled
    in-neighbours (the pull over ``csc_src``), the alive vertices left
    below k written to ``cand_out`` in vertex order, and the kernel's four
    scalar words written to ``scratch``."""
    nonempty, starts, d = _start_values(deg, offsets, -1)
    survivor = nonempty & (d >= 0) & ~peel
    cnt = torch.zeros_like(d).index_add_(
        0, _segment_ids(offsets, csc_src.numel()),
        peel.int()[csc_src.long()])
    d2 = d - cnt
    deg[starts[peel]] = -1
    core[starts[peel]] = k - 1
    deg[starts[survivor]] = d2[survivor]
    cand = torch.nonzero(survivor & (d2 < k)).flatten().int()
    cand_out[:cand.numel()] = cand
    lengths = torch.where(peel, offsets[1:] - offsets[:-1], 0)
    ranges = int(((lengths + PUSH_SPLIT - 1) // PUSH_SPLIT).sum())
    scratch[:4] = torch.tensor([int(peel.sum()), cand.numel(), ranges, k],
                               dtype=torch.int32, device=scratch.device)
    return scratch[:4]


def kcore_level_wave_plain(deg, core, offsets, csc_src, col, cand_out,
                           scratch):
    """Plain version of ``kcore_level_wave`` (same contract, same writes;
    the candidates in vertex order): the pull over ``csc_src``; ``col`` is
    only the kernel's."""
    nonempty, _, d = _start_values(deg, offsets, -1)
    alive = nonempty & (d >= 0)
    least = int(torch.where(alive, d, INT32_MAX).min()) if d.numel() \
        else INT32_MAX
    k = INT32_MAX if least == INT32_MAX else least + 1
    return _kcore_peel_plain(deg, core, offsets, csc_src, alive & (d < k), k,
                             cand_out, scratch)


def kcore_cascade_wave_plain(deg, core, offsets, csc_src, col, k: int,
                             cand_in, n_in: int, cand_out, scratch):
    """Plain version of ``kcore_cascade_wave`` (same contract, same
    writes; the candidates in vertex order)."""
    peel = torch.zeros(offsets.numel() - 1, dtype=torch.bool,
                       device=deg.device)
    peel[cand_in[:n_in].long()] = True
    return _kcore_peel_plain(deg, core, offsets, csc_src, peel, k, cand_out,
                             scratch)


def _check_kcore_wave(name: str, deg, core, offsets, csc_src, col,
                      scratch, **lists) -> bool:
    """The waves' checks; True for the kernel, False for the plain
    version."""
    ep, vp = csc_src.numel(), offsets.numel() - 1
    _check_state(name, ep, deg=deg, core=core)
    _check_graph(name, ep, offsets, csc_src)
    _check_graph(name, ep, offsets, col, "col")
    for arg, t in lists.items():
        throw_if(t.dtype != torch.int32 or t.shape != (vp,),
                 f"{name}: {arg} must be [Vp] = [{vp}] int32")
    need = kcore_wave_words(vp, ep)
    throw_if(scratch.dtype != torch.int32 or scratch.dim() != 1
             or scratch.numel() < need,
             f"{name}: scratch must be int32 of at least {need} words "
             f"(kcore_wave_words)")
    kernel = _route(name, deg)
    _check_disjoint(name, deg=deg, core=core, scratch=scratch, **lists)
    if kernel:
        _check(name, deg.device, deg=deg, core=core, offsets=offsets,
               col=col, scratch=scratch, **lists)
    return kernel


@_spanned
def kcore_level_wave(deg: torch.Tensor, core: torch.Tensor,
                     offsets: torch.Tensor, csc_src: torch.Tensor,
                     col: torch.Tensor, cand_out: torch.Tensor,
                     scratch: torch.Tensor) -> torch.Tensor:
    """The first k-core peel wave at a new level, in place, on the edge
    axis of a symmetric-layout graph.

    ``deg`` and ``core`` ([Ep] int32, distinct buffers) hold each segment's
    remaining degree (-1 once peeled) and core number at its start. The
    wave finds k = the smallest alive degree + 1 (INT32_MAX when nothing
    is alive); each vertex v with a non-empty segment and 0 <= deg < k is
    peeled (deg -1, core k - 1), and each alive survivor's degree falls by
    its in-neighbours peeled. No other position of the state is written.
    ``cand_out`` ([Vp] int32) receives the survivors whose degree fell
    below k, each once, in any order: the next wave's peel set (the kernel
    leaves its block minima in the words after them). Returns the
    first four words of ``scratch`` (``kcore_wave_scratch``), int32 on the
    state's device: (vertices peeled, candidates listed, ranges listed, k);
    ``kcore_wave_read`` reads them.

    The plain version pulls over ``csc_src`` ([Ep] int32, the source of
    each CSC slot). The kernel pushes: each peeled vertex u takes one from
    the degree of every alive out-neighbour, ``col`` ([Ep] int32, the CSR
    column indices) over u's row. On a symmetric layout u's row sits at
    the positions of its segment, and the vertices it reaches are those
    whose pull counts it, directed or not. Three device launches: the
    minimum, counted in ``launches``, then the peel and the push, in
    ``pass_launches``."""
    name = "kcore_level_wave"
    if not _check_kcore_wave(name, deg, core, offsets, csc_src, col, scratch,
                             cand_out=cand_out):
        return kcore_level_wave_plain(deg, core, offsets, csc_src, col,
                                      cand_out, scratch)
    _launch("etpu_kcore_level_wave", deg.device, deg.data_ptr(),
            core.data_ptr(), offsets.data_ptr(), col.data_ptr(),
            offsets.numel() - 1, cand_out.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    pass_launches["kcore_level_peel"] += 1
    pass_launches["kcore_wave_push"] += 1
    return scratch[:4]


@_spanned
def kcore_cascade_wave(deg: torch.Tensor, core: torch.Tensor,
                       offsets: torch.Tensor, csc_src: torch.Tensor,
                       col: torch.Tensor, k: int, cand_in: torch.Tensor,
                       n_in: int, cand_out: torch.Tensor,
                       scratch: torch.Tensor) -> torch.Tensor:
    """A k-core peel wave at level ``k`` from a candidate list, in place:
    the ``n_in`` (>= 1) vertices of ``cand_in`` ([Vp] int32), which the
    caller holds to be alive with degree below k (the list the wave before
    gave), are peeled (deg -1, core k - 1), and the rest is
    ``kcore_level_wave``'s: the survivors' degrees fall, ``cand_out`` lists
    those that fell below k, and the first four words of ``scratch`` are
    returned (peeled, candidates listed, ranges listed, k). Two device
    launches: the mark, counted in ``launches``, and the push, in
    ``pass_launches``."""
    name = "kcore_cascade_wave"
    throw_if(not 1 <= k <= INT32_MAX, f"{name}: k out of range")
    throw_if(not 1 <= n_in <= offsets.numel() - 1,
             f"{name}: n_in out of range")
    if not _check_kcore_wave(name, deg, core, offsets, csc_src, col, scratch,
                             cand_in=cand_in, cand_out=cand_out):
        return kcore_cascade_wave_plain(deg, core, offsets, csc_src, col, k,
                                        cand_in, n_in, cand_out, scratch)
    _launch("etpu_kcore_cascade_wave", deg.device, deg.data_ptr(),
            core.data_ptr(), offsets.data_ptr(), col.data_ptr(),
            offsets.numel() - 1, k, cand_in.data_ptr(), n_in,
            cand_out.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    pass_launches["kcore_wave_push"] += 1
    return scratch[:4]


def kcore_wave_read(scalars: torch.Tensor) -> list:
    """A wave's four scalars (peeled, candidates listed, ranges listed, k)
    read to the host: the wave's one wait on the device. On the kernel's
    route one copy into pinned memory (``_read_scalars``)."""
    if not _route("kcore_level_wave", scalars):
        return scalars.tolist()
    return _read_scalars(scalars, 4)[:4]


def collapse_starts_plain(exp, offsets, empty: int, source: int = -1):
    """Plain version of ``collapse_starts``."""
    out = _start_values(exp, offsets, empty)[2]
    if source >= 0:
        out[source] = 0
    return out


@_spanned
def collapse_starts(exp: torch.Tensor, offsets: torch.Tensor, empty: int,
                    source: int = -1) -> torch.Tensor:
    """Edge-axis state -> [Vp] int32: the value at each non-empty segment's
    start, ``empty`` at empty segments, and 0 at ``source`` unless it is
    -1."""
    name = "collapse_starts"
    _check_graph(name, exp.numel(), offsets)
    _check_state(name, exp.numel(), exp=exp)
    vp = offsets.numel() - 1
    throw_if(not -1 <= source < vp, f"{name}: source {source} out of range")
    if not _route(name, exp):
        return collapse_starts_plain(exp, offsets, empty, source)
    _check(name, exp.device, exp=exp, offsets=offsets)
    out = torch.empty(vp, dtype=torch.int32, device=exp.device)
    if vp == 0:
        return out
    _launch("etpu_collapse_starts", exp.device, exp.data_ptr(),
            offsets.data_ptr(), vp, empty, source, out.data_ptr())
    launches[name] += 1
    return out


def expand_segments_plain(vals, offsets, n: int):
    """Plain version of ``expand_segments``."""
    return vals[_segment_ids(offsets, n)]


@_spanned
def expand_segments(vals: torch.Tensor, offsets: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Per-vertex values -> [n] int32 on the edge axis: every position of
    segment v, [offsets[v], offsets[v+1]), holds ``vals[v]`` ([Vp] int32).
    The segments must cover [0, n): offsets[-1] == n."""
    name = "expand_segments"
    _check_graph(name, n, offsets)
    vp = offsets.numel() - 1
    throw_if(vals.dtype != torch.int32 or vals.shape != (vp,),
             f"{name}: vals must be [Vp] = [{vp}] int32")
    kernel = _route(name, vals)
    # the tiles' places (segment ends and slots) are int32 on the card
    throw_if(not 0 <= n <= INT32_MAX - EXPAND_TILE - vp
             or int(offsets[-1]) != n,
             f"{name}: the segments must cover [0, n), n = {n}")
    if not kernel:
        return expand_segments_plain(vals, offsets, n)
    _check(name, vals.device, vals=vals, offsets=offsets)
    out = torch.empty(n, dtype=torch.int32, device=vals.device)
    if n == 0:
        return out
    _launch("etpu_expand_segments", vals.device, vals.data_ptr(),
            offsets.data_ptr(), vp, n, out.data_ptr())
    launches[name] += 1
    return out
