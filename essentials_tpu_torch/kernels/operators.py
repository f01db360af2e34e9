"""The kernels of ``csrc/operator_kernels.cu``: the operator layer's scans,
gathers, segment reductions and in-edge counts (advance, neighbor_reduce,
the spray tiers, coloring), and ``fused_route_or``, the scan's tiles with a
routed compare for ``ops/fused_bfs.py``'s five-pass superstep."""

from __future__ import annotations

import torch

from essentials_tpu_torch.errors import EssentialsError, throw_if

from ._lib import (INT32_MAX, Kernel, P, I, LL, F, _check, _check_flags,
                   _check_graph, _launch, _library, _route, _segment_ids,
                   _spanned, declare, launches, pass_launches)

__all__ = ["ADVANCE_CHUNK", "MINMAX_PAYLOADS", "MINMAX_TILE", "REDUCE_OPS",
           "REDUCE_TILE", "SCAN_GROUP", "SCAN_OPS", "SCAN_TILE",
           "advance_count", "advance_count_bitmap_bytes",
           "advance_count_plain", "advance_count_tier", "bitmap_words",
           "fused_route_or", "fused_route_or_plain", "gather_payloads",
           "gather_payloads_plain", "minmax_tiles", "reduce_identity", "scan",
           "scan_plain", "scan_scratch_words", "scan_tiles", "segment_minmax",
           "segment_minmax_plain", "segment_reduce", "segment_reduce_plain"]

ADVANCE_CHUNK = 16384          # CSC slots per advance_count chunk (kCountChunk)
SCAN_OPS = ("add", "min", "max", "first")          # codes 0-3 in the .cu
REDUCE_OPS = ("sum", "min", "max", "or", "and")    # codes 0-4 in the .cu
SCAN_TILE = 2048               # elements per scan tile (kScanTile)
SCAN_GROUP = 256               # scan tiles per group word (kScanGroup)
MINMAX_TILE = 2048             # merge places per segment_minmax tile (kMmTile)
REDUCE_TILE = 4096             # merge places per segment_reduce tile (kRdTile)
MINMAX_PAYLOADS = 8            # payloads per segment_minmax launch
# gather_payloads packs 2-4 payloads from PACK_MIN_SLOTS slots and from
# one slot per record of the shortest payload. Measured by chip_ab.py's
# sweep (uniform random indices, NVIDIA H100 80GB HBM3, 700 W): at
# L = 2^20 words packing breaks even at n = L/2 and is 16% (2 payloads)
# and 27% (4) faster at n = L, 43% and 65% at n = 16 L; below 2^18 slots
# the pack's own launch costs more than it saves.
PACK_MIN_SLOTS = 1 << 18

declare(
    "operator_kernels.cu",
    Kernel(launches={"scan": "scan_kernels.py:274"},
           entries={"etpu_scan_i32": (P, P, P, P, LL, I, P),
                    "etpu_scan_f32": (P, P, P, P, LL, I, P)},
           constants={"etpu_scan_tile": ("SCAN_TILE", SCAN_TILE),
                      "etpu_scan_group": ("SCAN_GROUP", SCAN_GROUP)}),
    Kernel(launches={"gather_payloads": "cube_router.py:385"},
           passes=("gather_payloads_pack_kernel",),
           entries={"etpu_gather_payloads": (P, LL, P, P, P, P, P, P, P, P, I,
                                             P, I, P)}),
    Kernel(launches={"segment_reduce": "segment.py:97"},
           passes=("segment_split_kernel",),
           entries={"etpu_segment_reduce_i32": (P, LL, P, I, I, I, P, P, P),
                    "etpu_segment_reduce_f32": (P, LL, P, I, I, F, P, P, P)},
           constants={"etpu_reduce_tile": ("REDUCE_TILE", REDUCE_TILE)}),
    Kernel(launches={"segment_minmax": "scan_kernels.py:224"},
           passes=("segment_split_kernel",),
           entries={"etpu_segment_minmax": (P, P, P, P, P, P, P, P, I, P, LL,
                                            P, I, P, P, P, P)},
           constants={"etpu_minmax_tile": ("MINMAX_TILE", MINMAX_TILE)}),
    Kernel(launches={"advance_count": "cube_router.py:754"},
           uncounted=("advance_count_pack_kernel",),
           entries={"etpu_advance_count": (P, P, P, I, I, P, I, P, P),
                    "etpu_advance_count_shared_bytes": ()},
           constants={"etpu_advance_count_chunk": ("ADVANCE_CHUNK",
                                                   ADVANCE_CHUNK)}),
    Kernel(launches={"fused_route_or": "fused_bfs.py:603"},
           entries={"etpu_route_or": (P, P, P, I, I, P, P, P)}))


def _wrap_i32(x64: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (torch.remainder(x64 + 2**31, 2**32) - 2**31).int()


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """[n] int64 keys that order as x does (int32, or float32 by its bits:
    negative floats have all but the sign bit flipped)."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
        x = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return x.long()


def _unordered(k: torch.Tensor, dtype) -> torch.Tensor:
    k = k.int()
    if dtype == torch.float32:
        return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)
    return k


def scan_plain(x, flags=None, op: str = "add"):
    """Plain version of ``scan``. A float ``add`` is summed in float64 and
    rounded once, so it differs from the kernel's float32 order within a
    tolerance; every other case is exact."""
    n = x.numel()
    if n == 0:
        return x.clone()
    dev = x.device
    start = (torch.zeros(n, dtype=torch.bool, device=dev) if flags is None
             else flags.bool().clone())
    start[0] = True
    pos = torch.arange(n, device=dev)
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    if op == "first":
        return x[first]
    if op == "add":
        wide = x.double() if x.dtype == torch.float32 else x.long()
        c = torch.cumsum(wide, 0)
        c = c - (c[first] - wide[first])
        return c.float() if x.dtype == torch.float32 else _wrap_i32(c)
    seg = torch.cumsum(start.long(), 0) - 1
    k = _ordered(x)
    # later segments carry larger keys, so a running max stays in its segment
    u = k + 2**31 if op == "max" else 2**31 - 1 - k
    m = torch.cummax(seg * 2**32 + u, 0).values - seg * 2**32
    return _unordered(m - 2**31 if op == "max" else 2**31 - 1 - m, x.dtype)


def scan_tiles(n: int) -> int:
    """Tiles of one ``scan`` launch over ``n`` elements, one block each."""
    return -(-n // SCAN_TILE)


def scan_scratch_words(n: int) -> int:
    """The 64-bit words of one ``scan`` launch's scratch over ``n``
    elements: the tiles' status words, the groups' (one per SCAN_GROUP
    tiles), then the 32-bit ticket."""
    g = scan_tiles(n)
    return g + -(-g // SCAN_GROUP) + 1


@_spanned
def scan(x: torch.Tensor, flags: torch.Tensor | None = None,
         op: str = "add") -> torch.Tensor:
    """Inclusive scan of a 1-D int32 (add wraps around) or float32 tensor
    under ``op`` (add, min, max, first), segmented where ``flags`` ([n] bool
    or uint8) marks segment starts; position 0 always starts one. A float
    add is deterministic: its order depends on n and the flags alone. One
    launch: each tile's carry comes from the aggregates its predecessors
    publish (a look-back)."""
    name = "scan"
    throw_if(op not in SCAN_OPS, f"{name}: op must be one of {SCAN_OPS}")
    throw_if(x.dtype not in (torch.int32, torch.float32) or x.dim() != 1,
             f"{name}: x must be 1-D int32 or float32")
    throw_if(flags is not None and (flags.dtype not in (torch.bool,
                                                        torch.uint8)
                                    or flags.shape != x.shape),
             f"{name}: flags must be [n] bool or uint8")
    if not _route(name, x):
        return scan_plain(x, flags, op)
    dev = x.device
    _check(name, dev, x=x, **({} if flags is None else {"flags": flags}))
    n = x.numel()
    out = torch.empty_like(x)
    scratch = torch.empty(scan_scratch_words(n), dtype=torch.int64,
                          device=dev)          # the C call zeroes it
    _launch("etpu_scan_f32" if x.dtype == torch.float32 else "etpu_scan_i32",
            dev, x.data_ptr(), None if flags is None else flags.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, SCAN_OPS.index(op))
    launches[name] += 1
    return out


def gather_packs(n: int, lengths) -> bool:
    """Whether ``gather_payloads`` packs payloads of these ``lengths`` before
    it gathers ``n`` slots: for 2-4 payloads when n >= PACK_MIN_SLOTS and
    n >= the shortest length, where the sectors it saves (NP - 1 per slot)
    outweigh the pack pass (a launch that streams the payloads once)."""
    return (len(lengths) >= 2 and n >= PACK_MIN_SLOTS
            and n >= min(lengths))


def gather_payloads_plain(idx, *payloads):
    """Plain version of ``gather_payloads``."""
    i = idx.long()
    return tuple(p[i] for p in payloads)


@_spanned
def gather_payloads(idx: torch.Tensor, *payloads: torch.Tensor) -> tuple:
    """out_k[p] = payloads[k][idx[p]] for 1-4 payloads of 32-bit elements
    (int32 or float32, moved as bits), through one [n] int32 index array
    whose entries must lie in every payload's range. Returns a tuple of [n]
    tensors of the payloads' dtypes. Where ``gather_packs`` says so, the
    payloads are first interleaved into records and one record is gathered
    per slot."""
    name = "gather_payloads"
    throw_if(not 1 <= len(payloads) <= 4, f"{name}: 1-4 payloads")
    throw_if(idx.dtype != torch.int32 or idx.dim() != 1,
             f"{name}: idx must be 1-D int32")
    for p in payloads:
        throw_if(p.dtype not in (torch.int32, torch.float32) or p.dim() != 1,
                 f"{name}: payloads must be 1-D int32 or float32")
    if not _route(name, idx):
        return gather_payloads_plain(idx, *payloads)
    dev = idx.device
    _check(name, dev, idx=idx, **{f"payload{k}": p
                                  for k, p in enumerate(payloads)})
    n = idx.numel()
    lengths = [p.numel() for p in payloads]
    pack = gather_packs(n, lengths)
    outs = tuple(torch.empty(n, dtype=p.dtype, device=dev) for p in payloads)
    ins = [p.data_ptr() for p in payloads] + [None] * (4 - len(payloads))
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    rec, length = None, 0
    if pack:
        length = min(lengths)
        rec = torch.empty(length * (2 if len(payloads) == 2 else 4),
                          dtype=torch.int32, device=dev)
        # the C call packs only where there is a slot and a record
        pass_launches["gather_payloads_pack"] += bool(n and length)
    _launch("etpu_gather_payloads", dev, idx.data_ptr(), n, *ins, *ptrs,
            len(payloads), None if rec is None else rec.data_ptr(), length)
    launches[name] += 1
    return outs


def reduce_identity(op: str, dtype):
    """The identity of ``op`` on ``dtype``: what an empty segment gets."""
    if op in ("sum", "or"):
        return 0
    if op == "and":
        return 1
    if dtype == torch.float32:
        return float("inf") if op == "min" else float("-inf")
    return INT32_MAX if op == "min" else -INT32_MAX - 1


def segment_reduce_plain(vals, offsets, op: str):
    """Plain version of ``segment_reduce`` (float sums in another order)."""
    s = offsets.numel() - 1
    lo = int(offsets[0])
    hi = int(offsets[-1])
    seg = _segment_ids(offsets - lo, hi - lo)
    v = vals[lo:hi]
    if op in ("or", "and"):
        hit = torch.zeros(s, dtype=torch.int64, device=vals.device)
        hit.index_add_(0, seg, (v != 0).long())
        if op == "or":
            return hit > 0
        return hit == (offsets[1:] - offsets[:-1]).long()
    if op == "sum" and vals.dtype == torch.int32:
        out = torch.zeros(s, dtype=torch.int64, device=vals.device)
        return _wrap_i32(out.index_add_(0, seg, v.long()))
    if op == "sum" and vals.dtype == torch.float32:
        # accumulated in float64 and rounded once: a sequential float32 sum
        # drifts with the segment's length
        out = torch.zeros(s, dtype=torch.float64, device=vals.device)
        return out.index_add_(0, seg, v.double()).float()
    if op == "sum":
        out = torch.zeros(s, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, seg, v)
    out = torch.full((s,), reduce_identity(op, vals.dtype), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, seg, v, "amin" if op == "min" else "amax")


@_spanned
def segment_reduce(vals: torch.Tensor, offsets: torch.Tensor,
                   op: str) -> torch.Tensor:
    """Per-segment ``op`` (sum, min, max, or, and) of ``vals`` ([n] int32,
    whose sum wraps around, or float32) over the sorted [S+1] int32
    ``offsets`` (within [0, n]; offsets[0] need not be 0), with the identity
    at empty segments. sum/min/max give ``vals``' dtype, or/and bool (each
    value read as a truth value). ``vals`` may be a view at any element
    offset. One C call: a launch finds the splits of the merged segment ends
    and slots into tiles of REDUCE_TILE places (counted in
    ``pass_launches``), a launch reduces the tiles; a segment across tiles
    is completed from the partials the tiles before it publish. A float sum
    is deterministic: its order depends on the offsets alone."""
    name = "segment_reduce"
    throw_if(op not in REDUCE_OPS, f"{name}: op must be one of {REDUCE_OPS}")
    throw_if(vals.dtype not in (torch.int32, torch.float32)
             or vals.dim() != 1, f"{name}: vals must be 1-D int32 or float32")
    throw_if(offsets.dtype != torch.int32 or offsets.dim() != 1
             or offsets.numel() < 1, f"{name}: offsets must be [S+1] int32")
    if not _route(name, vals):
        return segment_reduce_plain(vals, offsets, op)
    dev = vals.device
    _check(name, dev, vals=vals, offsets=offsets)
    s, n = offsets.numel() - 1, vals.numel()
    throw_if(s + n > INT32_MAX, f"{name}: S + n must stay below 2^31")
    out = torch.empty(s, dtype=torch.bool if op in ("or", "and")
                      else vals.dtype, device=dev)
    if s == 0:
        return out
    # the tiles' status words, the ticket, the splits (one more than the
    # tiles): 2 64-bit words a tile and two
    scratch = torch.empty(2 * -(-(s + n) // REDUCE_TILE) + 2,
                          dtype=torch.int64, device=dev)
    _launch("etpu_segment_reduce_f32" if vals.dtype == torch.float32
            else "etpu_segment_reduce_i32", dev, vals.data_ptr(), n,
            offsets.data_ptr(), s, REDUCE_OPS.index(op),
            reduce_identity(op, vals.dtype), out.data_ptr(),
            scratch.data_ptr())
    launches[name] += 1
    pass_launches["segment_split"] += 1
    return out


def segment_minmax_plain(payloads, active, offsets):
    """Plain version of ``segment_minmax``."""
    s = offsets.numel() - 1
    lo, hi = int(offsets[0]), int(offsets[-1])
    seg = _segment_ids(offsets - lo, hi - lo)
    act = active[lo:hi]
    x = torch.stack([p[lo:hi] for p in payloads])
    idx = seg.expand(len(payloads), -1)
    mx = torch.full((len(payloads), s), -INT32_MAX - 1, dtype=torch.int32,
                    device=active.device)
    mn = torch.full_like(mx, INT32_MAX)
    mx.scatter_reduce_(1, idx, torch.where(act, x, -INT32_MAX - 1), "amax")
    mn.scatter_reduce_(1, idx, torch.where(act, x, INT32_MAX), "amin")
    return mx, mn


def minmax_tiles(s: int, n: int) -> int:
    """segment_minmax's tiles over S segments and [n] payloads: the merged
    ends and slots, MINMAX_TILE places each (the offsets' span taken as n,
    its most)."""
    return -(-(s + n) // MINMAX_TILE)


@_spanned
def segment_minmax(payloads, active: torch.Tensor,
                   offsets: torch.Tensor) -> tuple:
    """Per segment s of the sorted [S+1] int32 ``offsets`` (within [0, n])
    and per [n] int32 payload k: the MAX and the MIN of payloads[k] over the
    positions of s where the [n] bool ``active`` is set, INT32_MIN and
    INT32_MAX where there is none. One C call per MINMAX_PAYLOADS payloads:
    a launch finds the splits of the merged segment ends and slots into
    tiles of MINMAX_TILE places (counted in ``pass_launches``), a launch
    reduces the tiles.
    Payloads and ``active`` may be views at any element offset. Returns
    (max [m, S], min [m, S]) int32, m = len(payloads)."""
    name = "segment_minmax"
    payloads = tuple(payloads)
    throw_if(not payloads, f"{name}: needs at least one payload")
    throw_if(active.dtype != torch.bool or active.dim() != 1,
             f"{name}: active must be [n] bool")
    n = active.numel()
    for p in payloads:
        throw_if(p.dtype != torch.int32 or p.shape != (n,),
                 f"{name}: payloads must be [n] = [{n}] int32")
    throw_if(offsets.dtype != torch.int32 or offsets.dim() != 1
             or offsets.numel() < 1, f"{name}: offsets must be [S+1] int32")
    if not _route(name, active):
        return segment_minmax_plain(payloads, active, offsets)
    dev = active.device
    _check(name, dev, active=active, offsets=offsets,
           **{f"payload{k}": p for k, p in enumerate(payloads)})
    s, m = offsets.numel() - 1, len(payloads)
    throw_if(s + n > INT32_MAX, f"{name}: S + n must stay below 2^31")
    mx = torch.empty((m, s), dtype=torch.int32, device=dev)
    mn = torch.empty_like(mx)
    if s == 0:
        return mx, mn
    # 16 partial words a tile, the ticket, the splits (one more than the
    # tiles): 17 64-bit words a tile and two; the launches reuse it in
    # stream order
    scratch = torch.empty(17 * minmax_tiles(s, n) + 2, dtype=torch.int64,
                          device=dev)
    for lo in range(0, m, MINMAX_PAYLOADS):
        chunk = payloads[lo:lo + MINMAX_PAYLOADS]
        ptrs = ([p.data_ptr() for p in chunk]
                + [None] * (MINMAX_PAYLOADS - len(chunk)))
        _launch("etpu_segment_minmax", dev, *ptrs, len(chunk),
                active.data_ptr(), n, offsets.data_ptr(), s,
                mx[lo].data_ptr(), mn[lo].data_ptr(), scratch.data_ptr())
        launches[name] += 1
        pass_launches["segment_split"] += 1
    return mx, mn


def advance_count_plain(frontier, offsets, csc_src):
    """Plain version of ``advance_count``."""
    cnt = torch.zeros(offsets.numel() - 1, dtype=torch.int32,
                      device=frontier.device)
    return cnt.index_add_(0, _segment_ids(offsets, csc_src.numel()),
                          frontier[csc_src.long()].int())


def bitmap_words(vp: int) -> int:
    """32-bit words of a packed [vp] bitmap in whole 16-byte words (the
    frontiers of ``advance_count`` and ``bfs_level``)."""
    return 4 * -(-vp // 128)


def advance_count_bitmap_bytes(vp: int) -> int:
    """Bytes of the packed frontier that ``advance_count`` (and
    ``bfs_level``'s pull) builds for a [vp] frontier: one bit per vertex, in
    whole 16-byte words."""
    return 4 * bitmap_words(vp)


_shared_bytes = {}


def advance_count_tier(vp: int, device, max_shared_bytes: int | None = None
                       ) -> str:
    """The tier ``advance_count`` runs for a [vp] frontier on the CUDA
    ``device``: "shared" where the packed frontier fits the block's shared
    memory (the opt-in limit less the kernel's static shared memory, about
    225 KiB on an H100, so up to about 1.8M vertices) and, when given,
    ``max_shared_bytes``; else "global"."""
    device = torch.device(device)
    if device not in _shared_bytes:
        with torch.cuda.device(device):
            _shared_bytes[device] = _library().etpu_advance_count_shared_bytes()
        throw_if(_shared_bytes[device] < 0, "advance_count: could not read "
                                            "the device's shared memory")
    cap = _shared_bytes[device]
    if max_shared_bytes is not None:
        cap = min(cap, max_shared_bytes)
    return "shared" if advance_count_bitmap_bytes(vp) <= cap else "global"


@_spanned
def advance_count(frontier: torch.Tensor, offsets: torch.Tensor,
                  csc_src: torch.Tensor,
                  max_shared_bytes: int | None = None) -> torch.Tensor:
    """[Vp] int32: for each destination v, the in-edges q in
    [offsets[v], offsets[v+1]) whose source csc_src[q] is set in the [Vp]
    bool ``frontier``. ``offsets`` are the CSC offsets, covering [0, Ep).

    On the card one call zeroes the counts, packs the frontier into bits
    and counts over chunks of ADVANCE_CHUNK slots. Two size tiers, chosen
    by ``advance_count_tier``: "shared" holds the packed frontier in each
    block's shared memory, "global" (a frontier too large for it, or
    larger than ``max_shared_bytes``) reads the packed bits from device
    memory. The result is the same in both."""
    name = "advance_count"
    vp = offsets.numel() - 1
    if frontier.dtype != torch.bool or frontier.shape != (vp,):
        raise EssentialsError(f"{name}: frontier must be [Vp] bool")
    _check_graph(name, csc_src.numel(), offsets, csc_src)
    if not _route(name, frontier):
        return advance_count_plain(frontier, offsets, csc_src)
    dev = frontier.device
    _check(name, dev, frontier=frontier, offsets=offsets, csc_src=csc_src)
    shared = advance_count_tier(vp, dev, max_shared_bytes) == "shared"
    # the packed bits (16-byte aligned at the start), each chunk's first
    # row, then the counts
    skip = (advance_count_bitmap_bytes(vp) // 4
            + -(-csc_src.numel() // ADVANCE_CHUNK) + 1)
    buf = torch.empty(skip + vp, dtype=torch.int32, device=dev)
    out = buf[skip:]
    _launch("etpu_advance_count", dev, frontier.data_ptr(),
            offsets.data_ptr(), csc_src.data_ptr(), vp, csc_src.numel(),
            buf.data_ptr(), int(shared), out.data_ptr())
    launches[name] += 1
    return out


def fused_route_or_plain(lev, edge_ids, start_flags, it: int):
    """Plain version of ``fused_route_or``."""
    n = lev.numel()
    pos = torch.arange(n, device=lev.device)
    start = start_flags.bool().clone()
    if n:
        start[0] = True
    hit = lev[edge_ids.long()] == it
    last_hit = torch.cummax(torch.where(hit, pos, -1), 0).values
    last_start = torch.cummax(torch.where(start, pos, 0), 0).values
    return (last_hit >= last_start).int()


@_spanned
def fused_route_or(lev: torch.Tensor, edge_ids: torch.Tensor,
                   start_flags: torch.Tensor, it: int) -> torch.Tensor:
    """[n] int32: y[q] = (lev[edge_ids[q]] == it), routed through the
    gather, then an inclusive segmented OR over ``start_flags`` (position 0
    always starts a segment). ``lev`` and ``edge_ids`` are [n] int32, the
    ids in [0, n). One launch: ``scan``'s tiles and look-back, the compare
    made as each tile loads."""
    name = "fused_route_or"
    throw_if(lev.dtype != torch.int32 or lev.dim() != 1,
             f"{name}: lev must be 1-D int32")
    n = lev.numel()
    throw_if(edge_ids.dtype != torch.int32 or edge_ids.shape != (n,),
             f"{name}: edge_ids must be [{n}] int32")
    _check_flags(name, start_flags, n)
    throw_if(not -INT32_MAX - 1 <= it <= INT32_MAX, f"{name}: it out of range")
    if not _route(name, lev):
        return fused_route_or_plain(lev, edge_ids, start_flags, it)
    dev = lev.device
    _check(name, dev, lev=lev, edge_ids=edge_ids, start_flags=start_flags)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(scan_scratch_words(n), dtype=torch.int64,
                          device=dev)          # the C call zeroes it
    _launch("etpu_route_or", dev, lev.data_ptr(), edge_ids.data_ptr(),
            start_flags.data_ptr(), n, it, out.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    return out
