"""SpGEMM: C = A @ B, both sparse CSR.

Counterpart of ``essentials_tpu/algorithms/spgemm.py`` (reference parity:
gunrock::spgemm, spgemm.hxx:116-240: Gustavson with an upper-bound nnz
pre-allocation on device, a numeric phase, then a fix-up compaction).

Two phases, as in the JAX package:

* SYMBOLIC (host, once per (A, B) *structure*): the Gustavson product
  expansion, one slot per (A(i,k), B(k,j)) pair, its (row, col) keys and
  C's sparsity pattern, all independent of the values. ``make_plan``
  keeps, for every product in (row, col) order, its A-edge id and its
  B-edge id, and C's offsets over the sorted products. The JAX package
  compiles the same moves into Beneš routes; a CUDA kernel gathers
  through the ids directly, so the plan holds no routes.
* NUMERIC (device, reusable across value sets): two ``gather_payloads``
  (A's and B's values into key order), one product, one ``segment_reduce``
  SUM over C's offsets.

The chunked path (``make_chunked_plan``, ``numeric_chunked``,
``run_chunked``) serves product counts beyond what a per-product plan can
hold: the host plan keeps only chunk boundaries, C's structure and a merge
map for (row, col) runs split across chunks, and each chunk expands, sorts
and sums its products on the device.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.coo import Coo
from essentials_tpu_torch.formats.csr import Csr
from essentials_tpu_torch.ops.segment import expand_vertex_to_edges, gather
from essentials_tpu_torch.utils.timer import Timer


class SpgemmResult(NamedTuple):
    c: Csr
    elapsed_ms: float


@dataclass(frozen=True)
class SpgemmPlan:
    """Structure-static Gustavson layout (reusable across value sets)."""
    n_products: int              # product slots
    c_nnz: int                   # unique (row, col) pairs in C
    a_edge: torch.Tensor         # int32 [n_products]: A edge, key order
    b_edge: torch.Tensor         # int32 [n_products]: B edge, key order
    c_offsets: torch.Tensor      # int32 [c_nnz + 1]: C's runs of products
    c_row_offsets: np.ndarray    # [n_rows + 1] int32: C's row offsets
    c_col_indices: np.ndarray    # [c_nnz] int32: C's column indices


def _empty(a: Csr, b: Csr) -> SpgemmResult:
    return SpgemmResult(Csr(a.n_rows, b.n_cols,
                            np.zeros(a.n_rows + 1, np.int32),
                            np.empty(0, np.int32),
                            np.empty(0, np.float32)), 0.0)


def _products(a: Csr, b: Csr) -> tuple:
    """(rows, cols, a_eid, b_eid) int64 of every product, in A-edge order
    and then B-edge order."""
    throw_if(a.n_cols != b.n_rows, "spgemm: inner dimensions disagree")
    a_off = np.asarray(a.row_offsets, np.int64)
    a_cols = np.asarray(a.col_indices, np.int64)
    b_off = np.asarray(b.row_offsets, np.int64)
    per_edge = np.diff(b_off)[a_cols]                 # products per A edge
    n_products = int(per_edge.sum())
    wc = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(per_edge, out=wc[1:])
    a_eid = np.repeat(np.arange(a.nnz, dtype=np.int64), per_edge)
    b_eid = b_off[a_cols[a_eid]] + (np.arange(n_products) - wc[a_eid])
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64),
                     np.diff(a_off))[a_eid]
    cols = np.asarray(b.col_indices, np.int64)[b_eid]
    return rows, cols, a_eid, b_eid


def _runs(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The starts of the runs of equal (row, col) in key order."""
    new = np.ones(rows.size, bool)
    new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    return np.nonzero(new)[0]


def _row_offsets(u_rows: np.ndarray, n_rows: int) -> np.ndarray:
    off = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(u_rows, minlength=n_rows), out=off[1:])
    return off


def make_plan(a: Csr, b: Csr, *,
              device: str | torch.device = "cuda") -> SpgemmPlan | None:
    """Symbolic phase on the host; the plan's ids on ``device``. Returns
    None for an empty product."""
    rows, cols, a_eid, b_eid = _products(a, b)
    if rows.size == 0:
        return None
    key_order = np.lexsort((cols, rows))              # stable: (row, col)
    sr, sc = rows[key_order], cols[key_order]
    starts = _runs(sr, sc)
    c_offsets = np.append(starts, rows.size).astype(np.int32)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)
    return SpgemmPlan(
        n_products=int(rows.size), c_nnz=int(starts.size),
        a_edge=dev(a_eid[key_order]), b_edge=dev(b_eid[key_order]),
        c_offsets=dev(c_offsets),
        c_row_offsets=_row_offsets(sr[starts], a.n_rows).astype(np.int32),
        c_col_indices=sc[starts].astype(np.int32))


def numeric(plan: SpgemmPlan, a_vals: torch.Tensor,
            b_vals: torch.Tensor) -> torch.Tensor:
    """Device numeric phase: float32 [c_nnz], C's values for the plan's
    structure. Three launches: two gathers, one segmented SUM."""
    av = gather(plan.a_edge, a_vals.float())[0]
    bv = gather(plan.b_edge, b_vals.float())[0]
    return kernels.segment_reduce(av * bv, plan.c_offsets, "sum")


def _values(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


def run(a: Csr, b: Csr, *, warmup: bool = True,
        plan: SpgemmPlan | None = None,
        device: str | torch.device = "cuda") -> SpgemmResult:
    """C = A @ B on ``device`` (the plan's device where a plan is given).
    ``elapsed_ms`` covers the numeric phase, on the device's clock (CUDA
    events) or the host's (CPU)."""
    if plan is None:
        plan = make_plan(a, b, device=device)
    if plan is None:                                  # empty product
        return _empty(a, b)
    dev = plan.a_edge.device
    av, bv = _values(a.values, dev), _values(b.values, dev)
    if warmup:
        numeric(plan, av, bv)
    t = Timer(dev).begin()
    vals = numeric(plan, av, bv)
    ms = t.end()
    return SpgemmResult(Csr(a.n_rows, b.n_cols, plan.c_row_offsets,
                            plan.c_col_indices, vals.cpu().numpy()), ms)


# ------------------------------------------------------------------ #
# chunked numeric phase: the product axis cut into chunks of at most
# ``chunk_products`` products and ``chunk_edges`` A edges, each cut
# snapped down to an A-row boundary where the chunk spans more than one
# row (a row with more products or edges than a chunk still splits). The
# host plan keeps no per-product data: per chunk its first A edge, first
# product, product count and base in the device layout (each chunk's
# sorted unique (row, col) keys, concatenated; int64 on the host), C's
# exact structure and a merge map for the (row, col) runs of rows split
# across chunks.
#
# On the device, consecutive chunks run together as one batch of at most
# ``Wc`` products: a batch's sort key is (piece, col), where a piece is
# one row's part in one chunk, so the batch gives exactly its chunks'
# layouts one after the other. Per batch: three expansions over the A
# edges (A's value, the piece, the B row start; ``expand_segments``), B's
# values and columns by one ``gather_payloads``, the key sort
# (``torch.sort``), the products moved into key order (``gather_payloads``),
# the runs' starts (a ``scan`` of the run flags, compacted by
# ``index_put_``), and their sums (``segment_reduce``).


@dataclass(frozen=True)
class ChunkedPlan:
    n_products: int
    Wc: int                     # product slots per chunk
    Ecap: int                   # A edges of the largest chunk
    chunks: tuple               # ((e0, p0, npc, c_base), ...)
    c_dev_total: int            # device-layout entries (pre-merge, w/ dups)
    merge_spans: np.ndarray     # [K, 3] (s, t, n_runs): junction spans
    merge_order: np.ndarray     # concatenated span-LOCAL stable argsorts
    merge_offsets: np.ndarray   # concatenated span-LOCAL run starts
    c_row_offsets: np.ndarray   # final C structure (post-merge)
    c_col_indices: np.ndarray


def _chunked_plan_cache_key(a: Csr, b: Csr, chunk_products, chunk_edges):
    """Content hash of the STRUCTURES (values don't matter)."""
    h = hashlib.sha256()
    for arr in (a.row_offsets, a.col_indices, b.row_offsets,
                b.col_indices):
        h.update(np.ascontiguousarray(np.asarray(arr, np.int64)).tobytes())
    h.update(np.int64([a.n_rows, a.n_cols, b.n_rows, b.n_cols,
                       chunk_products, chunk_edges]).tobytes())
    return h.hexdigest()[:24]


def make_chunked_plan(a: Csr, b: Csr, *, chunk_products: int = 1 << 26,
                      chunk_edges: int = 1 << 23,
                      cache_dir: str | None = None) -> ChunkedPlan | None:
    """Streamed symbolic phase on the host: chunk boundaries and C's exact
    structure in O(chunk) peak memory. Structure-static: pass
    ``cache_dir`` (or set ESSENTIALS_TPU_TORCH_PLAN_CACHE) to keep and
    reuse it as one .npz keyed by a hash of both sparsity patterns, under
    a file name of this package's own (never the JAX package's)."""
    cache_dir = cache_dir or os.environ.get("ESSENTIALS_TPU_TORCH_PLAN_CACHE")
    cpath = None
    if cache_dir:
        key = _chunked_plan_cache_key(a, b, chunk_products, chunk_edges)
        cpath = os.path.join(cache_dir, f"spgemm_chunked_torch_v1_{key}.npz")
        if os.path.exists(cpath):
            z = np.load(cpath)
            return ChunkedPlan(
                n_products=int(z["n_products"]), Wc=int(z["Wc"]),
                Ecap=int(z["Ecap"]),
                chunks=tuple(map(tuple, z["chunks"].tolist())),
                c_dev_total=int(z["c_dev_total"]),
                merge_spans=z["merge_spans"],
                merge_order=z["merge_order"],
                merge_offsets=z["merge_offsets"],
                c_row_offsets=z["c_row_offsets"],
                c_col_indices=z["c_col_indices"])
    plan = _make_chunked_plan_impl(a, b, chunk_products, chunk_edges)
    if plan is not None and cpath:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cpath + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, n_products=plan.n_products, Wc=plan.Wc,
                     Ecap=plan.Ecap,
                     chunks=np.asarray(plan.chunks, np.int64).reshape(-1, 4),
                     c_dev_total=plan.c_dev_total,
                     merge_spans=plan.merge_spans,
                     merge_order=plan.merge_order,
                     merge_offsets=plan.merge_offsets,
                     c_row_offsets=plan.c_row_offsets,
                     c_col_indices=plan.c_col_indices)
        os.replace(tmp, cpath)
    return plan


def _chunk_unique_host(wc, per_edge, a_src, a_cols, b_off, b_cols, e0, e1,
                       p0, npc):
    """Host per-chunk sorted-unique (row, col) keys (np.repeat of per-edge
    bases instead of product-sized gathers)."""
    pe = per_edge[e0:e1]
    k = np.arange(npc, dtype=np.int64)
    k -= np.repeat(wc[e0:e1] - p0, pe)            # in-edge position
    b_eid = np.repeat(b_off[a_cols[e0:e1]], pe)
    b_eid += k
    key = np.repeat(a_src[e0:e1].astype(np.uint64) << np.uint64(32), pe)
    key |= b_cols[b_eid].astype(np.uint64)
    key.sort()
    ukey = key[np.concatenate([[True], key[1:] != key[:-1]])]
    return ((ukey >> np.uint64(32)).astype(np.int64),
            (ukey & np.uint64(0xffffffff)).astype(np.int64))


def _make_chunked_plan_impl(a: Csr, b: Csr, chunk_products: int,
                            chunk_edges: int) -> ChunkedPlan | None:
    throw_if(a.n_cols != b.n_rows, "spgemm: inner dimensions disagree")
    a_cols = np.asarray(a.col_indices, np.int64)
    b_off = np.asarray(b.row_offsets, np.int64)
    b_cols = np.asarray(b.col_indices, np.int64)
    a_off = np.asarray(a.row_offsets, np.int64)
    a_src = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a_off))

    per_edge = np.diff(b_off)[a_cols]
    wc = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(per_edge, out=wc[1:])
    n_products = int(wc[-1])
    if n_products == 0:
        return None
    Wc = int(chunk_products)
    Ecap = int(min(chunk_edges, a.nnz))

    chunks = []
    rows_l, cols_l = [], []
    spans = []
    split_junctions = []          # chunk-list indices k where chunk k-1
    e0 = 0                        # and chunk k share a (split) row
    prev_cut_mid_row = False
    while e0 < a.nnz:
        p0 = int(wc[e0])
        # largest e1 with products <= Wc and edges <= Ecap ...
        e_hi = min(a.nnz, e0 + Ecap)
        e1 = int(np.searchsorted(wc, p0 + Wc, side="right")) - 1
        e1 = max(min(e1, e_hi), e0 + 1)      # always progress
        # ... snapped DOWN to an A-row boundary when possible, so
        # (row, col) duplicates never span chunks and the merge below is
        # (near-)identity. Rows with more than a chunk still split.
        r1 = int(np.searchsorted(a_off, e1, side="right")) - 1
        if a_off[r1] > e0:
            e1 = int(a_off[r1])
            cut_mid_row = e1 != int(a_off[int(np.searchsorted(
                a_off, e1, side="right")) - 1])
        else:
            cut_mid_row = e1 != a.nnz and e1 != int(a_off[r1])
        npc = int(wc[e1] - p0)
        throw_if(npc > Wc, "spgemm: single A edge exceeds chunk_products; "
                           "raise chunk_products")
        if npc > 0:
            ur, uc = _chunk_unique_host(wc, per_edge, a_src, a_cols, b_off,
                                        b_cols, e0, e1, p0, npc)
            rows_l.append(ur.astype(np.int32))
            cols_l.append(uc.astype(np.int32))
            if prev_cut_mid_row:
                split_junctions.append(len(chunks))
            chunks.append((e0, p0, npc, None))
            spans.append(e1 - e0)
            prev_cut_mid_row = cut_mid_row
        e0 = e1

    # each chunk's base in the device layout, int64 on the host
    c_base = 0
    for i in range(len(chunks)):
        e0_, p0_, npc_, _ = chunks[i]
        chunks[i] = (e0_, p0_, npc_, c_base)
        c_base += rows_l[i].shape[0]
    Ecap = max(spans) if spans else 1
    c_dev_total = int(c_base)

    # merge map: with row-aligned cuts the concatenated per-chunk unique
    # lists are already globally sorted and duplicate-free EXCEPT around
    # split-row junctions, where the shared row's column lists interleave:
    # per-junction local argsorts and runs
    starts = np.array([c[3] for c in chunks] + [c_dev_total], np.int64)
    intervals = []
    for k in split_junctions:
        rr = int(rows_l[k][0])               # the shared row id
        lo_k = k
        while lo_k > 0 and rows_l[lo_k - 1].size \
                and int(rows_l[lo_k - 1][-1]) == rr:
            lo_k -= 1
        s = int(starts[lo_k]) + int(np.searchsorted(rows_l[lo_k], rr,
                                                    side="left"))
        t = int(starts[k]) + int(np.searchsorted(rows_l[k], rr,
                                                 side="right"))
        intervals.append((s, t))
    # a row spanning 3+ chunks gives overlapping intervals: merge them
    merged_iv = []
    for s, t in sorted(intervals):
        if merged_iv and s <= merged_iv[-1][1]:
            merged_iv[-1] = [merged_iv[-1][0], max(merged_iv[-1][1], t)]
        else:
            merged_iv.append([s, t])

    # per-chunk row histograms over each chunk's own rows (sorted)
    row_counts = np.zeros(a.n_rows, np.int64)
    for ur in rows_l:
        row_counts[ur[0]:ur[-1] + 1] += np.bincount(ur - ur[0])

    dev_cols_all = np.concatenate(cols_l) if cols_l \
        else np.empty(0, np.int32)
    dev_rows_all = np.concatenate(rows_l) if merged_iv else None
    spans_meta, perms, local_offs, parts = [], [], [], []
    pos = 0
    for s, t in merged_iv:
        rr_s = dev_rows_all[s:t]
        cc_s = dev_cols_all[s:t]
        kk = (rr_s.astype(np.uint64) << np.uint64(32)) | \
            cc_s.astype(np.uint64)
        p = np.argsort(kk, kind="stable")
        ks = kk[p]
        keep = np.ones(t - s, bool)
        keep[1:] = ks[1:] != ks[:-1]
        runs = np.nonzero(keep)[0]
        spans_meta.append((s, t, runs.shape[0]))
        perms.append(p)
        local_offs.append(runs)
        # folded duplicates all belong to the span's shared rows
        dup_rows = rr_s[p][~keep]
        if dup_rows.size:
            row_counts -= np.bincount(dup_rows, minlength=a.n_rows)
        parts.append(dev_cols_all[pos:s])       # identity piece
        parts.append(cc_s[p][keep])             # folded span piece
        pos = t
    parts.append(dev_cols_all[pos:])
    u_cols = np.concatenate(parts).astype(np.int32)
    merge_spans = np.asarray(spans_meta, np.int64).reshape(-1, 3)
    merge_order = (np.concatenate(perms).astype(np.int64) if perms
                   else np.empty(0, np.int64))
    merge_offsets = (np.concatenate(local_offs).astype(np.int64)
                     if local_offs else np.empty(0, np.int64))
    c_row_off = np.zeros(a.n_rows + 1, np.int64)
    np.cumsum(row_counts, out=c_row_off[1:])
    if c_dev_total <= np.iinfo(np.int32).max:
        c_row_off = c_row_off.astype(np.int32)
    return ChunkedPlan(
        n_products=n_products, Wc=Wc, Ecap=Ecap, chunks=tuple(chunks),
        c_dev_total=c_dev_total, merge_spans=merge_spans,
        merge_order=merge_order, merge_offsets=merge_offsets,
        c_row_offsets=c_row_off, c_col_indices=u_cols)


def _apply_merge(plan: ChunkedPlan, out: np.ndarray) -> np.ndarray:
    """Fold duplicate (row, col) runs. With row-aligned cuts there are
    none and this is the identity; split-row junction spans get a local
    stable reorder and reduceat, everything else passes through."""
    if not plan.merge_spans.size:
        return out
    pieces = []
    pos = off = moff = 0
    for s, t, n_runs in plan.merge_spans:
        s, t, n_runs = int(s), int(t), int(n_runs)
        pieces.append(out[pos:s])
        seg = out[s:t][plan.merge_order[off:off + (t - s)]]
        pieces.append(np.add.reduceat(
            seg, plan.merge_offsets[moff:moff + n_runs]))
        off += t - s
        moff += n_runs
        pos = t
    pieces.append(out[pos:])
    return np.concatenate(pieces)


def device_batches(plan: ChunkedPlan) -> list:
    """The chunks' device batches: [(first chunk, last chunk + 1, products)],
    consecutive chunks of at most ``plan.Wc`` products together."""
    out, first, total = [], 0, 0
    for i, (_, _, npc, _) in enumerate(plan.chunks):
        if total and total + npc > plan.Wc:
            out.append((first, i, total))
            first, total = i, 0
        total += npc
    if plan.chunks:
        out.append((first, len(plan.chunks), total))
    return out


class _ChunkInputs(NamedTuple):
    """The A-edge arrays of every batch, on the device."""
    wc: torch.Tensor         # int64 [nnz + 1]: first product of each A edge
    a_bits: torch.Tensor     # int32 [nnz]: A's values as bits
    piece: torch.Tensor      # int32 [nnz]: (chunk, row) piece of each A edge
    b_start: torch.Tensor    # int64 [nnz]: B's row start at each A edge
    b_bits: torch.Tensor     # int32 [B nnz]: B's values as bits
    b_cols: torch.Tensor     # int32 [B nnz]


def _chunk_inputs(plan: ChunkedPlan, a: Csr, b: Csr, a_vals, b_vals,
                  device) -> _ChunkInputs:
    a_off = np.asarray(a.row_offsets, np.int64)
    a_cols = np.asarray(a.col_indices, np.int64)
    b_off = np.asarray(b.row_offsets, np.int64)
    wc = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(np.diff(b_off)[a_cols], out=wc[1:])
    # a piece starts at every row start and every chunk start
    first = np.zeros(a.nnz + 1, np.int32)
    first[a_off[:-1]] = 1
    first[[c[0] for c in plan.chunks]] = 1
    piece = np.cumsum(first[:a.nnz], dtype=np.int64).astype(np.int32)
    av = np.asarray(a.values if a_vals is None else a_vals, np.float32)
    bv = np.asarray(b.values if b_vals is None else b_vals, np.float32)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return _ChunkInputs(dev(wc), dev(av.view(np.int32)), dev(piece),
                        dev(b_off[a_cols]), dev(bv.view(np.int32)),
                        dev(np.asarray(b.col_indices, np.int32)))


def _batch_values(x: _ChunkInputs, e0: int, e1: int, npc: int,
                  cnt: int) -> torch.Tensor:
    """float32 [cnt]: one batch's device layout, the summed products of
    each (piece, col) run in key order, for A edges [e0, e1)."""
    dev = x.wc.device
    p0 = x.wc[e0]
    off = (x.wc[e0:e1 + 1] - p0).int()                  # [ne + 1], ends npc
    a_e = expand_vertex_to_edges(x.a_bits[e0:e1], off, npc)
    piece = expand_vertex_to_edges(x.piece[e0:e1], off, npc)
    # B edge of product s: its A edge's B row start + (s - its first product)
    base = (x.b_start[e0:e1] - (x.wc[e0:e1] - p0)).int()
    s = torch.arange(npc, dtype=torch.int32, device=dev)
    b_eid = expand_vertex_to_edges(base, off, npc) + s
    bv, col = gather(b_eid, x.b_bits, x.b_cols)
    prod = a_e.view(torch.float32) * bv.view(torch.float32)
    key, order = torch.sort((piece.long() << 32) | col.long(), stable=True)
    prod = gather(order.int(), prod)[0]
    flags = torch.ones(npc, dtype=torch.int32, device=dev)
    flags[1:] = (key[1:] != key[:-1]).int()
    run = kernels.scan(flags) - 1                       # run of each product
    # the runs' starts, compacted (the other products write a spare slot)
    starts = torch.empty(cnt + 1, dtype=torch.int32, device=dev)
    starts.index_put_((torch.where(flags != 0, run, cnt).long(),), s)
    starts[cnt] = npc
    return kernels.segment_reduce(prod, starts, "sum")


def numeric_chunked(plan: ChunkedPlan, a: Csr, b: Csr, a_vals=None,
                    b_vals=None, stream_to_host: bool | None = None, *,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Run every chunk on ``device``; returns C's final (merged) values.
    ``stream_to_host`` (default: when the device layout and a chunk would
    pass 2^29 values) fetches each batch's values to the host instead of
    holding the whole pre-merge C on the device."""
    x = _chunk_inputs(plan, a, b, a_vals, b_vals, device)
    if stream_to_host is None:
        stream_to_host = plan.c_dev_total + plan.Wc > (1 << 29)
    bases = [c[3] for c in plan.chunks] + [plan.c_dev_total]
    ends = [c[0] for c in plan.chunks[1:]] + [a.nnz]
    if stream_to_host:
        out = np.zeros(plan.c_dev_total, np.float32)
    else:
        cvals = torch.zeros(plan.c_dev_total, dtype=torch.float32,
                            device=device)
    for i, j, npc in device_batches(plan):
        e0, lo, hi = plan.chunks[i][0], bases[i], bases[j]
        vals = _batch_values(x, e0, ends[j - 1], npc, hi - lo)
        if stream_to_host:
            out[lo:hi] = vals.cpu().numpy()
        else:
            cvals[lo:hi] = vals
    if not stream_to_host:
        out = cvals.cpu().numpy()
    return _apply_merge(plan, out)


def run_chunked(a: Csr, b: Csr, *, chunk_products: int = 1 << 26,
                chunk_edges: int = 1 << 23, warmup: bool = True,
                plan: ChunkedPlan | None = None,
                device: str | torch.device = "cuda") -> SpgemmResult:
    """SpGEMM for product counts beyond the static plan's range.
    ``elapsed_ms`` covers the numeric phase and its host merge, on the
    host's clock."""
    if plan is None:
        plan = make_chunked_plan(a, b, chunk_products=chunk_products,
                                 chunk_edges=chunk_edges)
    if plan is None:
        return _empty(a, b)
    if warmup:
        numeric_chunked(plan, a, b, device=device)
    t0 = time.perf_counter()
    vals = numeric_chunked(plan, a, b, device=device)
    ms = (time.perf_counter() - t0) * 1e3
    return SpgemmResult(Csr(a.n_rows, b.n_cols,
                            np.asarray(plan.c_row_offsets),
                            np.asarray(plan.c_col_indices), vals), ms)


def cpu_reference(a: Csr, b: Csr) -> Csr:
    """Host Gustavson in float64, vectorised: every product, sorted by
    (row, col), summed per run with ``np.add.reduceat``. Like the JAX
    package's dict Gustavson it keeps every structural entry, also where
    values cancel. Returns float32 values."""
    rows, cols, a_eid, b_eid = _products(a, b)
    if rows.size == 0:
        return _empty(a, b).c
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    prod = (np.asarray(a.values, np.float64)[a_eid[order]]
            * np.asarray(b.values, np.float64)[b_eid[order]])
    starts = _runs(rows, cols)
    return Csr.from_coo(Coo(a.n_rows, b.n_cols,
                            rows[starts].astype(np.int32),
                            cols[starts].astype(np.int32),
                            np.add.reduceat(prod, starts).astype(
                                np.float32)))
