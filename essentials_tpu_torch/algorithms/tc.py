"""Triangle counting.

Counterpart of ``essentials_tpu/algorithms/tc.py`` (reference parity:
gunrock::tc, ``tc.hxx:75-127``, whose hot path is the per-edge sorted
intersection of ``graph/csr.hxx:110-167``). Edges are oriented from lower
to higher (degree, id), and every triangle is counted once at its oriented
edges. Four variants, each giving the JAX package's total and per-vertex
counts (``shift`` gives the total only):

* ``dense`` (V <= 8192): three float32 products over the oriented 0/1
  adjacency on ``torch.matmul`` (the JAX package leaves its ``lax.dot`` to
  XLA too). Exact: the inputs are 0/1 and every sum is at most 8192 < 2^24.
  Products are cast to int32 before any sum and the total is summed in
  int64. No float16/bfloat16 product, which may reduce at lower precision.
* ``bitmap``: the oriented out-neighbourhoods packed on the host into bit
  rows, copied once, then one ``bitmap_intersect_counts`` launch over all
  oriented edges with the witness histogram; the u-role and v-role counts
  are added on the device with ``index_add_``.
* ``sorted``: wedges expanded on the host in chunks; each chunk's
  (k1, k2, tag) records are sorted on the device by one packed int64 key
  (``torch.sort``, as JAX's ``lax.sort`` is outside Pallas) and a "first"
  fill on the ``scan`` kernel marks the wedges closed by an edge. Records
  with equal keys may come out in any order: the result does not depend
  on it.
* ``shift``: the within-row neighbour pairs enumerated as lane shifts over
  the degree-descending edge axis, each chunk one ``torch.sort`` of the
  packed key (c1 << 31) | (c2 << 1 | tag) and a running max on the ``scan``
  kernel (JAX's ``lax.cummax``; ``torch.cummax`` took 491 of the 554 ms of
  device time of a run at gen:rmat17x16 on the H100); the chunk counts are
  summed on the device and read once.

``auto`` follows the device: on CUDA it takes JAX's accelerator branch
(``dense`` up to 8192 vertices, then ``bitmap`` while (V+1) * ceil(V/32) * 4
bytes <= 4 GiB, else ``shift``); on the CPU JAX's other branch (``dense``,
else ``sorted``).

The JAX package caches the packed bitmap and the shift plan keyed by
``id(csr)``, which can serve a stale graph when an id is recycled (ROADMAP.md
queue 3). This package keeps no cache: every run packs and copies anew, and
``elapsed_ms`` covers the device work after the copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.csr import Csr
from essentials_tpu_torch.ops.bitmap_intersect import (
    bitmap_intersect_counts, pack_bitmap_rows, unpack_witness_counts)
from essentials_tpu_torch.ops.scan_kernels import segmented_scan
from essentials_tpu_torch.utils.timer import Timer

VARIANTS = ("dense", "bitmap", "sorted", "shift")
_DENSE_MAX_V = 8192
# bitmap path memory cap: (V+1) * V/8 bytes of device memory for the rows
_BITMAP_MAX_BYTES = 4 << 30
_WEDGE_CHUNK = 1 << 24          # wedges per device sort (sorted)
_SHIFT_CHUNK = 1 << 28          # slots per device sort (shift)
_NO_KEY = torch.iinfo(torch.int64).max   # an invalid shift slot's key


class TcResult(NamedTuple):
    total: int
    vertex_triangles: torch.Tensor   # [V] int32 (zeros from ``shift``)
    elapsed_ms: float


def _oriented_csr(csr: Csr):
    """Host: degree-oriented CSR (edge kept from lower to higher
    (degree, id)) with sorted rows. Degree orientation bounds each
    oriented out-degree by ~sqrt(2E), keeping wedge rows short on
    hub-heavy graphs (id orientation leaves hub rows of size ~V)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    deg_all = np.diff(off).astype(np.int64)
    rank = deg_all * (n + 1) + np.arange(n)     # total order (degree, id)
    src = np.repeat(np.arange(n), deg_all)
    keep = rank[src] < rank[cols]
    s, c = src[keep], cols[keep]
    order = np.lexsort((c, s))
    s, c = s[order], c[order]
    deg = np.bincount(s, minlength=n)
    noff = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=noff[1:])
    return noff, s, c


def _nothing(n: int, device) -> TcResult:
    return TcResult(0, torch.zeros(n, dtype=torch.int32, device=device), 0.0)


def _timed(fn, device, warmup: bool):
    """(fn(), its ms on the device's clock), after one untimed call when
    ``warmup``."""
    if warmup:
        fn()
    t = Timer(device).begin()
    out = fn()
    return out, t.end()


# ------------------------------------------------------------------ dense --

def _dense_counts(a: torch.Tensor) -> tuple:
    """Triangle (a<b<c) algebra over the oriented adjacency ``a``
    (float32 0/1): (A@A)[a,c] sums over the MIDDLE vertex b, so M =
    (A@A)*A holds the per-(a,c)-edge triangle count; rowsum = smallest
    role, colsum = largest, and the middle role is rowsum(A^T * (A@A^T)).
    Returns (total int64, per-vertex counts int64)."""
    m = ((a @ a) * a).int()
    total = m.sum(dtype=torch.int64)
    lo_role = m.sum(1, dtype=torch.int64)
    hi_role = m.sum(0, dtype=torch.int64)
    mid_role = (a.T * (a @ a.T)).int().sum(1, dtype=torch.int64)
    return total, lo_role + hi_role + mid_role


def _run_dense(csr: Csr, device, warmup: bool) -> TcResult:
    n = csr.n_rows
    _, es, ec = _oriented_csr(csr)
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    a[torch.from_numpy(es).to(device), torch.from_numpy(ec).long().to(
        device)] = 1.0
    (total, vt), ms = _timed(lambda: _dense_counts(a), device, warmup)
    return TcResult(int(total), vt.int(), ms)


# ----------------------------------------------------------------- bitmap --

def _run_bitmap(csr: Csr, device, warmup: bool) -> TcResult:
    """Per-edge bitmap AND: |N+(u) ∩ N+(v)| for every oriented edge (the
    v role, u role and count), the witness histogram giving each
    triangle's third vertex (reference hot path: graph/csr.hxx:110-167)."""
    n = csr.n_rows
    _, es, ec = _oriented_csr(csr)
    if es.shape[0] == 0:
        return _nothing(n, device)
    bitmap = torch.from_numpy(pack_bitmap_rows(n, es, ec)).to(device)
    eu = torch.from_numpy(es.astype(np.int32)).to(device)
    ev = torch.from_numpy(ec.astype(np.int32)).to(device)
    (cnt, wit), ms = _timed(lambda: bitmap_intersect_counts(eu, ev, bitmap),
                            device, warmup)
    vt = unpack_witness_counts(wit, n)
    c = cnt.long()
    vt.index_add_(0, eu.long(), c)                 # u-role
    vt.index_add_(0, ev.long(), c)                 # v-role
    return TcResult(int(c.sum()), vt.int(), ms)


# ----------------------------------------------------------------- sorted --

def _edge_keys(es: np.ndarray, ec: np.ndarray, device) -> torch.Tensor:
    """The oriented edges' records as packed keys (k1 << 31) | (k2 << 1),
    tag 0: edges sort before wedges of the same (k1, k2)."""
    return torch.from_numpy((es.astype(np.int64) << 31)
                            | (ec.astype(np.int64) << 1)).to(device)


def _wedges_found(keys: torch.Tensor, ne: int) -> torch.Tensor:
    """Sort the records (``ne`` edges first, then wedges) and return, per
    wedge in input order, whether its (k1, k2) segment opens with an edge
    (a "first" fill of that flag over each key segment)."""
    sk, pos = torch.sort(keys)
    pair = sk >> 1
    new_seg = torch.ones_like(sk, dtype=torch.bool)
    new_seg[1:] = pair[1:] != pair[:-1]
    edge = (sk & 1) == 0
    ff = segmented_scan((new_seg & edge).int(), new_seg, "first")
    found = torch.zeros_like(new_seg)
    found[pos] = (ff > 0) & ~edge
    return found[ne:]


def wedge_bounds(w_per_edge: np.ndarray) -> list:
    """Edge-list bounds of the ``sorted`` path's chunks (one sort and one
    ``scan`` each): each chunk's wedge expansion stays near _WEDGE_CHUNK
    (host memory and device sort size)."""
    wc = np.concatenate([[0], np.cumsum(w_per_edge)])
    bounds = [0]
    while bounds[-1] < w_per_edge.shape[0]:
        nxt = int(np.searchsorted(wc, wc[bounds[-1]] + _WEDGE_CHUNK,
                                  side="right")) - 1
        bounds.append(max(nxt, bounds[-1] + 1))
    return bounds


def _run_sorted(csr: Csr, device, warmup: bool) -> TcResult:
    n = csr.n_rows
    noff, es, ec = _oriented_csr(csr)
    deg_plus = np.diff(noff)
    ne = es.shape[0]
    w_per_edge = deg_plus[es].astype(np.int64)
    if int(w_per_edge.sum()) == 0:
        return _nothing(n, device)

    wc = np.concatenate([[0], np.cumsum(w_per_edge)])
    bounds = wedge_bounds(w_per_edge)
    edge_keys = _edge_keys(es, ec, device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    vt = torch.zeros(n, dtype=torch.int64, device=device)
    ms = 0.0
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        wpe = w_per_edge[lo:hi]
        n_w = int(wpe.sum())
        wedge_eid = np.repeat(np.arange(lo, hi), wpe)
        base = noff[es[wedge_eid]] + (
            np.arange(n_w) - np.repeat(wc[lo:hi] - wc[lo], wpe))
        wedge_c = ec[base]                              # candidate witness
        wedge_v = ec[wedge_eid]                         # test (v, c) edge
        keys = torch.cat([edge_keys, torch.from_numpy(
            (wedge_v.astype(np.int64) << 31)
            | (wedge_c.astype(np.int64) << 1) | 1).to(device)])
        hit, t = _timed(lambda: _wedges_found(keys, ne), device,
                        warmup and i == 0)
        ms += t
        total += hit.sum()
        ones = hit.long()
        for role in (es[wedge_eid], wedge_v, wedge_c):
            vt.index_add_(0, torch.from_numpy(role).long().to(device), ones)
    return TcResult(int(total), vt.int(), ms)


# ------------------------------------------------------------------ shift --
#
# The bitmap path's traffic is O(E * V). This path relabels vertices by
# orientation rank (so oriented edges are (lo -> hi) in new ids and
# neighbourhoods sort ascending), orders rows by out-degree DESCENDING, and
# enumerates every within-row neighbour pair as a lane shift:
#
#   pass s: candidate pairs (wec[p], wec[p+s]) for p in [0, B_s)
#           (B_s = total degree of rows with degree > s, a PREFIX of the
#           edge axis thanks to the degree-descending row order)
#
# Each unordered pair {i < j} of a row appears in exactly one pass (s = j -
# i), so the candidates are exactly the wedges. Membership of (c1, c2) in
# the oriented edge set is a sort-join over one int64 key per record.

def shift_chunks(out_degrees: np.ndarray) -> list:
    """The shift path's chunk plan from the oriented out-degrees: greedy
    groups of passes (s, B_s) of at most _SHIFT_CHUNK slots, one sort and
    one ``scan`` each. B_s, the total degree of the rows of degree > s, is
    a prefix of the degree-descending edge axis."""
    dsorted = np.sort(np.asarray(out_degrees, np.int64))[::-1]
    ends = np.cumsum(dsorted)
    passes = np.arange(1, max(int(dsorted[0]) if len(dsorted) else 0, 1))
    # B_s = ends[k - 1], k = the rows of degree > s (k >= 1 for s < maxd)
    k = len(dsorted) - np.searchsorted(dsorted[::-1], passes, side="right")
    sizes = ends[k - 1] if len(passes) else np.zeros(0, np.int64)
    chunks, cur, tot = [], [], 0
    for s, b in zip(passes.tolist(), sizes.tolist()):
        if cur and tot + b > _SHIFT_CHUNK:
            chunks.append(tuple(cur))
            cur, tot = [], 0
        cur.append((s, b))
        tot += b
    if cur:
        chunks.append(tuple(cur))
    return chunks


def _shift_prep(csr: Csr, device):
    """Host plan (a NumPy copy of the JAX package's, with the pass sizes
    from one searchsorted): (wec padded by maxd+1 zeros [int64], each
    slot's row end [int64], the edge keys, the chunks of passes)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    deg_all = np.diff(off).astype(np.int64)
    rank = deg_all * (n + 1) + np.arange(n)
    perm = np.argsort(rank, kind="stable")
    newid = np.empty(n, np.int64)
    newid[perm] = np.arange(n)
    src = np.repeat(np.arange(n), deg_all)
    s2, c2 = newid[src], newid[cols]
    keep = s2 < c2                       # orientation == new-id order
    es, ec = s2[keep], c2[keep]
    d = np.bincount(es, minlength=n).astype(np.int64)
    roworder = np.argsort(-d, kind="stable")
    rowpos = np.empty(n, np.int64)
    rowpos[roworder] = np.arange(n)
    order = np.lexsort((ec, rowpos[es]))
    wec = ec[order]                      # degree-desc rows, asc neighbours
    dsorted = d[roworder]
    pos_end = np.repeat(np.cumsum(dsorted), dsorted)
    maxd = int(dsorted[0]) if len(dsorted) else 0
    wec_pad = np.concatenate([wec, np.zeros(maxd + 1, np.int64)])
    return (torch.from_numpy(wec_pad).to(device),
            torch.from_numpy(pos_end).to(device),
            _edge_keys(es, ec, device), shift_chunks(d))


def _shift_runs(wec_pad, pos_end, edge_keys, parts) -> tuple:
    """The running-max input of the passes ``parts`` ((s, B_s) pairs): the
    sorted records of the edges and the passes' wedges, encoded as
    (run-start index << 1 | opens-with-edge) at each run of one pair and -1
    elsewhere (int32), and each record's tag (1: a wedge). Each pass's
    slots p in [0, B_s) pair wec[p] with wec[p+s] when p + s lies in p's
    row; invalid slots get a key that no edge has."""
    dev = wec_pad.device
    shifts = torch.tensor([s for s, _ in parts], device=dev)
    sizes = torch.tensor([b for _, b in parts], device=dev)
    slots = sum(b for _, b in parts)
    which = torch.repeat_interleave(torch.arange(len(parts), device=dev),
                                    sizes, output_size=slots)
    p = torch.arange(slots, device=dev) - (torch.cumsum(sizes, 0)
                                           - sizes)[which]
    q = p + shifts[which]
    del which
    keys = torch.where(q < pos_end[p],
                       (wec_pad[p] << 31) | (wec_pad[q] << 1) | 1, _NO_KEY)
    del p, q
    sk = torch.sort(torch.cat([edge_keys, keys])).values
    del keys
    n = sk.numel()
    throw_if(n >= 2**30, "tc shift: a chunk's records must stay below 2^30")
    # a wedge (tag 1) closes a triangle iff its pair's run opens with the
    # edge record: encode (run-start index << 1 | opens-with-edge), -1
    # elsewhere, in int32; a running max carries the nearest run start's flag
    pair = sk >> 1
    tag = (sk & 1).int()
    del sk
    run_start = torch.ones(n, dtype=torch.bool, device=dev)
    run_start[1:] = pair[1:] != pair[:-1]
    del pair
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    enc = torch.where(run_start, (idx << 1) | (1 - tag), -1)
    return enc, tag


def _shift_chunk_count(wec_pad, pos_end, edge_keys, parts) -> torch.Tensor:
    """The wedges of the passes ``parts`` that close a triangle, as an int64
    device scalar: a running max over ``_shift_runs``' encoding carries the
    nearest run start's flag to each wedge."""
    enc, tag = _shift_runs(wec_pad, pos_end, edge_keys, parts)
    m = kernels.scan(enc, None, "max")
    return ((tag == 1) & ((m & 1) == 1)).sum()


def _run_shift(csr: Csr, device, warmup: bool) -> TcResult:
    """Exact TOTAL triangle count at any V (vertex_triangles are zeros on
    this path; use 'bitmap', 'dense' or 'sorted' for per-vertex counts)."""
    wec_pad, pos_end, edge_keys, chunks = _shift_prep(csr, device)
    if not chunks:
        return _nothing(csr.n_rows, device)

    def count():
        total = torch.zeros((), dtype=torch.int64, device=device)
        for parts in chunks:
            total += _shift_chunk_count(wec_pad, pos_end, edge_keys, parts)
        return int(total)                 # the one read of the run
    total, ms = _timed(count, device, warmup)
    return TcResult(total, torch.zeros(csr.n_rows, dtype=torch.int32,
                                       device=device), ms)


# ------------------------------------------------------------ references --

def cpu_reference_total(csr) -> int:
    """Host exact triangle total via scipy masked A^2 (row-blocked)."""
    import scipy.sparse as sp
    n = csr.n_rows
    _, es, ec = _oriented_csr(csr)
    a = sp.csr_matrix((np.ones(len(es), np.int64), (es, ec)), shape=(n, n))
    total = 0
    step = 1 << 16
    for lo in range(0, n, step):
        blk = a[lo:lo + step]
        total += int((blk @ a).multiply(blk).sum())
    return total


def cpu_reference(csr) -> tuple:
    """Host reference via set intersection (reference parity:
    examples/algorithms/tc/tc_cpu.hxx): (total, per-vertex counts int32)."""
    n = csr.n_rows
    noff, es, ec = _oriented_csr(csr)
    adj = [set(ec[noff[v]:noff[v + 1]].tolist()) for v in range(n)]
    total = 0
    vt = np.zeros(n, np.int64)
    for e in range(es.shape[0]):
        u, v = int(es[e]), int(ec[e])
        common = adj[u] & adj[v]
        total += len(common)
        for c in common:
            vt[u] += 1
            vt[v] += 1
            vt[c] += 1
    return total, vt.astype(np.int32)


def auto_variant(n: int, device: str | torch.device,
                 dense: bool | None = None) -> str:
    """The variant ``auto`` runs for ``n`` vertices on ``device``."""
    if dense if dense is not None else n <= _DENSE_MAX_V:
        return "dense"
    if torch.device(device).type != "cuda":
        return "sorted"
    return ("bitmap" if (n + 1) * (-(-n // 32)) * 4 <= _BITMAP_MAX_BYTES
            else "shift")


def run(csr: Csr, *, device: str | torch.device = "cuda", warmup: bool = True,
        dense: bool | None = None, variant: str | None = None) -> TcResult:
    """Count triangles of the undirected ``csr`` on ``device``. variant:
    None or 'auto' (by device, see the module docstring), 'dense',
    'bitmap', 'sorted' or 'shift'; ``dense`` forces (True) or skips
    (False) the dense path under auto."""
    dev = torch.device(device)
    if variant in (None, "auto"):
        variant = auto_variant(csr.n_rows, dev, dense)
    throw_if(variant not in VARIANTS, f"unknown tc variant {variant!r}")
    return {"dense": _run_dense, "bitmap": _run_bitmap,
            "sorted": _run_sorted, "shift": _run_shift}[variant](
                csr, dev, warmup)
