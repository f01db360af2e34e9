"""Generic neighbourhood-intersection operator.

Counterpart of ``essentials_tpu/ops/intersect.py`` (reference parity:
graph::get_intersection_count, gunrock ``graph/csr.hxx:110-167``). Arbitrary
vertex-pair queries run on the bitmap engine (``ops/bitmap_intersect.py``):

    intersection_counts(csr, u, v)  -> |N(u) ∩ N(v)| per pair
    jaccard(csr, u, v)              -> |∩| / |∪| per pair

``witnesses=True`` also returns, per vertex c, the number of queried pairs
whose intersection holds c (the reference's per-match callback as a
histogram).

Up to ``_DENSE_V_MAX`` vertices every row is packed ((V+1) * V/8 bytes on
the device); above, the chunked engine packs only the queried rows and
walks the column (witness) axis in vertex ranges of at most
``_CHUNK_BYTES`` of bitmap. The JAX package caches the all-rows bitmap
keyed by ``id(csr)``, which can serve a stale graph when an id is recycled
(ROADMAP.md queue 3); this package keeps no cache and packs at every call.

Results lie on the device the call names, else on the device of ``u`` when
it is a tensor, else on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from essentials_tpu_torch.formats.csr import Csr
from essentials_tpu_torch.ops.bitmap_intersect import (
    LANES, bitmap_intersect_counts, pack_bitmap_rows, unpack_witness_counts)

_DENSE_V_MAX = 1 << 17        # all-rows bitmap above this: 2 GB+
_CHUNK_BYTES = 1 << 30        # per-chunk bitmap budget for the chunked path


def _device(u, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return u.device if isinstance(u, torch.Tensor) else torch.device("cuda")


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(dtype)


def _rows_bitmap(csr: Csr, device: torch.device) -> torch.Tensor:
    n = csr.n_rows
    src = np.repeat(np.arange(n), np.diff(csr.row_offsets))
    return torch.from_numpy(pack_bitmap_rows(n, src, csr.col_indices)).to(
        device)


def intersection_counts(csr: Csr, u, v, *, witnesses: bool = False,
                        device: str | torch.device | None = None):
    """|N(u_i) ∩ N(v_i)| for every query pair, on full (undirected)
    neighbourhoods. Returns counts int32 [len(u)] (and, with
    ``witnesses=True``, the per-vertex witness histogram int64 [V]). Any V:
    the all-rows bitmap up to 2^17 vertices, the chunked engine above."""
    dev = _device(u, device)
    u = _host(u, np.int32)
    v = _host(v, np.int32)
    if csr.n_rows > _DENSE_V_MAX:
        return _intersection_counts_chunked(csr, u, v, witnesses, dev)
    cnt, wit = bitmap_intersect_counts(
        torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev),
        _rows_bitmap(csr, dev), witness=witnesses)
    if witnesses:
        return cnt, unpack_witness_counts(wit, csr.n_rows)
    return cnt


def chunk_bits(nq: int) -> int:
    """The chunked engine's column chunk for ``nq`` queried vertices:
    (nq+1) * W/8 bytes per chunk, a power of two of at least 4096 bits and
    at most 2^22."""
    w_bits = max(_CHUNK_BYTES * 8 // max(nq + 1, 1), 32 * LANES)
    return min(1 << int(np.log2(w_bits)), 1 << 22)


def _intersection_counts_chunked(csr: Csr, u: np.ndarray, v: np.ndarray,
                                 witnesses: bool, dev: torch.device):
    """Any-scale pair intersection: bitmap rows restricted to the QUERIED
    vertices, column (witness) axis in vertex-range chunks. counts = sum
    over chunks of |N(u) ∩ N(v) ∩ [lo, lo+W)|."""
    n = csr.n_rows
    npairs = u.shape[0]
    # remap queried vertices to dense row ids
    qverts, inv = np.unique(np.concatenate([u, v]), return_inverse=True)
    nq = int(qverts.shape[0])
    uq = inv[:npairs].astype(np.int32)
    vq = inv[npairs:].astype(np.int32)
    # adjacency of the queried rows only (host gather, once)
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    lens = off[qverts + 1] - off[qverts]
    qsrc = np.repeat(np.arange(nq, dtype=np.int64), lens)
    take = np.repeat(off[qverts] - (np.cumsum(lens) - lens), lens) \
        + np.arange(int(lens.sum()))
    qdst = cols[take]
    order = np.argsort(qdst, kind="stable")
    qsrc, qdst = qsrc[order], qdst[order]

    w_bits = chunk_bits(nq)
    uu = torch.from_numpy(uq).to(dev)
    vv = torch.from_numpy(vq).to(dev)
    counts = torch.zeros(npairs, dtype=torch.int64, device=dev)
    wit = torch.zeros(n, dtype=torch.int64, device=dev) if witnesses else None
    r = max(-(-(w_bits // 32) // LANES), 1)
    for lo in range(0, n, w_bits):
        hi = min(lo + w_bits, n)
        a, b = np.searchsorted(qdst, [lo, hi])
        # rectangular pack: nq+1 rows (last all-zero for pads) x w_bits
        bits = np.zeros((nq + 1, r * LANES), np.uint32)
        d = qdst[a:b] - lo
        np.bitwise_or.at(bits, (qsrc[a:b], d >> 5),
                         np.uint32(1) << (d & 31).astype(np.uint32))
        cnt, crole = bitmap_intersect_counts(
            uu, vv, torch.from_numpy(bits.view(np.int32)).to(dev),
            witness=witnesses)
        counts += cnt
        if witnesses:
            wit[lo:hi] += unpack_witness_counts(crole, hi - lo)
    counts = counts.int()
    if witnesses:
        return counts, wit
    return counts


def jaccard(csr: Csr, u, v, *,
            device: str | torch.device | None = None) -> torch.Tensor:
    """Jaccard similarity |N(u) ∩ N(v)| / |N(u) ∪ N(v)| per query pair,
    float64 (0 where the union is empty)."""
    dev = _device(u, device)
    u = torch.from_numpy(_host(u, np.int64)).to(dev)
    v = torch.from_numpy(_host(v, np.int64)).to(dev)
    inter = intersection_counts(csr, u, v, device=dev).double()
    deg = torch.from_numpy(np.diff(csr.row_offsets).astype(np.float64)).to(
        dev)
    union = deg[u] + deg[v] - inter
    return torch.where(union > 0, inter / union.clamp(min=1), 0.0)
