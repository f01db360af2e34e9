"""Graph partitioning for multi-device execution.

Counterpart of ``essentials_tpu/parallel/partition.py``: a 1-D
destination-owner edge partition, built on the host with NumPy —

* vertices are split into P contiguous blocks of ``block_size`` (the global
  padded vertex count becomes Vtot = P * block_size);
* each device owns every edge whose *destination* falls in its block, so the
  per-destination combine is purely local;
* per-superstep communication is ONE exchange of the [Vs]-sharded
  frontier/value arrays (``all_gather``, or ``all_to_all`` of the static
  boundary sets);
* each device stores its edges in global-src-sorted order (so the exchanged
  vector expands along segments), an index into local-dst-sorted order, and
  local combine offsets.

Edge blocks are padded to the max per-device edge count so all stacked
arrays are rectangular. Every array equals the JAX package's field of the
same name, but for the routes: the JAX package stages each permutation
through a Beneš plan (``route_permutation``), while the port keeps the
gather index the plan was built from (``route_idx``, ``peer_route_idx``),
which one ``gather_payloads`` launch applies on the card.

Each process builds the same host partition from the same graph and moves
its own rank's slice to its device with ``DistGraph.local``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.coo import Coo
from essentials_tpu_torch.formats.csr import Csr


# Vs is a multiple of this (the JAX package's default vertex_align)
VERTEX_ALIGN = 8


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class DistGraph:
    """Edge-partitioned graph, stacked per device along axis 0 (host NumPy).

    Two exchange modes:
      all_gather — src_offsets span the full [Vtot] gathered vector;
      boundary   — each device announces the static source sets it needs
                   (send_idx), owners gather + all_to_all exactly those
                   values, and edges expand over COMPACT source slots
                   (csrc_offsets over [P*Smax]). Per-superstep comm drops
                   from Vtot to P*Smax values per device."""
    n_devices: int
    block_size: int            # Vs: vertices owned per device
    edges_per_device: int      # Es: padded edge count per device
    n_vertices: int            # real V
    n_edges: int               # real E
    boundary_size: int         # Smax (0 = all_gather mode)

    src_offsets: np.ndarray    # [P, Vtot+1] int32: global-src-sorted offsets
    dst_offsets: np.ndarray    # [P, Vs+2] int32: local-dst offsets (+trash)
    weights: np.ndarray        # [P, Es] in src-sorted order (pad -> 0)
    route_idx: np.ndarray      # [P, Es] int32: src order -> dst order gather
    vertex_valid: np.ndarray   # [P, Vs] bool (real vertices)
    out_degrees: np.ndarray    # [P, Vs] int32 global out-degree of owned verts
    send_idx: np.ndarray | None      # [P, P, Smax] int32 local ids to send
    csrc_offsets: np.ndarray | None  # [P, P*Smax+2] compact-src offsets

    # overlap-mode structures (built with overlap=True): the local edge axis
    # split by SOURCE-OWNER peer, so each exchanged chunk can be
    # expanded/gathered/combined the moment it arrives. peer_edges is the
    # rectangular per-(p,q) edge capacity; per-peer indices land each
    # peer's edges in ITS OWN dst-sorted order with its own combine
    # offsets, and partial combines accumulate associatively across peers.
    peer_edges: int = 0                          # Eq capacity (0 = not built)
    peer_route_idx: np.ndarray | None = None     # [P, P, Eq] int32
    peer_dst_offsets: np.ndarray | None = None   # [P, P, Vs+2]
    peer_edge_starts: np.ndarray | None = None   # [P, P+1] edge range lo

    @property
    def n_vertices_global(self) -> int:
        return self.n_devices * self.block_size

    @property
    def comm_values_per_step(self) -> int:
        """Per-device values exchanged per superstep (comm-volume log)."""
        if self.boundary_size:
            return self.n_devices * self.boundary_size
        return self.n_vertices_global

    def local(self, rank: int, device: str | torch.device = "cuda"
              ) -> "LocalGraph":
        """Rank ``rank``'s slice as tensors on ``device`` (the card unless
        the caller asks for the CPU)."""
        throw_if(not 0 <= rank < self.n_devices,
                 f"rank {rank} outside the partition's {self.n_devices} "
                 f"devices")
        dev = torch.device(device)

        def put(a):
            """This rank's row of a stacked array, on the device."""
            return None if a is None else \
                torch.from_numpy(np.ascontiguousarray(a[rank])).to(dev)

        peer_src = None
        if self.peer_edges:
            # each peer's slice of the expansion offsets, rebased on its
            # edge range and closed by a pad segment (the JAX package
            # computes these inside every superstep)
            soff = self.csrc_offsets[rank] if self.boundary_size \
                else self.src_offsets[rank]
            span = self.boundary_size or self.block_size
            eq = self.peer_edges
            lo = self.peer_edge_starts[rank, :-1].astype(np.int64)
            rows = np.arange(self.n_devices)[:, None] * span \
                + np.arange(span + 1)[None, :]
            offs = np.clip(soff[rows].astype(np.int64) - lo[:, None], 0, eq)
            peer_src = np.concatenate(
                [offs, np.full((self.n_devices, 1), eq, np.int64)],
                axis=1).astype(dtypes.edge_dtype)
        return LocalGraph(
            graph=self, rank=rank, device=dev,
            src_offsets=put(self.csrc_offsets if self.boundary_size
                            else self.src_offsets),
            dst_offsets=put(self.dst_offsets), weights=put(self.weights),
            route_idx=put(self.route_idx),
            vertex_valid=put(self.vertex_valid),
            out_degrees=put(self.out_degrees),
            send_idx=None if self.send_idx is None
            else put(self.send_idx).long(),
            peer_route_idx=put(self.peer_route_idx),
            peer_dst_offsets=put(self.peer_dst_offsets),
            peer_src_offsets=None if peer_src is None
            else torch.from_numpy(peer_src).to(dev),
            peer_edge_starts=None if self.peer_edge_starts is None
            else self.peer_edge_starts[rank].tolist())


@dataclass(frozen=True)
class LocalGraph:
    """One rank's slice of a ``DistGraph`` on its device.
    ``src_offsets`` are the expansion offsets of the mode: the global ones
    (all_gather) or the compact-slot ones (boundary); ``send_idx`` is this
    rank's [P, Smax] (int64); ``peer_src_offsets`` [P, span+2] are each
    peer's slice of them, rebased on its edge range and closed by a pad
    segment; ``peer_edge_starts`` stays on the host."""
    graph: DistGraph
    rank: int
    device: torch.device
    src_offsets: torch.Tensor
    dst_offsets: torch.Tensor
    weights: torch.Tensor
    route_idx: torch.Tensor
    vertex_valid: torch.Tensor
    out_degrees: torch.Tensor
    send_idx: torch.Tensor | None
    peer_route_idx: torch.Tensor | None
    peer_dst_offsets: torch.Tensor | None
    peer_src_offsets: torch.Tensor | None
    peer_edge_starts: list | None


def partition_graph(csr: Csr | Coo, n_devices: int, *,
                    exchange: str = "auto",
                    overlap: bool = False) -> DistGraph:
    """1-D destination-owner partition with per-device gather-free layout.

    exchange: "all_gather" | "boundary" | "auto" (boundary when the static
    source sets make it cheaper than gathering the full vector).
    overlap: additionally build the per-source-owner edge split (per-peer
    indices + combine offsets) that lets supersteps process each exchanged
    chunk as it arrives off the ring (distributed.py overlap mode)."""
    throw_if(exchange not in ("auto", "all_gather", "boundary"),
             f"exchange must be auto, all_gather or boundary, not "
             f"{exchange!r}")
    if isinstance(csr, Coo):
        csr = Csr.from_coo(csr)
    v, e = csr.n_rows, csr.nnz
    vs = _pad_to(max(_pad_to(v, n_devices) // n_devices, 1), VERTEX_ALIGN)
    vtot = n_devices * vs
    coo = csr.to_coo()
    owner = (coo.col_indices // vs).astype(np.int64)
    counts = np.bincount(owner, minlength=n_devices)
    es = _pad_to(max(int(counts.max()), 1), 128)

    # boundary analysis: distinct sources each device needs, per owner
    # edges by (owner, src, dst): the JAX package's lexsort, as one stable
    # sort of a packed key whose last digit is the dst within its owner's
    # block; the key stays below n * Vtot, under 2^63 for int32 ids
    n = max(v, 1)
    throw_if(n * vtot >= 2**63, f"partition_graph: {v} vertices overflow "
             f"the sort key")
    o1 = np.argsort((owner * n + coo.row_indices) * vs
                    + (coo.col_indices - owner * vs), kind="stable")
    starts = np.zeros(n_devices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    need = []                       # need[q][p] = sorted global src ids
    smax = 1
    for q in range(n_devices):
        srcs = np.unique(coo.row_indices[o1[starts[q]:starts[q + 1]]])
        per_owner = [srcs[(srcs // vs) == p] for p in range(n_devices)]
        need.append(per_owner)
        smax = max(smax, max((x.shape[0] for x in per_owner), default=1))
    smax = _pad_to(smax, 8)
    if exchange == "auto":
        exchange = "boundary" if n_devices * smax < vtot // 2 else \
            "all_gather"

    src_offsets = np.zeros((n_devices, vtot + 1), dtypes.edge_dtype)
    dst_offsets = np.zeros((n_devices, vs + 2), dtypes.edge_dtype)
    weights = np.zeros((n_devices, es), coo.values.dtype)
    route_idx = np.zeros((n_devices, es), dtypes.vertex_dtype)
    send_idx = np.zeros((n_devices, n_devices, smax), dtypes.vertex_dtype)
    nslots = n_devices * smax
    csrc_offsets = np.zeros((n_devices, nslots + 2), dtypes.edge_dtype)
    per_dev_overlap = []

    for p in range(n_devices):
        sl = o1[starts[p]:starts[p + 1]]
        k = sl.shape[0]
        s, d, w = coo.row_indices[sl], coo.col_indices[sl] - p * vs, \
            coo.values[sl]
        if exchange == "boundary":
            # compact-source slot per edge: slot = owner*smax + rank within
            # the (owner -> this device) request list
            gmap = np.full(vtot, -1, np.int64)
            for po in range(n_devices):
                ids = need[p][po]
                send_idx[po, p, :ids.shape[0]] = ids - po * vs
                gmap[ids] = po * smax + np.arange(ids.shape[0])
            slots = gmap[s]
            order = np.argsort(slots, kind="stable")
            s2, d2, w2 = slots[order], d[order], w[order]
            sl_deg = np.bincount(s2, minlength=nslots).astype(np.int64)
            off = np.zeros(nslots + 2, np.int64)
            np.cumsum(sl_deg, out=off[1:nslots + 1])
            off[nslots + 1] = es        # pad slot absorbs pad edges
            csrc_offsets[p] = off
            sort_s, sort_d, sort_w = s2, d2, w2
        else:
            sort_s, sort_d, sort_w = s, d, w
            deg = np.bincount(s, minlength=vtot).astype(np.int64)
            off = np.zeros(vtot + 1, np.int64)
            np.cumsum(deg, out=off[1:])
            off[vtot] = es              # pad edges join the last segment
            src_offsets[p] = off
        # local-dst-sorted order over the (re)sorted edges: pad slots map
        # to themselves, as the JAX package's plan routes them
        o2 = np.lexsort((sort_s, sort_d))
        route_idx[p] = np.arange(es)
        route_idx[p, :k] = o2
        ddeg = np.bincount(sort_d[o2], minlength=vs).astype(np.int64)
        doff = np.zeros(vs + 2, np.int64)
        np.cumsum(ddeg, out=doff[1:vs + 1])
        doff[vs + 1] = es                  # trash slot absorbs pad edges
        dst_offsets[p] = doff
        weights[p, :k] = sort_w
        if overlap:
            # per-source-owner edge ranges in the src-sorted layout
            span = smax if exchange == "boundary" else vs
            elo = np.searchsorted(sort_s, np.arange(n_devices + 1) * span)
            per_dev_overlap.append((sort_s, sort_d, elo))

    peer_kw = {}
    if overlap:
        eq_cap = _pad_to(max(max(int(np.max(np.diff(elo)))
                                 for _, _, elo in per_dev_overlap), 1), 128)
        p_idx = np.zeros((n_devices, n_devices, eq_cap), dtypes.vertex_dtype)
        p_doffs = np.zeros((n_devices, n_devices, vs + 2), dtypes.edge_dtype)
        for p, (sort_s, sort_d, elo) in enumerate(per_dev_overlap):
            for q in range(n_devices):
                lo, hi = int(elo[q]), int(elo[q + 1])
                dq = sort_d[lo:hi]
                p_idx[p, q] = np.arange(eq_cap)
                p_idx[p, q, :hi - lo] = np.lexsort((sort_s[lo:hi], dq))
                ddeg = np.bincount(dq, minlength=vs).astype(np.int64)
                np.cumsum(ddeg, out=p_doffs[p, q, 1:vs + 1])
                p_doffs[p, q, vs + 1] = eq_cap   # trash slot absorbs peer pad
        peer_kw = dict(
            peer_edges=eq_cap, peer_route_idx=p_idx,
            peer_dst_offsets=p_doffs,
            peer_edge_starts=np.stack(
                [elo for _, _, elo in per_dev_overlap]).astype(
                dtypes.edge_dtype))

    vidx = np.arange(vtot).reshape(n_devices, vs)
    vertex_valid = vidx < v
    deg = np.zeros(vtot, dtypes.edge_dtype)
    deg[:v] = np.diff(csr.row_offsets)

    boundary = smax if exchange == "boundary" else 0
    return DistGraph(
        n_devices=n_devices, block_size=vs, edges_per_device=es,
        n_vertices=v, n_edges=e, boundary_size=boundary,
        src_offsets=src_offsets, dst_offsets=dst_offsets, weights=weights,
        route_idx=route_idx, vertex_valid=vertex_valid,
        out_degrees=deg.reshape(n_devices, vs),
        send_idx=send_idx if boundary else None,
        csrc_offsets=csrc_offsets if boundary else None,
        **peer_kw,
    )
