"""Distributed supersteps: one process per device over torch.distributed.

Counterpart of ``essentials_tpu/parallel/distributed.py``. The JAX package
runs one controller over stacked [P, ...] arrays inside a jitted
``shard_map`` loop; the port runs one process per device, each holding its
own partition (``DistGraph.local``), and calls the collectives on that
rank's tensors. The per-superstep recipe:

  1. exchange the sharded frontier/value vector: ``all_gather_into_tensor``
     (the full [Vtot] replica) or, when the partitioner chose boundary mode,
     gather each owner's STATIC requested-vertex sets and
     ``all_to_all_single`` exactly those values ([P, Smax] per device; comm
     volume P*Smax instead of Vtot — DistGraph.comm_values_per_step);
  2. expand the exchanged vector along the device's source-sorted edge
     block (the ``expand_segments`` kernel);
  3. move the edge values into local-dst order (``gather_payloads`` through
     ``route_idx``) and combine per destination (``segment_reduce``);
  4. ``all_reduce`` a one-element flag or sum for convergence, read on the
     host once per superstep (as the single-chip loops read theirs).

``overlap=True`` exchanges the per-peer chunks over a ring of
``batch_isend_irecv`` steps and expands/gathers/combines each chunk as it
arrives, the next step's sends and receives issued before the current
chunk is processed. Each ``dist_*`` returns this rank's [Vs] shard on its
device (``multihost.gather_global`` assembles the global vector).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.ops.configs import Combine
from essentials_tpu_torch.ops.segment import (combine_by_offsets,
                                              expand_vertex_to_edges, gather)
from essentials_tpu_torch.parallel.mesh import Mesh
from essentials_tpu_torch.parallel.partition import DistGraph, LocalGraph

UNREACHED = np.iinfo(np.int32).max


def _local(dg: DistGraph | LocalGraph, mesh: Mesh, overlap: bool
           ) -> LocalGraph:
    """This rank's slice on its device: a LocalGraph as it is, a DistGraph
    moved there."""
    part = dg if isinstance(dg, LocalGraph) else dg.local(mesh.rank,
                                                          mesh.device)
    g = part.graph
    throw_if(g.n_devices != mesh.size or part.rank != mesh.rank
             or part.device != mesh.device,
             f"partition of {g.n_devices} devices (rank {part.rank} on "
             f"{part.device}) on a mesh of {mesh.size} (rank {mesh.rank} on "
             f"{mesh.device})")
    if overlap and not g.peer_edges:
        raise ValueError("overlap mode needs partition_graph(..., "
                         "overlap=True)")
    return part


def _spread_local(x_full, soff, route_idx, es):
    """Common local step: expand exchanged values along the local
    source-sorted edge axis, move them to local dst order. Returns
    dst-ordered per-edge values [Es]."""
    return gather(route_idx, expand_vertex_to_edges(x_full, soff, es))[0]


def _exchanger(part: LocalGraph, mesh: Mesh):
    """Per-superstep value exchange: vals [Vs] -> the source vector the
    expansion offsets span (mode from the partition)."""
    if part.graph.boundary_size:
        def exchange(vals):
            send = vals[part.send_idx]                   # [P, Smax]
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=mesh.group)
            # pad slot for the pad-edge segment (csrc_offsets has one)
            return torch.cat([recv.reshape(-1), vals.new_zeros(1)])
        return exchange

    def exchange(vals):
        out = vals.new_empty(mesh.size * vals.numel())
        dist.all_gather_into_tensor(out, vals.contiguous(),
                                    group=mesh.group)
        return out
    return exchange


def _overlap_sweep(part: LocalGraph, mesh: Mesh, vals, combine: Combine,
                   ident, msg=None, wpad=None):
    """Comm/compute-overlapped superstep: ring-exchange the per-peer chunks
    and expand/gather/combine each chunk AS IT ARRIVES, accumulating
    partial per-destination combines associatively. At step k this rank
    sends to (d+k)%P and receives peer (d-k)%P's chunk; the sends and
    receives of step k+1 are issued before chunk k is processed, and each
    is waited on just before use. Exact by construction: per-peer partial
    combines over disjoint edge sets, folded with the same associative
    ``combine``.

    vals [Vs] owned values; msg(fe, w_slice) optional per-edge transform
    over ``wpad`` (the weights padded by Eq); returns combined [Vs]."""
    g = part.graph
    p_, d = mesh.size, mesh.rank
    eq, vs = g.peer_edges, g.block_size

    def row(k):
        """The chunk this rank sends at step k, to peer (d+k)%P."""
        if g.boundary_size:
            return vals[part.send_idx[(d + k) % p_]]
        return vals.contiguous()

    def start(k):
        """Issue step k's send and receive: (receive buffer, handles, the
        send buffer, kept alive until the handles are waited on)."""
        send = row(k)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (d + k) % p_, mesh.group),
               dist.P2POp(dist.irecv, recv, (d - k) % p_, mesh.group)]
        return recv, dist.batch_isend_irecv(ops), send

    def process(acc, chunk, q):
        lo = part.peer_edge_starts[q]
        cv = torch.cat([chunk, chunk.new_full((1,), ident)])
        if cv.dtype == torch.int8:
            cv = cv.int()
        fe = expand_vertex_to_edges(cv, part.peer_src_offsets[q], eq)
        if msg is not None:
            fe = msg(fe, wpad[lo:lo + eq])
        fed = gather(part.peer_route_idx[q], fe)[0]
        got = combine_by_offsets(fed, part.peer_dst_offsets[q], combine)[:vs]
        return fold(acc, got)

    fold = {Combine.OR: torch.bitwise_or, Combine.SUM: torch.add,
            Combine.MIN: torch.minimum}[combine]
    acc = torch.zeros(vs, dtype=torch.bool, device=vals.device) \
        if combine == Combine.OR else torch.full_like(vals, ident)
    nxt = start(1) if p_ > 1 else None
    acc = process(acc, row(0), d)
    for k in range(1, p_):
        cur = nxt
        nxt = start(k + 1) if k + 1 < p_ else None
        for work in cur[1]:
            work.wait()
        acc = process(acc, cur[0], (d - k) % p_)
    return acc


def _any(mesh: Mesh, flag: torch.Tensor) -> bool:
    """True where ``flag`` holds on some rank: one all_reduce and one host
    read."""
    total = flag.to(torch.int32).reshape(1)
    dist.all_reduce(total, group=mesh.group)
    return bool(total.item())


def dist_bfs(dg: DistGraph | LocalGraph, mesh: Mesh, source: int, *,
             max_iterations: int | None = None, overlap: bool = False
             ) -> torch.Tensor:
    """Multi-device BFS. Returns this rank's distances [Vs] (UNREACHED =
    int32 max).

    overlap=True processes each peer's exchanged chunk as it arrives off
    the ring instead of a monolithic exchange-then-expand superstep."""
    part = _local(dg, mesh, overlap)
    g, dev = part.graph, part.device
    vs, es = g.block_size, g.edges_per_device
    max_it = max_iterations or g.n_vertices + 1
    exchange = _exchanger(part, mesh)
    lo = mesh.rank * vs
    dist_ = torch.full((vs,), UNREACHED, dtype=torch.int32, device=dev)
    frontier = torch.zeros(vs, dtype=torch.bool, device=dev)
    if lo <= source < lo + vs:
        dist_[source - lo] = 0
        frontier[source - lo] = True
    it = 0
    while it < max_it:
        if overlap:
            reached = _overlap_sweep(part, mesh, frontier.to(torch.int8),
                                     Combine.OR, 0)
        else:
            f_src = exchange(frontier.to(torch.int8))
            fe = _spread_local(f_src.int(), part.src_offsets, part.route_idx,
                               es)
            reached = combine_by_offsets(fe, part.dst_offsets,
                                         Combine.OR)[:vs]
        frontier = reached & (dist_ == UNREACHED) & part.vertex_valid
        dist_ = torch.where(frontier, it + 1, dist_)
        it += 1
        if not _any(mesh, frontier.any()):
            break
    return dist_


def dist_sssp(dg: DistGraph | LocalGraph, mesh: Mesh, source: int, *,
              max_iterations: int | None = None, overlap: bool = False
              ) -> torch.Tensor:
    """Multi-device SSSP (Bellman-Ford frontier relaxation): per superstep,
    exchange the sharded distance vector, relax every local edge
    (dist[src] + w), MIN-combine per owned destination; converge when no
    distance improved anywhere. Returns this rank's distances [Vs]
    (unreached = +inf). overlap=True: per-peer ring processing."""
    part = _local(dg, mesh, overlap)
    g, dev = part.graph, part.device
    vs, es = g.block_size, g.edges_per_device
    max_it = max_iterations or g.n_vertices + 1
    exchange = _exchanger(part, mesh)
    inf = float("inf")
    if overlap:
        wpad = torch.cat([part.weights, part.weights.new_zeros(g.peer_edges)])
    else:
        # static per-device data: move the weights to dst order once
        we = gather(part.route_idx, part.weights)[0]

    def relax(de, w):
        return torch.where(torch.isfinite(de), de + w, inf)

    lo = mesh.rank * vs
    dist_ = torch.full((vs,), inf, dtype=torch.float32, device=dev)
    if lo <= source < lo + vs:
        dist_[source - lo] = 0.0
    it = 0
    while it < max_it:
        if overlap:
            cand = _overlap_sweep(part, mesh, dist_, Combine.MIN, inf,
                                  msg=relax, wpad=wpad)
        else:
            de = _spread_local(exchange(dist_), part.src_offsets,
                               part.route_idx, es)
            cand = combine_by_offsets(relax(de, we), part.dst_offsets,
                                      Combine.MIN)[:vs]
        better = part.vertex_valid & (cand < dist_)
        dist_ = torch.where(better, cand, dist_)
        it += 1
        if not _any(mesh, better.any()):
            break
    return dist_


def dist_pagerank(dg: DistGraph | LocalGraph, mesh: Mesh, *,
                  alpha: float = 0.85, tol: float = 1e-6,
                  max_iterations: int = 100, overlap: bool = False
                  ) -> torch.Tensor:
    """Multi-device PageRank (unweighted spread). Returns this rank's ranks
    [Vs]. overlap=True: per-peer ring processing. The float sums differ in
    order from the JAX package's prefix differences: equal to a
    tolerance, not to the bit."""
    part = _local(dg, mesh, overlap)
    g, dev = part.graph, part.device
    vs, es, nv = g.block_size, g.edges_per_device, g.n_vertices
    exchange = _exchanger(part, mesh)
    odeg, vvalid = part.out_degrees, part.vertex_valid
    dangling_mask = vvalid & (odeg == 0)
    ids = torch.arange(vs, device=dev) + mesh.rank * vs
    p = torch.where(ids < nv, 1.0 / nv, 0.0).to(torch.float32)
    tol32 = float(np.float32(tol))     # err is float32, as in the JAX loop
    it = 0
    while it < max_iterations:
        # contributions computed owner-side, then exchanged
        contrib = torch.where(odeg > 0, p / odeg, 0.0)
        if overlap:
            pulled = _overlap_sweep(part, mesh, contrib, Combine.SUM, 0.0)
        else:
            msg = _spread_local(exchange(contrib), part.src_offsets,
                                part.route_idx, es)
            pulled = combine_by_offsets(msg, part.dst_offsets,
                                        Combine.SUM)[:vs]
        dangling = torch.where(dangling_mask, p, 0.0).sum().reshape(1)
        dist.all_reduce(dangling, group=mesh.group)
        base = (1.0 - alpha) / nv + alpha * dangling / nv
        p_new = torch.where(vvalid, base + alpha * pulled, 0.0)
        err = (p_new - p).abs().sum().reshape(1)
        dist.all_reduce(err, group=mesh.group)
        p = p_new
        it += 1
        if not err.item() > tol32:
            break
    return p
