"""Advance: frontier -> neighbour expansion with a deterministic combine.

Counterpart of ``essentials_tpu/ops/advance.py:62-259`` (reference parity:
operators::advance::execute, advance/advance.hxx:91-221). The JAX package
expands source-keyed arrays over the CSR offsets and moves them into CSC
order with one permutation sort, because its device cannot gather at speed.
Here the move is one gather:

  source side  every source-keyed payload (the frontier among them) is
               gathered straight into CSC order through ``csc_src_indices``
               (the ``gather_payloads`` kernel); an edge frontier through
               ``csc_edge_ids``;
  messages     the message closure runs elementwise on [Ep] tensors in CSC
               order, as in JAX, where XLA runs it outside any kernel;
  combine      one warp per destination over ``csc_offsets`` (the
               ``segment_reduce`` kernel).

``advance_count`` is the ``advance_count`` kernel. ``advance_edges`` fires
an edge frontier in CSC order and moves it back to CSR order with one more
gather, through ``csc_rank``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.configs import AdvanceIO, Combine
from essentials_tpu_torch.ops.segment import (combine_by_offsets,
                                              combine_identity, gather)


@dataclass(frozen=True)
class Edges:
    """Per-edge view handed to message closures ([Ep] tensors, CSC order in
    advance, CSR order in neighbor_reduce)."""
    src: torch.Tensor          # source vertex ids
    dst: torch.Tensor          # destination vertex ids
    eid: torch.Tensor          # CSR edge ids
    weight: torch.Tensor       # edge weights
    active: torch.Tensor       # bool: source-active mask
    src_vals: tuple            # src_values at each edge's source
    dst_vals: tuple            # dst_values at each edge's destination


def edge_array(msg, like: torch.Tensor) -> torch.Tensor:
    """A message as an [Ep] tensor shaped like ``like``, in the JAX
    package's default widths: Python ints and int64 become int32, Python
    floats and float64 float32."""
    if not isinstance(msg, torch.Tensor):
        dtype = (torch.bool if isinstance(msg, bool) else torch.int32
                 if isinstance(msg, int) else torch.float32)
        msg = torch.tensor(msg, dtype=dtype, device=like.device)
    elif msg.dtype == torch.int64:
        msg = msg.int()
    elif msg.dtype == torch.float64:
        msg = msg.float()
    return msg.expand(like.shape)


def _expand_and_route(g: Graph, frontier, input_kind: AdvanceIO,
                      src_values: Sequence[torch.Tensor]):
    """Source-side payloads in CSC order. Returns (active bool[Ep],
    src_vals tuple)."""
    throw_if(not g.has_csc, "advance requires the CSC (dst-sorted) view")
    input_kind = AdvanceIO(input_kind)
    payloads = list(src_values)
    static_active = edge_payload = None
    if input_kind == AdvanceIO.GRAPH or frontier is None:
        # all real edges active; in CSC order the pad edges come last
        static_active = g.edge_mask()
    elif input_kind == AdvanceIO.VERTICES:
        payloads.append(frontier)
    elif input_kind == AdvanceIO.EDGES:
        edge_payload = frontier                 # per edge, CSR order
    else:
        raise ValueError(input_kind)
    routed = list(gather(g.csc_src_indices, *payloads)) if payloads else []
    if edge_payload is not None:
        routed.extend(gather(g.csc_edge_ids, edge_payload))
    if static_active is None:
        return routed[-1] != 0, tuple(routed[:-1])
    return static_active, tuple(routed)


def _edges(g: Graph, active, src_vals, dst_values) -> Edges:
    dst_vals = gather(g.csc_dst_indices, *dst_values) if dst_values else ()
    return Edges(src=g.csc_src_indices, dst=g.csc_dst_indices,
                 eid=g.csc_edge_ids, weight=g.csc_values, active=active,
                 src_vals=src_vals, dst_vals=dst_vals)


def advance_multi(g: Graph, messages: Sequence[tuple],
                  frontier: torch.Tensor | None = None, *,
                  src_values: Sequence[torch.Tensor] = (),
                  dst_values: Sequence[torch.Tensor] = (),
                  input_kind: AdvanceIO = AdvanceIO.VERTICES,
                  with_frontier: bool = False):
    """Run several (message_fn, combine) pairs over one gather.

    Each message_fn: ``Edges -> msg [Ep]`` or ``-> (msg, cond)``. Returns a
    list of combined [Vp] tensors (and the OR'd output frontier when asked,
    from every message's cond; cond None means "active edges fire")."""
    active, src_vals = _expand_and_route(g, frontier, input_kind, src_values)
    edges = _edges(g, active, src_vals, dst_values)
    outs, fired_any = [], None
    for message_fn, combine in messages:
        out = message_fn(edges)
        msg, cond = out if isinstance(out, tuple) else (out, None)
        msg = edge_array(msg, active)
        msg = torch.where(active, msg, combine_identity(Combine(combine),
                                                        msg.dtype))
        outs.append(combine_by_offsets(msg, g.csc_offsets, combine))
        if with_frontier:
            fired = active if cond is None else active & cond
            fired_any = fired if fired_any is None else fired_any | fired
    if with_frontier:
        out_frontier = combine_by_offsets(fired_any, g.csc_offsets,
                                          Combine.OR) & g.vertex_mask()
        return outs, out_frontier
    return outs


def advance_count(g: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """int32[Vp]: the number of active in-edges of each destination (the
    ``advance_count`` kernel). OR-reach is ``advance_count(...) > 0``."""
    throw_if(not g.has_csc, "advance requires the CSC (dst-sorted) view")
    return kernels.advance_count(frontier.contiguous(), g.csc_offsets,
                                 g.csc_src_indices)


def advance(g: Graph, message_fn: Callable,
            frontier: torch.Tensor | None = None, *,
            src_values: Sequence[torch.Tensor] = (),
            dst_values: Sequence[torch.Tensor] = (),
            combine: Combine = Combine.MIN,
            input_kind: AdvanceIO = AdvanceIO.VERTICES,
            with_frontier: bool = True):
    """Single-message advance. ``message_fn(Edges) -> msg | (msg, cond)``.
    Returns ``combined [Vp]`` (and ``out_frontier bool[Vp]`` unless
    ``with_frontier=False``)."""
    res = advance_multi(g, [(message_fn, combine)], frontier,
                        src_values=src_values, dst_values=dst_values,
                        input_kind=input_kind, with_frontier=with_frontier)
    if with_frontier:
        outs, out_frontier = res
        return outs[0], out_frontier
    return res[0]


def advance_edges(g: Graph, message_fn: Callable,
                  frontier: torch.Tensor | None = None, *,
                  src_values: Sequence[torch.Tensor] = (),
                  dst_values: Sequence[torch.Tensor] = (),
                  input_kind: AdvanceIO = AdvanceIO.VERTICES) -> torch.Tensor:
    """Advance producing an *edge* frontier: bool[Ep] in CSR edge-id order.

    ``message_fn(Edges) -> cond bool[Ep]`` (CSC order). The fired edges go
    back to CSR order in one ``gather_payloads`` launch: edge e's slot in
    CSC order is ``csc_rank[e]``. The JAX package routes them back with its
    ``route_bwd`` plan or a permutation sort by ``csc_edge_ids``."""
    active, src_vals = _expand_and_route(g, frontier, input_kind, src_values)
    edges = _edges(g, active, src_vals, dst_values)
    fired = active & edge_array(message_fn(edges), active)
    (back,) = gather(g.csc_rank, fired)
    return back & g.edge_mask()
