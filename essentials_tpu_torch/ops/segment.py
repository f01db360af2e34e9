"""Segment engine: expansion, permutation and per-segment combines.

Counterpart of ``essentials_tpu/ops/segment.py`` (:40, :77, :97). The JAX
package avoids arbitrary gathers on the edge axis because its device runs
them element by element; it expands by a telescoping cumsum, permutes by a
sort and combines by scans. A CUDA kernel gathers and reduces where the
data lies:

* ``expand_vertex_to_edges`` writes each segment's value (the
  ``expand_segments`` kernel);
* ``gather`` moves payloads through an index array, which replaces the JAX
  package's permutation sorts (the ``gather_payloads`` kernel);
* ``combine_by_offsets`` reduces each segment with one warp (the
  ``segment_reduce`` kernel);
* ``combine_minmax_multi`` takes each segment's MAX and MIN over its active
  edges of up to eight payloads at once (the ``segment_minmax`` kernel).

``apply_permutation`` (``R[rank[e]] = payload[e]``) and the keyed
``segment_combine`` are not Pallas kernels in the JAX package either (a
sort and an XLA scatter): here they are one ``index_put_`` per payload and
one ``scatter_reduce_``.

The routed forms (``OffsetsRoute``, ``*_routed``, ``expand_multi_then_route``)
stage these moves through Benes networks on the TPU; the port's graph has no
plans and needs none of them.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.ops.configs import Combine


def combine_identity(combine: Combine, dtype: torch.dtype):
    """The identity of ``combine`` on ``dtype`` (what an empty segment or an
    inactive edge holds)."""
    if combine == Combine.SUM:
        return False if dtype == torch.bool else 0
    if combine == Combine.OR:
        return False
    if combine == Combine.AND:
        return True
    if combine not in (Combine.MIN, Combine.MAX):
        raise ValueError(combine)
    if dtype == torch.bool:
        return combine == Combine.MIN
    if dtype.is_floating_point:
        return float("inf") if combine == Combine.MIN else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if combine == Combine.MIN else info.min


def to_words(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit carrier of ``x``: int32 and float32 as they are, bools and
    narrower integers widened to int32."""
    if x.dtype in (torch.int32, torch.float32):
        return x.contiguous()
    throw_if(x.element_size() > 4 or x.is_floating_point(),
             f"no 32-bit carrier for {x.dtype}")
    return x.int()


def from_words(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dtype == dtype:
        return x
    if dtype == torch.bool:
        return x != 0
    return x.to(dtype)


def expand_vertex_to_edges(vertex_vals: torch.Tensor, offsets: torch.Tensor,
                           n_edges_padded: int) -> torch.Tensor:
    """Broadcast vertex_vals[v] to every edge slot of segment v; ``offsets``
    cover the whole padded edge axis (offsets[-1] == n_edges_padded). Exact
    for every dtype with a 32-bit carrier (floats move as bits)."""
    w = to_words(vertex_vals)
    bits = w.view(torch.int32) if w.dtype == torch.float32 else w
    out = kernels.expand_segments(bits, offsets, n_edges_padded)
    if w.dtype == torch.float32:
        return out.view(torch.float32)
    return from_words(out, vertex_vals.dtype)


def gather(idx: torch.Tensor, *payloads: torch.Tensor) -> tuple:
    """payload[idx] for each payload, in one ``gather_payloads`` launch per
    four payloads; each result keeps its payload's dtype."""
    words = [to_words(p) for p in payloads]
    out = []
    for i in range(0, len(words), 4):
        out.extend(kernels.gather_payloads(idx, *words[i:i + 4]))
    return tuple(from_words(o, p.dtype) for o, p in zip(out, payloads))


def combine_by_offsets(edge_vals: torch.Tensor, offsets: torch.Tensor,
                       combine: Combine) -> torch.Tensor:
    """Per-segment reduction over a sorted edge order: [n_segments], the
    identity at empty segments. OR and AND give bool; SUM, MIN and MAX give
    ``edge_vals``' dtype (a bool SUM is true where the count is not 0). The
    JAX package's ``seg_flags`` argument is not taken: the kernel needs
    only the offsets."""
    combine = Combine(combine)
    dt = edge_vals.dtype
    carrier = edge_vals if dt in (torch.int32, torch.float32) else (
        edge_vals.float() if dt.is_floating_point else edge_vals.int())
    out = kernels.segment_reduce(carrier.contiguous(), offsets, combine.value)
    if combine in (Combine.OR, Combine.AND):
        return out
    return from_words(out, dt)


def combine_minmax_multi(edge_vals_list, active: torch.Tensor,
                         offsets: torch.Tensor) -> list:
    """Per-segment (MAX, MIN) over the ACTIVE edges of several int32 edge
    arrays: [(max [S], min [S]), ...] with -2^31 / 2^31-1 at empty or
    all-inactive segments, as ``essentials_tpu/ops/segment.py:351``. One
    ``segment_minmax`` launch per eight arrays; the JAX package's ``route``
    and ``seg_flags`` are not taken (the kernel needs only the offsets)."""
    mx, mn = kernels.segment_minmax(
        [v.contiguous() for v in edge_vals_list], active.contiguous(),
        offsets)
    return list(zip(mx, mn))


def apply_permutation(rank: torch.Tensor, *payloads: torch.Tensor):
    """Reorder each payload so slot rank[e] receives payload[e]: the result
    R satisfies R[rank[e]] = payload[e] (``rank`` a permutation of [0, n)).
    One ``index_put_`` per payload; one payload gives a tensor, several a
    tuple."""
    idx = (rank.long(),)
    out = tuple(torch.empty_like(p).index_put_(idx, p) for p in payloads)
    return out if len(out) > 1 else out[0]


def segment_combine(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, combine: Combine) -> torch.Tensor:
    """Keyed segmented reduction: [num_segments], the identity at empty
    segments; ids outside [0, num_segments) are dropped, as the JAX
    package's ``jax.ops.segment_*`` drop them. OR and AND give bool (each
    value read as a truth value), SUM, MIN and MAX ``data``'s dtype."""
    combine = Combine(combine)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    # dropped values land in a spare last segment
    ids = torch.where(keep, segment_ids.long(), num_segments)
    if combine in (Combine.OR, Combine.AND):
        data = data != 0
        combine = Combine.MAX if combine == Combine.OR else Combine.MIN
    dt = data.dtype
    carrier = data.to(torch.int32) if dt == torch.bool else data
    out = torch.full((num_segments + 1,), combine_identity(combine, dt),
                     dtype=carrier.dtype, device=data.device)
    reduce = {Combine.SUM: "sum", Combine.MIN: "amin",
              Combine.MAX: "amax"}[combine]
    out.scatter_reduce_(0, ids, carrier, reduce)
    return from_words(out[:num_segments], dt) if dt == torch.bool \
        else out[:num_segments]
