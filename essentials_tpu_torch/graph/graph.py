"""The device Graph: a frozen dataclass of tensors with padded shapes.

Counterpart of ``essentials_tpu/graph/graph.py:150-263`` with the same
padding contract and the same fields:

* Vertices are padded to ``Vp`` (a multiple of ``vertex_pad`` with at least
  one spare slot) and edges to ``Ep``. The spare vertex
  ``pad_vertex == n_vertices`` owns the pad edges ``[E, Ep)``:
  ``row_offsets[v+1:] = Ep`` for ``v >= pad_vertex``, pad ``src = dst =
  pad_vertex``, pad weight 0.
* Edge-centric dual order: CSR (sorted by src, then dst) and CSC (sorted by
  dst, then src) with ``csc_edge_ids`` (CSC slot -> CSR edge id),
  ``csc_rank`` (its inverse) and the segment-start flags of both orders.

The JAX package also builds Beneš router plans here (``route_fwd``,
``route_bwd``, ``off_route_*``). They exist only because gathers are slow
on its device; a CUDA kernel loads through ``csc_src_indices`` and
``row_offsets`` directly, so the port has no plans.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.coo import Coo
from essentials_tpu_torch.formats.csr import Csr

# Tensor fields, in the JAX Graph's order without its router plans.
ARRAY_FIELDS = ("row_offsets", "col_indices", "src_indices", "values",
                "csc_offsets", "csc_src_indices", "csc_dst_indices",
                "csc_values", "csc_edge_ids", "csc_rank", "csc_seg_flags",
                "csr_seg_flags")
META_FIELDS = ("n_vertices", "n_edges", "n_vertices_padded",
               "n_edges_padded", "properties", "max_degree",
               "symmetric_layout")
_CSC_FIELDS = ("csc_offsets", "csc_src_indices", "csc_dst_indices",
               "csc_values", "csc_edge_ids", "csc_rank", "csc_seg_flags")


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class GraphProperties:
    """Reference parity: graph_properties_t (graph/properties.hxx:13-17)."""
    directed: bool = True
    weighted: bool = True


@dataclass(frozen=True)
class Graph:
    # --- metadata ---
    n_vertices: int
    n_edges: int
    n_vertices_padded: int       # Vp >= n_vertices + 1
    n_edges_padded: int          # Ep >= n_edges
    properties: GraphProperties

    # --- CSR order (sorted by src, then dst) ---
    row_offsets: torch.Tensor    # [Vp + 1] int32; rows >= V own the pad edges
    col_indices: torch.Tensor    # [Ep] int32 dst; pad = pad_vertex
    src_indices: torch.Tensor    # [Ep] int32 src; pad = pad_vertex
    values: torch.Tensor         # [Ep] weight; pad = 0

    # --- CSC order (sorted by dst, then src); None when not built ---
    csc_offsets: torch.Tensor | None      # [Vp + 1] int32
    csc_src_indices: torch.Tensor | None  # [Ep] int32
    csc_dst_indices: torch.Tensor | None  # [Ep] int32
    csc_values: torch.Tensor | None       # [Ep] weight
    csc_edge_ids: torch.Tensor | None     # [Ep] int32 -> CSR edge id
    csc_rank: torch.Tensor | None         # [Ep] int32: CSC position of CSR edge e
    csc_seg_flags: torch.Tensor | None    # [Ep] bool: dst-segment starts (CSC)
    csr_seg_flags: torch.Tensor           # [Ep] bool: src-segment starts (CSR)

    max_degree: int = 0                # max out-degree over real vertices
    symmetric_layout: bool = False     # csc_offsets == row_offsets

    @property
    def pad_vertex(self) -> int:
        return self.n_vertices

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    def vertex_mask(self) -> torch.Tensor:
        """[Vp] bool: True at the real vertices [0, V)."""
        return torch.arange(self.n_vertices_padded,
                            device=self.device) < self.n_vertices

    def edge_mask(self) -> torch.Tensor:
        """[Ep] bool: True at the real edges [0, E) (CSR order)."""
        return torch.arange(self.n_edges_padded,
                            device=self.device) < self.n_edges

    def out_degrees(self) -> torch.Tensor:
        """[Vp] out-degree per vertex (pad slots report pad-edge counts)."""
        return self.row_offsets[1:] - self.row_offsets[:-1]

    def in_degrees(self) -> torch.Tensor:
        throw_if(not self.has_csc, "graph built without CSC view")
        return self.csc_offsets[1:] - self.csc_offsets[:-1]

    def to(self, device: str | torch.device) -> "Graph":
        """The same graph with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in ARRAY_FIELDS
            if getattr(self, f) is not None})


def build_graph(csr: Csr | Coo, *, directed: bool = True,
                weighted: bool = True, build_csc: bool = True,
                vertex_pad: int = 8, edge_pad: int = 128,
                device: str | torch.device) -> Graph:
    """Build a Graph on ``device`` from a host Csr/Coo.

    The arrays are built on the host with NumPy, exactly as the JAX
    ``build_graph`` builds them, and copied to ``device`` once.
    """
    if isinstance(csr, Coo):
        csr = Csr.from_coo(csr)
    throw_if(csr.n_rows != csr.n_cols,
             "build_graph expects a square adjacency (use Csr directly for SpMV)")
    v, e = csr.n_rows, csr.nnz
    vp = max(_pad_to(v + 1, vertex_pad), vertex_pad)
    ep = max(_pad_to(max(e, 1), edge_pad), edge_pad)
    pad_v = v

    # CSR order arrays.
    row_offsets = np.full(vp + 1, e, dtype=dtypes.edge_dtype)
    row_offsets[: v + 1] = csr.row_offsets
    row_offsets[v + 1:] = ep  # pad edges all belong to row pad_v
    col = np.full(ep, pad_v, dtype=dtypes.vertex_dtype)
    col[:e] = csr.col_indices
    src = np.full(ep, pad_v, dtype=dtypes.vertex_dtype)
    src[:e] = np.repeat(np.arange(v, dtype=dtypes.vertex_dtype),
                        np.diff(csr.row_offsets).astype(np.int64))
    val = np.zeros(ep, dtype=csr.values.dtype if weighted else dtypes.weight_dtype)
    val[:e] = csr.values if weighted else 1

    csr_flags = np.zeros(ep, bool)
    csr_flags[row_offsets[:-1][np.diff(row_offsets.astype(np.int64)) > 0]] = True

    arrays = dict(row_offsets=row_offsets, col_indices=col, src_indices=src,
                  values=val, csr_seg_flags=csr_flags)
    arrays.update(dict.fromkeys(_CSC_FIELDS))
    if build_csc:
        order = np.lexsort((src[:e], col[:e]))
        csc_src = np.full(ep, pad_v, dtypes.vertex_dtype)
        csc_dst = np.full(ep, pad_v, dtypes.vertex_dtype)
        csc_val = np.zeros(ep, val.dtype)
        csc_eid = np.arange(ep, dtype=dtypes.edge_dtype)
        csc_src[:e] = src[order]
        csc_dst[:e] = col[order]
        csc_val[:e] = val[order]
        csc_eid[:e] = order.astype(dtypes.edge_dtype)
        in_deg = np.bincount(col[:e], minlength=v).astype(np.int64)
        csc_off = np.full(vp + 1, e, dtype=dtypes.edge_dtype)
        np.cumsum(in_deg, out=csc_off[1: v + 1])
        csc_off[0] = 0
        csc_off[v + 1:] = ep
        # rank permutation: CSC position of each CSR edge (pad edges fixed)
        rank = np.arange(ep, dtype=dtypes.edge_dtype)
        rank[order] = np.arange(e, dtype=dtypes.edge_dtype)
        csc_flags = np.zeros(ep, bool)
        csc_flags[csc_off[:-1][np.diff(csc_off.astype(np.int64)) > 0]] = True
        arrays.update(csc_offsets=csc_off, csc_src_indices=csc_src,
                      csc_dst_indices=csc_dst, csc_values=csc_val,
                      csc_edge_ids=csc_eid, csc_rank=rank,
                      csc_seg_flags=csc_flags)

    meta = dict(
        n_vertices=v, n_edges=e, n_vertices_padded=vp, n_edges_padded=ep,
        properties=GraphProperties(directed=directed, weighted=weighted),
        max_degree=int(np.diff(csr.row_offsets).max()) if e else 0,
        symmetric_layout=bool(
            build_csc and np.array_equal(row_offsets, arrays["csc_offsets"])))
    return graph_from_arrays(arrays, meta, device)


def graph_from_arrays(fields: dict, meta: dict,
                      device: str | torch.device) -> Graph:
    """A Graph on ``device`` from NumPy arrays and metadata.

    ``fields`` maps every name in ARRAY_FIELDS to an array (None for the CSC
    fields of a graph built without CSC); ``meta`` maps every name in
    META_FIELDS to its value, ``properties`` as a GraphProperties, a dict, or
    any object with ``directed`` and ``weighted``. This is how a graph built
    elsewhere, for instance by the JAX package, is carried into the port."""
    throw_if(set(fields) != set(ARRAY_FIELDS),
             f"graph_from_arrays: fields must be exactly {ARRAY_FIELDS}")
    throw_if(set(meta) != set(META_FIELDS),
             f"graph_from_arrays: meta must be exactly {META_FIELDS}")
    props = meta["properties"]
    if isinstance(props, dict):
        props = GraphProperties(**props)
    props = GraphProperties(directed=bool(props.directed),
                            weighted=bool(props.weighted))
    tensors = {k: None if a is None
               else torch.from_numpy(np.array(a, copy=True)).to(device)
               for k, a in fields.items()}
    return Graph(n_vertices=int(meta["n_vertices"]),
                 n_edges=int(meta["n_edges"]),
                 n_vertices_padded=int(meta["n_vertices_padded"]),
                 n_edges_padded=int(meta["n_edges_padded"]),
                 properties=props, max_degree=int(meta["max_degree"]),
                 symmetric_layout=bool(meta["symmetric_layout"]), **tensors)
