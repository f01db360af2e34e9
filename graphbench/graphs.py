"""The benchmark's graphs, made on the device from a seed.

A configuration file (``configs/<name>.json``) names a generator and its
sizes. ``make`` draws the edge pairs on the device with a
``torch.Generator`` seeded from the run's seed, symmetrizes them, drops
self-loops and duplicates (as GAP's graph construction does), and lays
the result out as the twelve tensor fields of the program's ``Graph``,
following the
padding contract of ``essentials_tpu_torch/graph/graph.py``: vertices
padded to ``Vp`` (a multiple of 8 with a spare slot), edges to ``Ep`` (a
multiple of 128), the spare vertex ``V`` owning the pad edges, CSR sorted
by (src, dst), CSC sorted by (dst, src) with ``csc_edge_ids`` (CSC slot ->
CSR edge id) and ``csc_rank`` (its inverse). A CPU test holds this layout
equal to the program's host ``build_graph`` field by field.

Weights are symmetric: the weight of {u, v} is a hash of (min, max, seed)
mapped to a float32 in [0, 1) with 24 random bits, so both directions of an
edge carry the same weight without a lookup.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
VERTEX_PAD = 8           # the program's build_graph defaults
EDGE_PAD = 128
CHUNK = 1 << 26          # edges per chunk of the elementwise passes


class Csr(NamedTuple):
    """The benchmark's own CSR of a graph, which the reference reads:
    [V + 1] int32 offsets, [E] int32 columns, [E] float32 weights."""
    n: int
    row_offsets: torch.Tensor
    col: torch.Tensor
    values: torch.Tensor

    @property
    def n_edges(self) -> int:
        return self.col.numel()


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of a run's ``seed``, so that
    the graph and the query sources come from separate streams."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


# ----------------------------------------------------------- generators --

def kronecker_bits(cfg: dict, gen: torch.Generator, device) -> tuple:
    """The pairs of Graph500's Kronecker generator before its permutation:
    M = edge_factor * 2^scale pairs, each bit of (u, v) drawn from the
    quadrant probabilities A, B, C. Returns (u, v) int32 [M]."""
    scale, n = cfg["scale"], 1 << cfg["scale"]
    m = cfg["edge_factor"] * n
    a, b, c = cfg["a"], cfg["b"], cfg["c"]
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    u = torch.zeros(m, dtype=torch.int32, device=device)
    v = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        del thresh
        u |= ii.int() << bit
        v |= jj.int() << bit
        del ii, jj
    return u, v


def kronecker_pairs(cfg: dict, gen: torch.Generator, device) -> tuple:
    """Graph500's Kronecker generator (spec 3.0, ``kronecker_generator.m``):
    ``kronecker_bits``' pairs with the vertex ids permuted at random.
    Returns (u, v) int32 [M]."""
    u, v = kronecker_bits(cfg, gen, device)
    perm = torch.randperm(1 << cfg["scale"], generator=gen, device=device,
                          dtype=torch.int32)
    return perm[u], perm[v]


def uniform_pairs(cfg: dict, gen: torch.Generator, device) -> tuple:
    """GAP's ``urand``: M = degree * 2^scale pairs with both ends uniform
    over the vertices. Returns (u, v) int32 [M]."""
    n = 1 << cfg["scale"]
    m = cfg["edge_factor"] * n
    u = torch.randint(0, n, (m,), generator=gen, device=device,
                      dtype=torch.int32)
    v = torch.randint(0, n, (m,), generator=gen, device=device,
                      dtype=torch.int32)
    return u, v


GENERATORS = {"kronecker": kronecker_pairs, "uniform": uniform_pairs}


def symmetric_keys(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The sorted, distinct directed edges of the undirected graph on the
    pairs (u, v) without self-loops, as int64 keys src << 32 | dst."""
    keep = u != v
    u, v = u[keep].long(), v[keep].long()
    keys = torch.cat([(u << 32) | v, (v << 32) | u])
    del u, v, keep
    keys, _ = torch.sort(keys)
    return torch.unique_consecutive(keys)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's finalizer on values in [0, 2^32) held in int64 (the
    products wrap; their low 32 bits are kept)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def edge_weights(src: torch.Tensor, dst: torch.Tensor, seed: int
                 ) -> torch.Tensor:
    """float32 weights in [0, 1), k / 2^24 for a 24-bit hash k of
    (min(src, dst), max(src, dst), seed): the same for both directions."""
    s = sub_seed(seed, "weights")
    s_lo, s_hi = s & MASK32, (s >> 32) & MASK32
    out = torch.empty(src.numel(), dtype=torch.float32, device=src.device)
    for lo_i in range(0, src.numel(), CHUNK):
        a = src[lo_i:lo_i + CHUNK].long()
        b = dst[lo_i:lo_i + CHUNK].long()
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        del a, b
        h = _fmix32(lo ^ s_lo)
        h = _fmix32(h ^ hi)
        h = _fmix32(h ^ s_hi)
        out[lo_i:lo_i + CHUNK] = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return out


# --------------------------------------------------------------- layout --

def _segment_flags(offsets: torch.Tensor, ep: int) -> torch.Tensor:
    """[Ep] bool: True at the first slot of every non-empty segment."""
    flags = torch.zeros(ep, dtype=torch.bool, device=offsets.device)
    starts = offsets[:-1][offsets[1:] > offsets[:-1]]
    flags[starts.long()] = True
    return flags


def _offsets(sorted_ids: torch.Tensor, n: int, vp: int, ep: int
             ) -> torch.Tensor:
    """[Vp + 1] int32 offsets of the segments 0..n-1 over ``sorted_ids``
    (int32, ascending), rows from n + 1 on at ``ep`` (the pad vertex n owns
    the pad edges)."""
    off = torch.full((vp + 1,), ep, dtype=torch.int32,
                     device=sorted_ids.device)
    bounds = torch.arange(n + 1, dtype=torch.int32, device=sorted_ids.device)
    off[:n + 1] = torch.searchsorted(sorted_ids, bounds).int()
    return off


def layout(keys: torch.Tensor, n: int, seed: int) -> tuple:
    """The program's Graph fields from the sorted distinct keys of a
    symmetric edge set on n vertices. Consumes ``keys``. Returns (fields
    {name: tensor}, meta {n_vertices, n_edges, n_vertices_padded,
    n_edges_padded, max_degree, symmetric_layout})."""
    device = keys.device
    e = keys.numel()
    vp = max(pad_to(n + 1, VERTEX_PAD), VERTEX_PAD)
    ep = max(pad_to(max(e, 1), EDGE_PAD), EDGE_PAD)
    if ep >= 2**31:
        raise ValueError(f"{e} edges exceed the program's int32 edge ids")

    def padded(x: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((ep,), fill, dtype=x.dtype, device=device)
        out[:e] = x
        return out

    src = padded((keys >> 32).int(), n)
    col = padded((keys & MASK32).int(), n)
    row_offsets = _offsets(src[:e], n, vp, ep)
    values = torch.zeros(ep, dtype=torch.float32, device=device)
    values[:e] = edge_weights(src[:e], col[:e], seed)
    # CSC order: the CSR edges sorted by (dst, src); the keys are distinct,
    # so the order is the one of the program's stable lexsort
    rev = (col[:e].long() << 32) | src[:e].long()
    del keys
    rev, order = torch.sort(rev)
    del rev
    csc_edge_ids = torch.arange(ep, dtype=torch.int32, device=device)
    csc_edge_ids[:e] = order.int()
    csc_rank = torch.arange(ep, dtype=torch.int32, device=device)
    csc_rank[order] = torch.arange(e, dtype=torch.int32, device=device)
    del order
    eid = csc_edge_ids[:e].long()
    csc_src = padded(src[:e][eid], n)
    csc_dst = padded(col[:e][eid], n)
    csc_values = torch.zeros(ep, dtype=torch.float32, device=device)
    csc_values[:e] = values[:e][eid]
    del eid
    csc_offsets = _offsets(csc_dst[:e], n, vp, ep)
    fields = dict(
        row_offsets=row_offsets, col_indices=col, src_indices=src,
        values=values, csc_offsets=csc_offsets, csc_src_indices=csc_src,
        csc_dst_indices=csc_dst, csc_values=csc_values,
        csc_edge_ids=csc_edge_ids, csc_rank=csc_rank,
        csc_seg_flags=_segment_flags(csc_offsets, ep),
        csr_seg_flags=_segment_flags(row_offsets, ep))
    degrees = row_offsets[1:n + 1] - row_offsets[:n]
    meta = dict(n_vertices=n, n_edges=e, n_vertices_padded=vp,
                n_edges_padded=ep,
                max_degree=int(degrees.max()) if e else 0,
                symmetric_layout=bool(torch.equal(row_offsets, csc_offsets)))
    return fields, meta


def make(cfg: dict, seed: int, device) -> tuple:
    """The configuration's graph from ``seed`` on ``device``: (fields,
    meta) as ``layout`` returns them."""
    return layout(pair_keys(cfg, seed, device), 1 << cfg["scale"], seed)


def pair_keys(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's generator from ``seed``, as ``symmetric_keys``."""
    gen = generator(seed, "graph", device)
    return symmetric_keys(*GENERATORS[cfg["generator"]](cfg, gen, device))


def csr_of(fields: dict, meta: dict) -> Csr:
    """The benchmark's CSR view of the fields: the same tensors, cut to
    the real vertices and edges."""
    n, e = meta["n_vertices"], meta["n_edges"]
    return Csr(n, fields["row_offsets"][:n + 1], fields["col_indices"][:e],
               fields["values"][:e])


def program_graph(fields: dict, meta: dict):
    """The program's Graph over the fields (no copy), undirected and
    weighted as its CLI builds a graph for BFS and SSSP."""
    from essentials_tpu_torch.graph.graph import Graph, GraphProperties
    return Graph(properties=GraphProperties(directed=False, weighted=True),
                 **meta, **fields)


# ------------------------------------------------------------ components --

def components(csr: Csr) -> tuple:
    """Connected components by min-label propagation with pointer jumping.
    Returns (label [V] int64, the root of each vertex's component, and
    undirected edges [V] int64 per root, 0 elsewhere)."""
    n, device = csr.n, csr.col.device
    label = torch.arange(n, dtype=torch.int64, device=device)
    src = rows_of(csr)
    while True:
        new = label.clone()
        for lo in range(0, csr.n_edges, CHUNK):
            s = src[lo:lo + CHUNK].long()
            d = csr.col[lo:lo + CHUNK].long()
            new.scatter_reduce_(0, s, label[d], "amin")
        while True:                       # pointer jumping
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            break
        label = new
    degrees = (csr.row_offsets[1:] - csr.row_offsets[:-1]).long()
    per_root = torch.zeros(n, dtype=torch.int64, device=device)
    per_root.scatter_add_(0, label, degrees)
    return label, per_root // 2


def rows_of(csr: Csr) -> torch.Tensor:
    """[E] int32: the source row of each CSR edge."""
    deg = (csr.row_offsets[1:] - csr.row_offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(csr.n, dtype=torch.int32, device=csr.col.device), deg,
        output_size=csr.n_edges)


def fingerprint(csr: Csr) -> list:
    """Position-weighted sums of the CSR's offsets, columns and weight
    bits: the harness takes them at set-up and again before the reference,
    so a program that writes into its inputs is seen."""
    sums = []
    for x in (csr.row_offsets, csr.col, csr.values.view(torch.int32)):
        total = 0
        for lo in range(0, x.numel(), CHUNK):
            part = x[lo:lo + CHUNK].long()
            w = torch.arange(lo, lo + part.numel(), dtype=torch.int64,
                             device=part.device) % 65521 + 1
            total += int((part * w).sum())
        sums.append(total)
    return sums
