"""Port parity: essentials_tpu_torch's operator layer (ops.scan_kernels,
ops.segment, ops.advance, ops.neighborreduce, ops.sparse_advance, frontier,
and SSSP's dense relaxation on them) against essentials_tpu's, on the CPU,
where every kernel wrapper runs its plain version.

The JAX graphs are built without router plans (the CPU path: JAX's advance
sorts by the rank permutation and combines with jnp.cumsum and
associative_scan) and carried into the port with graph_from_arrays, so both
packages compute on the same arrays. Integer results, minima, maxima, ORs,
ANDs and gathers must be equal; float sums are summed in another order and
are held to the SpMV tolerance of benchmarks/PARITY.md, |y - ref| <=
1e-5 |ref| + 1e-6, except a float cumsum over 4,000 elements, whose
float32 running sum in JAX drifts by up to 1e-5 of its size (rtol 1e-4)."""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from essentials_tpu.formats import Coo as JCoo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.frontier import boolmap as jbm
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops import Combine as JCombine
from essentials_tpu.ops import AdvanceIO as JIO
from essentials_tpu.ops import neighborreduce as jnr
from essentials_tpu.ops import scan_kernels as jsk
from essentials_tpu.ops import segment as jseg
from essentials_tpu.ops import sparse_advance as jsa

from essentials_tpu_torch import frontier as tbm
from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import sssp as tsssp
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import AdvanceIO, Combine
from essentials_tpu_torch.ops import neighborreduce as tnr
from essentials_tpu_torch.ops import scan_kernels as tsk
from essentials_tpu_torch.ops import segment as tseg
from essentials_tpu_torch.ops import sparse_advance as tsa

# the packages export functions named like these modules
jadv = importlib.import_module("essentials_tpu.ops.advance")
tadv = importlib.import_module("essentials_tpu_torch.ops.advance")
ROOT = Path(__file__).resolve().parent.parent

RTOL, ATOL = 1e-5, 1e-6
IMAX = np.iinfo(np.int32).max


def carried(csr, directed):
    """The JAX graph (no router plans) and the port's graph made from its
    fields."""
    gj = jbuild(csr, directed=directed, weighted=True, build_router=False)
    fields = {f: None if getattr(gj, f) is None else np.asarray(getattr(gj, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return csr, gj, graph_from_arrays(fields, meta, "cpu")


@pytest.fixture(scope="module")
def graphs():
    hub = JCoo(40, 40, np.r_[np.zeros(30, np.int32), np.arange(1, 9)],
               np.r_[np.arange(1, 31), np.arange(2, 10)].astype(np.int32),
               np.linspace(0.5, 3.0, 38).astype(np.float32))
    return {
        "directed": carried(JCsr.from_coo(jgen.rmat(
            10, 8, seed=3, undirected=False, weighted=True)), True),
        "undirected": carried(JCsr.from_coo(jgen.rmat(
            9, 8, seed=5, undirected=True, weighted=True)), False),
        "hub": carried(JCsr.from_coo(hub), True),
    }


NAMES = ("directed", "undirected", "hub")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want),
                                 RTOL * np.abs(want) + ATOL + 1e-30)


def equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def rng_frontier(g, seed, p=0.2):
    rng = np.random.default_rng(seed)
    f = rng.random(g.n_vertices_padded) < p
    f[g.n_vertices:] = False
    return f


# ----------------------------------------------------------------- scans --

def scan_input(dtype, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:       # large values, so the sums wrap around
        return rng.integers(-2**30, 2**30, n).astype(np.int32)
    return rng.random(n).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_cumsum_matches_jax(dtype):
    x = scan_input(dtype)
    got = tsk.cumsum(t(x)).numpy()
    want = np.asarray(jsk.cumsum(jnp.asarray(x)))
    if dtype == np.int32:
        equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(got, np.cumsum(x, dtype=np.float64),
                                   rtol=1e-6)


@pytest.mark.parametrize("op", ["add", "min", "max", "first"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segmented_scan_matches_jax(op, dtype):
    x = scan_input(dtype, seed=1)
    flags = np.random.default_rng(2).random(x.size) < 0.02
    got = tsk.segmented_scan(t(x), t(flags), op).numpy()
    want = np.asarray(jsk.segmented_scan(jnp.asarray(x), jnp.asarray(flags),
                                         op))
    if op == "add" and dtype == np.float32:
        close(got, want)
    else:
        equal(got, want)


def test_scans_match_pallas_in_interpret_mode():
    """JAX's Pallas scan_1d and segmented_scan_1d, which run in interpret
    mode off the TPU."""
    x = scan_input(np.int32, n=3000, seed=3)
    equal(tsk.cumsum(t(x)).numpy(), np.asarray(jsk.scan_1d(jnp.asarray(x),
                                                           "add")))
    flags = np.random.default_rng(4).random(x.size) < 0.05
    got = tsk.segmented_scan(t(x), t(flags), "max").numpy()
    equal(got, np.asarray(jsk.segmented_scan_1d(jnp.asarray(x),
                                                jnp.asarray(flags), "max")))


def test_scan_carriers_and_short_inputs():
    b = np.array([True, False, True, True])
    equal(tsk.cumsum(t(b)).numpy(), np.array([1, 1, 2, 3], np.int32))
    equal(tsk.cumsum(torch.tensor([7], dtype=torch.int32)).numpy(),
          np.array([7], np.int32))
    assert tsk.cumsum(torch.zeros(0, dtype=torch.int32)).numel() == 0
    with pytest.raises(EssentialsError):
        tsk.cumsum(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(EssentialsError):
        kernels.scan(torch.zeros(3, dtype=torch.int32), None, "mul")


# --------------------------------------------------------------- segment --

def combine_input(combine, dtype, n, seed):
    rng = np.random.default_rng(seed)
    if combine in ("or", "and"):
        return rng.random(n) < (0.3 if combine == "or" else 0.9)
    if dtype == np.int32:
        return rng.integers(-2**30, 2**30, n).astype(np.int32)
    return (rng.random(n) * 4 - 1).astype(np.float32)


@pytest.mark.parametrize("order", ["csc", "csr"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("combine", ["sum", "min", "max", "or", "and"])
def test_combine_by_offsets_matches_jax(graphs, combine, dtype, order):
    _, gj, g = graphs["directed"]
    off_t = g.csc_offsets if order == "csc" else g.row_offsets
    off_j = gj.csc_offsets if order == "csc" else gj.row_offsets
    flags = gj.csc_seg_flags if order == "csc" else gj.csr_seg_flags
    x = combine_input(combine, dtype, g.n_edges_padded, 5)
    got = tseg.combine_by_offsets(t(x), off_t, Combine(combine)).numpy()
    want = np.asarray(jseg.combine_by_offsets(jnp.asarray(x), off_j,
                                              JCombine(combine), flags))
    if combine == "sum" and dtype == np.float32:
        close(got, want)
    else:
        equal(got, want)


def hub_offsets(start: int) -> np.ndarray:
    """[S+1] int32 offsets from ``start``: 6,000 segments of 0-5 slots, one
    a hub of 5,000 slots, 2,500 of them a run of empty segments."""
    rng = np.random.default_rng(9)
    lengths = rng.integers(0, 6, 6000)
    lengths[11] = 5000
    lengths[3000:5500] = 0
    return np.concatenate([[start], start + np.cumsum(lengths)]).astype(
        np.int32)


@pytest.mark.parametrize("start", [0, 37])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("combine", ["sum", "min", "max", "or", "and"])
def test_combine_by_offsets_hub_and_empty_runs_match_jax(combine, dtype,
                                                         start):
    """A hub segment, a run of empty segments, and offsets that do not
    start at 0: the port reduces vals[offsets[0]:offsets[-1]] alone. JAX's
    prefix differences count from position 0, so its copy holds the
    identity (0, False) before offsets[0] under sum, or and and; min and
    max restart at the segment flags."""
    off = hub_offsets(start)
    n = int(off[-1]) + 13
    x = combine_input(combine, dtype, n, 8)
    x_j = x.copy()
    if combine in ("sum", "or", "and"):
        x_j[:start] = 0
    flags = np.zeros(n, bool)
    flags[off[:-1][off[1:] > off[:-1]]] = True
    got = tseg.combine_by_offsets(t(x), t(off), Combine(combine)).numpy()
    want = np.asarray(jseg.combine_by_offsets(
        jnp.asarray(x_j), jnp.asarray(off), JCombine(combine),
        jnp.asarray(flags)))
    if combine == "sum" and dtype == np.float32:
        close(got, want)
    else:
        equal(got, want)
    assert got.shape == (off.size - 1,)


@pytest.mark.parametrize("name", NAMES)
def test_expand_and_permutation_match_jax(graphs, name):
    _, gj, g = graphs[name]
    rng = np.random.default_rng(6)
    for vals in (rng.random(g.n_vertices_padded).astype(np.float32),
                 rng.integers(-9, 9, g.n_vertices_padded).astype(np.int32),
                 rng.random(g.n_vertices_padded) < 0.5):
        got = tseg.expand_vertex_to_edges(t(vals), g.row_offsets,
                                          g.n_edges_padded)
        want = jseg.expand_vertex_to_edges(jnp.asarray(vals), gj.row_offsets,
                                           gj.n_edges_padded)
        equal(got.numpy(), np.asarray(want))
        # JAX moves the expansion into CSC order by the rank permutation;
        # the port gathers the vertex values through csc_src_indices
        moved = jseg.apply_permutation(gj.csc_rank, want)
        equal(tseg.gather(g.csc_src_indices, t(vals))[0].numpy(),
              np.asarray(moved))


def test_combine_identity_matches_jax():
    for c in Combine:
        for tdt, jdt in ((torch.int32, jnp.int32),
                         (torch.float32, jnp.float32)):
            assert tseg.combine_identity(c, tdt) == \
                jseg.combine_identity(JCombine(c.value), jdt)


# --------------------------------------------------------------- advance --

def _msg_min(e):
    return e.src_vals[0] + e.weight


def _msg_pred(e):
    ok = (e.src_vals[0] + e.weight) == e.dst_vals[0]
    return jnp.where(ok, e.src, IMAX) if isinstance(ok, jax.Array) else \
        torch.where(ok, e.src, IMAX)


@jax.jit
def _jax_advances(gj, f, dist):
    cand, out_f = jadv.advance(gj, _msg_min, f, src_values=(dist,),
                               combine=JCombine.MIN)
    nd = jnp.minimum(cand, dist)
    pred = jadv.advance(gj, _msg_pred, f, src_values=(dist,),
                        dst_values=(nd,), combine=JCombine.MIN,
                        with_frontier=False)
    cnt = jadv.advance_count(gj, f)
    multi = jadv.advance_multi(
        gj, [(lambda e: (e.weight, e.weight > 1.0), JCombine.SUM),
             (lambda e: e.src, JCombine.MAX)], f, with_frontier=True)
    graph_sum = jadv.advance(gj, lambda e: e.weight * e.src_vals[0], None,
                             src_values=(dist,), input_kind=JIO.GRAPH,
                             combine=JCombine.SUM, with_frontier=False)
    return cand, out_f, pred, cnt, multi, graph_sum


@pytest.mark.parametrize("name", NAMES)
def test_advance_matches_jax(graphs, name):
    _, gj, g = graphs[name]
    f = rng_frontier(g, 8)
    dist = np.random.default_rng(9).random(g.n_vertices_padded).astype(
        np.float32) * 5
    cand_j, of_j, pred_j, cnt_j, multi_j, gs_j = _jax_advances(
        gj, jnp.asarray(f), jnp.asarray(dist))
    ft, dt = t(f), t(dist)
    cand, of = tadv.advance(g, _msg_min, ft, src_values=(dt,),
                            combine=Combine.MIN)
    equal(cand.numpy(), np.asarray(cand_j))
    equal(of.numpy(), np.asarray(of_j))
    pred = tadv.advance(g, _msg_pred, ft, src_values=(dt,),
                        dst_values=(torch.minimum(cand, dt),),
                        combine=Combine.MIN, with_frontier=False)
    equal(pred.numpy(), np.asarray(pred_j))
    cnt = tadv.advance_count(g, ft)
    equal(cnt.numpy(), np.asarray(cnt_j))
    (s, mx), of2 = tadv.advance_multi(
        g, [(lambda e: (e.weight, e.weight > 1.0), Combine.SUM),
            (lambda e: e.src, Combine.MAX)], ft, with_frontier=True)
    close(s.numpy(), np.asarray(multi_j[0][0]))
    equal(mx.numpy(), np.asarray(multi_j[0][1]))
    equal(of2.numpy(), np.asarray(multi_j[1]))
    gs = tadv.advance(g, lambda e: e.weight * e.src_vals[0], None,
                      src_values=(dt,), input_kind=AdvanceIO.GRAPH,
                      combine=Combine.SUM, with_frontier=False)
    close(gs.numpy(), np.asarray(gs_j))
    # SSSP's dense round: the two MIN advances on one gather
    cand, pred = tsssp.dense_relax(g, dt, ft)
    equal(cand.numpy(), np.asarray(cand_j))
    equal(pred.numpy(), np.asarray(pred_j))


@pytest.mark.parametrize("name", NAMES)
def test_advance_count_is_the_generic_count(graphs, name):
    """advance_count (its own kernel) equals the generic advance's SUM of
    1 over the active in-edges, the JAX package's CPU path."""
    _, _, g = graphs[name]
    f = t(rng_frontier(g, 10, 0.4))
    generic = tadv.advance_multi(g, [(lambda e: 1, Combine.SUM)], f)[0]
    assert generic.dtype == torch.int32
    equal(tadv.advance_count(g, f).numpy(), generic.numpy())


@pytest.fixture(scope="module")
def chunk_graph():
    """In-segments across advance_count's chunk boundaries (c =
    ADVANCE_CHUNK): vertex 0 has 2c + 399 in-edges (slots 0 to 2c + 398,
    across two boundaries), vertex 1 has c / 2, and a chain v -> v + 1
    gives every other vertex one."""
    c = kernels.ADVANCE_CHUNK
    n = 2 * c + 400
    v = np.arange(1, n, dtype=np.int32)
    half = np.arange(2, c // 2 + 2, dtype=np.int32)
    src = np.r_[v, half, v[:-1]]
    dst = np.r_[np.zeros(n - 1, np.int32), np.ones(c // 2, np.int32), v[1:]]
    w = np.linspace(0.5, 2.0, src.size).astype(np.float32)
    return carried(JCsr.from_coo(JCoo(n, n, src, dst, w)), True)


@pytest.mark.parametrize("kind", ["empty", "full", "seeded"])
def test_advance_count_across_chunks(chunk_graph, kind):
    """advance_count where in-segments cross ADVANCE_CHUNK boundaries, under
    an empty frontier, a full one and a seeded one, equal to the JAX
    count."""
    _, gj, g = chunk_graph
    off = g.csc_offsets
    assert int(off[1]) > 2 * kernels.ADVANCE_CHUNK        # vertex 0
    vp = g.n_vertices_padded
    f = {"empty": np.zeros(vp, bool), "full": np.ones(vp, bool),
         "seeded": rng_frontier(g, 23, 0.3)}[kind]
    want = np.asarray(jax.jit(jadv.advance_count)(gj, jnp.asarray(f)))
    got = tadv.advance_count(g, t(f))
    equal(got.numpy(), want)
    equal(kernels.advance_count_plain(t(f), off, g.csc_src_indices).numpy(),
          want)
    if kind == "empty":
        assert not want.any()
    elif kind == "full":
        equal(want, g.in_degrees().numpy())


NR_MESSAGES = {"sum": lambda e: e.weight * e.dst_vals[0],
               "min": lambda e: e.src_vals[0] - e.dst_vals[0],
               "max": lambda e: e.dst}


@pytest.mark.parametrize("combine", sorted(NR_MESSAGES))
@pytest.mark.parametrize("name", NAMES)
def test_neighbor_reduce_matches_jax(graphs, name, combine):
    _, gj, g = graphs[name]
    x = np.random.default_rng(14).random(g.n_vertices_padded).astype(
        np.float32)
    fn = NR_MESSAGES[combine]
    want = jax.jit(lambda gj, x: jnr.neighbor_reduce(
        gj, fn, src_values=(x,), dst_values=(x,),
        combine=JCombine(combine)))(gj, jnp.asarray(x))
    got = tnr.neighbor_reduce(g, fn, src_values=(t(x),), dst_values=(t(x),),
                              combine=Combine(combine))
    (close if combine == "sum" else equal)(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- spray tiers --

def index_list(g, seed, members, k):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(g.n_vertices, members, replace=False))
    out = np.full(k, g.pad_vertex, np.int32)
    out[:members] = ids
    return out


@pytest.mark.parametrize("k", [4, 64, 4096])
@pytest.mark.parametrize("name", NAMES)
def test_compact_frontier_matches_jax(graphs, name, k):
    _, _, g = graphs[name]
    f = rng_frontier(g, 15, 0.3)
    got = tsa.compact_frontier(t(f), k, g.pad_vertex)
    want = jsa.compact_frontier(jnp.asarray(f), k, g.pad_vertex)
    equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("budget,k", [(jsa.TINY_BUDGET, jsa.TINY_K),
                                      (jsa.SPRAY_BUDGET, 64)])
@pytest.mark.parametrize("name", NAMES)
def test_spray_reach_and_relax_match_jax(graphs, name, budget, k):
    _, gj, g = graphs[name]
    members = min(20, g.n_vertices)
    idx = index_list(g, 16, members, k)
    dist = np.full(g.n_vertices_padded, np.inf, np.float32)
    dist[idx[:members]] = np.random.default_rng(17).random(members)
    unvisited = np.random.default_rng(18).random(g.n_vertices_padded) < 0.7
    offs_j, deg_j = jsa.frontier_out_degree(gj, jnp.asarray(idx))
    offs, deg = tsa.frontier_out_degree(g, t(idx))
    equal(offs.numpy(), np.asarray(offs_j))
    equal(deg.numpy(), np.asarray(deg_j))
    assert int(deg.sum()) <= budget
    want = jax.jit(jsa.spray_reach, static_argnums=(5, 6))(
        gj, jnp.asarray(idx), offs_j, deg_j, jnp.asarray(unvisited), budget,
        k)
    got = tsa.spray_reach(g, t(idx), offs, deg, t(unvisited), budget, k)
    for a, b in zip(got, want):
        equal(a.numpy(), np.asarray(b))
    want = jax.jit(jsa.spray_relax_min, static_argnums=(5, 6))(
        gj, jnp.asarray(idx), offs_j, deg_j, jnp.asarray(dist), budget, k)
    got = tsa.spray_relax_min(g, t(idx), offs, deg, t(dist), budget, k)
    for a, b in zip(got, want):
        equal(a.numpy(), np.asarray(b))
    e, nb, valid, pfx = tsa.spray_candidates(g, t(idx), offs, deg, budget)
    ej, nbj, srcj, validj = jsa.spray_candidates(gj, jnp.asarray(idx), offs_j,
                                                 deg_j, budget)
    assert srcj is None
    for a, b in ((e, ej), (nb, nbj), (valid, validj)):
        equal(a.numpy(), np.asarray(b))
    equal(pfx.numpy(), np.cumsum(deg.numpy(), dtype=np.int32) - deg.numpy())
    assert tsa.frontier_degree_sum(g, t(dist < np.inf)) == \
        int(jsa.frontier_degree_sum(gj, jnp.asarray(dist < np.inf)))


def test_spray_gates_follow_min_edges(graphs, monkeypatch):
    _, gj, g = graphs["directed"]
    for c in ("SPRAY_BUDGET", "SPRAY_K", "TINY_BUDGET", "TINY_K",
              "_MIN_EDGES"):
        assert getattr(jsa, c) == getattr(tsa, c), c
    assert tsa.spray_enabled(g) == jsa.spray_enabled(gj) is False
    monkeypatch.setattr(tsa, "_MIN_EDGES", 0)
    assert tsa.spray_enabled(g)
    assert tsa.spray_k(g) == jsa.spray_k(gj) == tsa.SPRAY_K


# -------------------------------------------------------------- frontier --

def test_frontier_matches_jax(graphs):
    _, gj, g = graphs["directed"]
    equal(tbm.frontier_from_indices(g, [3, 7]).numpy(),
          np.asarray(jbm.frontier_from_indices(gj, jnp.asarray([3, 7]))))
    for kind in ("vertex", "edge"):
        equal(tbm.full_frontier(g, kind).numpy(),
              np.asarray(jbm.full_frontier(gj, kind)))
        equal(tbm.empty_frontier(g, kind).numpy(),
              np.asarray(jbm.empty_frontier(gj, kind)))
    f = rng_frontier(g, 21)
    assert int(tbm.frontier_size(t(f))) == int(jbm.frontier_size(
        jnp.asarray(f)))
    assert bool(tbm.frontier_is_empty(t(f))) is False
    equal(tbm.frontier_to_indices(t(f), 50).numpy(),
          np.asarray(jbm.frontier_to_indices(jnp.asarray(f), 50)))
    equal(g.edge_mask().numpy(), np.asarray(gj.edge_mask()))


# ------------------------------------------------------- gather_payloads --

@pytest.mark.parametrize("view", ["whole", "ragged", "offset"])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_gather_payloads_plain_on_unequal_payloads_and_views(m, view):
    """1-4 payloads of unequal lengths and both dtypes through the whole
    index (n % 4 == 0), a ragged count (n % 4 == 1) and a view at an odd
    offset (4 bytes past a 16-byte boundary): each output equals the
    payload's elements, bit for bit, in its dtype."""
    rng = np.random.default_rng(30 + m)
    lengths = (500, 503, 517, 1000)[:m]
    pays = [t(rng.random(n).astype(np.float32)) if k % 2 else
            t(rng.integers(-2**31, 2**31, n, dtype=np.int64)
              .astype(np.int32)) for k, n in enumerate(lengths)]
    full = t(rng.integers(0, min(lengths), 4003).astype(np.int32))
    idx = {"whole": full[:4000], "ragged": full[:3997],
           "offset": full[1:]}[view]
    assert (idx.numel() % 4 == 0) == (view == "whole")
    assert (idx.data_ptr() % 16 == 0) == (view != "offset")
    outs = kernels.gather_payloads(idx, *pays)
    assert len(outs) == m
    for o, p in zip(outs, pays):
        assert o.dtype == p.dtype and o.shape == idx.shape
        equal(o.view(torch.int32).numpy(),
              p.view(torch.int32).numpy()[idx.numpy()])


def test_gather_packs_where_records_pay(monkeypatch):
    """Packing is chosen for 2-4 payloads from PACK_MIN_SLOTS slots and one
    slot per record of the shortest payload, never for one; on the CPU a
    shape the rule packs still takes the plain version, with no pack pass
    counted."""
    n = kernels.operators.PACK_MIN_SLOTS
    assert kernels.operators.gather_packs(n, [n, n + 7])
    assert kernels.operators.gather_packs(n, [n + 9, n, 3 * n, 5])
    assert not kernels.operators.gather_packs(n, [n])
    assert not kernels.operators.gather_packs(n - 1, [8, 8])
    assert not kernels.operators.gather_packs(n, [n + 1, n + 2])
    i32 = torch.arange(8, dtype=torch.int32)
    assert not kernels.operators.gather_packs(i32.numel(), [8, 8])
    monkeypatch.setattr(kernels.operators, "PACK_MIN_SLOTS", 0)
    assert kernels.operators.gather_packs(i32.numel(), [8, 8])
    kernels.reset_launches()
    a, b = kernels.gather_payloads(i32.flip(0), i32, i32.float())
    assert a.dtype == torch.int32 and b.dtype == torch.float32
    equal(a.numpy(), np.arange(8, dtype=np.int32)[::-1])
    equal(b.numpy(), np.arange(8, dtype=np.float32)[::-1])
    assert kernels.pass_launches["gather_payloads_pack"] == 0


# -------------------------------------------------------------- wrappers --

def _cu_constant(source: str, name: str) -> int:
    """The value of ``constexpr int name = a * b;`` (or a literal) in a
    csrc/ source, each factor a literal or another such constant."""
    text = (ROOT / "essentials_tpu_torch" / "csrc" / source).read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    value = 1
    for factor in expr.split("*"):
        factor = factor.strip()
        value *= int(factor) if factor.isdigit() else _cu_constant(source,
                                                                   factor)
    return value


def test_tile_constants_match_the_sources():
    """The wrappers size the scratch with the tiles the kernels use. The
    library checks the same where it loads, on the card only: this is the
    check that runs where no library is built."""
    assert kernels.SCAN_TILE == _cu_constant("operator_kernels.cu",
                                             "kScanTile")
    assert kernels.SCAN_GROUP == _cu_constant("operator_kernels.cu",
                                              "kScanGroup")
    assert kernels.FILL_TILE == _cu_constant("bfs_kernels.cu", "kFillTile")


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 4097, 524_289,
                               7_611_904, 1 << 26])
def test_scan_and_fill_scratch_hold_their_layouts(n):
    """One tile per SCAN_TILE / FILL_TILE started; the scan's scratch holds
    8 bytes a tile, 8 a group of SCAN_GROUP tiles started and the 4-byte
    ticket, the fill's 8 bytes a tile, the ticket and the any-flag, last,
    at byte 8 g + 4."""
    g = kernels.scan_tiles(n)
    assert (g - 1) * kernels.SCAN_TILE < n <= g * kernels.SCAN_TILE or n == 0
    groups = -(-g // kernels.SCAN_GROUP)
    assert (groups - 1) * kernels.SCAN_GROUP < g <= groups * kernels.SCAN_GROUP \
        or g == 0
    assert kernels.scan_scratch_words(n) * 8 >= 8 * (g + groups) + 4
    g = kernels.fill_tiles(n)
    assert (g - 1) * kernels.FILL_TILE < n <= g * kernels.FILL_TILE or n == 0
    fs = kernels.fill_scratch(n, "cpu")
    assert fs.dtype == torch.int32 and fs.numel() * 4 == 8 * g + 8
    assert fs[-1:].data_ptr() - fs.data_ptr() == 8 * g + 4


def test_wrappers_take_plain_version_on_cpu(graphs):
    _, _, g = graphs["directed"]
    kernels.reset_launches()
    x = torch.arange(g.n_vertices_padded, dtype=torch.int32)
    equal(kernels.scan(x).numpy(), kernels.scan_plain(x).numpy())
    a, b = kernels.gather_payloads(g.csc_src_indices, x, x.float())
    equal(a.numpy(), x[g.csc_src_indices.long()].numpy())
    assert b.dtype == torch.float32
    v = torch.ones(g.n_edges_padded)
    equal(kernels.segment_reduce(v, g.csc_offsets, "sum").numpy(),
          g.in_degrees().float().numpy())
    f = t(rng_frontier(g, 22))
    equal(kernels.advance_count(f, g.csc_offsets, g.csc_src_indices).numpy(),
          kernels.advance_count_plain(f, g.csc_offsets,
                                      g.csc_src_indices).numpy())
    assert all(n == 0 for n in kernels.launches.values())


@pytest.mark.parametrize("call", ["scan", "gather", "reduce", "count"])
def test_wrappers_raise_on_other_devices(graphs, call):
    g = graphs["hub"][2].to("meta")
    with pytest.raises(EssentialsError):
        if call == "scan":
            kernels.scan(torch.empty(10, dtype=torch.int32, device="meta"))
        elif call == "gather":
            kernels.gather_payloads(g.csc_src_indices, g.csc_src_indices)
        elif call == "reduce":
            kernels.segment_reduce(torch.empty(g.n_edges_padded,
                                               device="meta"),
                                   g.csc_offsets, "min")
        else:
            kernels.advance_count(torch.empty(g.n_vertices_padded,
                                              dtype=torch.bool,
                                              device="meta"),
                                  g.csc_offsets, g.csc_src_indices)


def test_wrappers_reject_bad_arguments(graphs):
    _, _, g = graphs["hub"]
    i32 = torch.zeros(8, dtype=torch.int32)
    bad = [
        lambda: kernels.scan(i32.long()),
        lambda: kernels.scan(i32, torch.zeros(7, dtype=torch.bool)),
        lambda: kernels.scan(i32, None, "prod"),
        lambda: kernels.gather_payloads(i32),
        lambda: kernels.gather_payloads(i32, *([i32] * 5)),
        lambda: kernels.gather_payloads(i32.long(), i32),
        lambda: kernels.gather_payloads(i32, i32.double()),
        lambda: kernels.segment_reduce(i32.double(), g.csc_offsets, "sum"),
        lambda: kernels.segment_reduce(i32, g.csc_offsets.long(), "sum"),
        lambda: kernels.segment_reduce(i32, g.csc_offsets, "xor"),
        lambda: kernels.advance_count(i32.bool(), g.csc_offsets,
                                      g.csc_src_indices),
        lambda: kernels.advance_count(
            torch.zeros(g.n_vertices_padded, dtype=torch.int32),
            g.csc_offsets, g.csc_src_indices),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(EssentialsError):
            call()
            pytest.fail(f"case {i} did not raise")
