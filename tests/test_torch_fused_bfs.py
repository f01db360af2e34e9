"""Port parity: essentials_tpu_torch.ops.fused_bfs and the kernel wrappers
against essentials_tpu.ops.fused_bfs, level by level, on the CPU.

The port's level writes segment STARTS only (the start-authoritative
contract of fused_superstep2, essentials_tpu/ops/fused_bfs.py:508-511),
while the JAX CPU fallback writes whole segments, so levels are compared at
segment starts. The int8 form's sentinel 127 is mapped to int32 max where it
is held against the int32 JAX fallback. The segment fills and the route OR
(``segment_broadcast_total``, ``suffix_fill_update``, ``fused_route_or``)
are held against the JAX package's Pallas kernels in interpret mode, and the
5-pass level they make against ``bfs_level``. ``bfs_level`` takes the CSR
columns (``col``) for the card's push; on the CPU it runs its plain pull
whatever form ``kernels.bfs.bfs_level_form`` names, and a NumPy model of the
push along ``col`` is held against it, also on degree-balanced directed
graphs (a symmetric layout without a symmetric adjacency), where ``bfs.run``
is held against ``cpu_reference`` and JAX's fused BFS. Every value is an
integer or a copied float32: the tolerance is exact equality."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import essentials_tpu.ops.fused_bfs as jfb
from essentials_tpu.algorithms import bfs as jbfs
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops import cube_router

from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import bfs as tbfs
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import fused_bfs as tfb

INT32_MAX = np.iinfo(np.int32).max
FORMS = {"int32": tfb.UNREACHED, "int8": tfb.UNREACHED_E}

# jitted: the eager CPU path compiles each op of the Pallas-free fallback
_jax_level = jax.jit(jfb.fused_superstep, static_argnames=("unreached",))
_jax_collapse = jax.jit(jfb.collapse_lev_exp, static_argnames=("unreached",))
_jax_pred = jax.jit(jbfs.predecessors_from_distances)


def both_graphs(coo):
    """The JAX graph (with router plans) and the port's graph made from its
    fields, so that both packages compute on the same arrays."""
    gj = jbuild(JCsr.from_coo(coo), directed=False, weighted=False,
                build_router=True)
    assert jbfs.fused_supported(gj)
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return gj, graph_from_arrays(fields, meta, "cpu")


def starts_of(g):
    off = g.row_offsets.numpy()
    return off[:-1][off[1:] > off[:-1]]


def as_int32_levels(lev: torch.Tensor, unreached: int) -> np.ndarray:
    a = lev.numpy().astype(np.int64)
    a[a == unreached] = INT32_MAX
    return a


@pytest.fixture(scope="module")
def graphs():
    return {
        "rmat10": both_graphs(jgen.rmat(10, 8, seed=4, undirected=True,
                                        weighted=False)),
        "grid24": both_graphs(jgen.grid_2d(24)),
    }


@pytest.fixture(scope="module")
def rmat12():
    g = both_graphs(jgen.rmat(12, 10, seed=6, undirected=True,
                              weighted=False))
    assert isinstance(g[0].route_fwd, cube_router.CubePlan)
    return g


def jax_levels(gj, source, max_it=64):
    """The JAX fallback's lev_exp after each level, and its counts."""
    lev = jfb.init_lev_exp(gj, source)
    levs, counts = [], []
    for it in range(max_it):
        lev, cnt = _jax_level(gj, lev, it)
        levs.append(np.asarray(lev))
        counts.append(int(cnt[0, 0]))
        if counts[-1] == 0:
            break
    return levs, counts


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,source", [("rmat10", 0), ("grid24", 0)])
def test_levels_match_jax_fallback(graphs, name, source, form):
    gj, g = graphs[name]
    unreached = FORMS[form]
    starts = starts_of(g)
    levs, counts = jax_levels(gj, source)
    lev = tfb.init_lev_exp(g, source, unreached)
    assert lev.dtype == (torch.int8 if form == "int8" else torch.int32)
    assert np.array_equal(as_int32_levels(lev, unreached),
                          np.asarray(jfb.init_lev_exp(gj, source)))
    for it, (lev_j, cnt_j) in enumerate(zip(levs, counts)):
        lev2, cnt = tfb.fused_superstep(g, lev, it, unreached=unreached)
        assert lev2 is lev                     # in place
        assert cnt.dtype == torch.int32 and cnt.shape == (1,)
        assert int(cnt) == cnt_j, it
        assert np.array_equal(as_int32_levels(lev, unreached)[starts],
                              lev_j[starts]), it
    assert len(counts) > 2 and counts[-1] == 0


@pytest.mark.parametrize("form", ["device", "push", "pull"])
@pytest.mark.parametrize("dtype", sorted(FORMS))
@pytest.mark.parametrize("name,source", [("rmat10", 0), ("grid24", 0)])
def test_bfs_level_with_col_matches_jax_at_starts(graphs, name, source,
                                                  dtype, form, monkeypatch):
    """kernels.bfs_level with ``col`` (its plain version on the CPU) under
    each form the card can take, against JAX's fused_superstep at segment
    starts, level by level, with equal counts."""
    monkeypatch.setattr(kernels.bfs, "bfs_level_form", lambda: form)
    gj, g = graphs[name]
    unreached = FORMS[dtype]
    starts = starts_of(g)
    levs, counts = jax_levels(gj, source)
    lev = tfb.init_lev_exp(g, source, unreached)
    args = (g.row_offsets, g.csc_src_indices, g.col_indices)
    for it, (lev_j, cnt_j) in enumerate(zip(levs, counts)):
        ref = lev.clone()
        cnt = kernels.bfs_level(lev, *args, it, unreached)
        cnt_p = kernels.bfs_level_plain(ref, *args, it, unreached)
        assert torch.equal(lev, ref) and torch.equal(cnt, cnt_p), it
        assert int(cnt) == cnt_j, it
        assert np.array_equal(as_int32_levels(lev, unreached)[starts],
                              lev_j[starts]), it


def push_level(g, lev: np.ndarray, it: int, unreached: int) -> int:
    """The card's push of one level as a NumPy model: every CSR slot of a
    frontier vertex (start at ``it``) reaches its column's start where it
    holds ``unreached``. Updates ``lev`` in place; returns the count."""
    off = g.row_offsets.numpy().astype(np.int64)
    col = g.col_indices.numpy()
    nonempty = off[1:] > off[:-1]
    lv = np.where(nonempty, lev[np.where(nonempty, off[:-1], 0)], unreached)
    rows = np.flatnonzero(nonempty & (lv == it))
    slots = np.concatenate([np.arange(off[u], off[u + 1]) for u in rows]
                           or [np.zeros(0, np.int64)])
    dst = np.unique(col[slots])
    dst = dst[lv[dst] == unreached]
    lev[off[dst]] = it + 1
    return dst.size


def balanced(coo):
    """A degree-balanced directed graph in both packages: the JAX graph
    (with router plans), the port's graph made from its fields, and the
    host CSR."""
    csr = JCsr.from_coo(coo)
    gj = jbuild(csr, directed=True, weighted=False, build_router=True)
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return gj, graph_from_arrays(fields, meta, "cpu"), csr


@pytest.fixture(scope="module")
def directed():
    """The degree-balanced directed graphs of tests/test_torch_kcore.py:
    the 5-cycle with a chord both ways and chip_smoke's union of directed
    cycles over 300 vertices. Every in-degree equals its out-degree (a symmetric
    layout), but col_indices differs from csc_src_indices, so a push along
    csc_src would reach the wrong vertices."""
    from essentials_tpu.formats import Coo as JCoo
    chord = JCoo(5, 5, np.array([0, 1, 2, 3, 4, 0, 2], np.int32),
                 np.array([1, 2, 3, 4, 0, 2, 0], np.int32),
                 np.ones(7, np.float32))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n, src, dst, w = cs.cycles_coo(300, (300, 200, 150, 100, 80, 40), 3)
    out = {"chord_cycle": balanced(chord),
           "cycles300": balanced(JCoo(n, n, src, dst, w))}
    for gj, g, _ in out.values():
        assert g.symmetric_layout and jbfs.fused_supported(gj)
        assert not torch.equal(g.col_indices, g.csc_src_indices)
    return out


@pytest.mark.parametrize("name", ["rmat10", "grid24", "chord_cycle",
                                  "cycles300"])
def test_push_model_walks_col(graphs, directed, name):
    """The card's push (along the frontier's CSR rows, col_indices) gives
    the plain pull's levels and counts at every level, on undirected graphs
    and on degree-balanced directed ones."""
    g = {**graphs, **directed}[name][1]
    source = int(np.argmax(np.diff(g.row_offsets.numpy())[:g.n_vertices]))
    for unreached in FORMS.values():
        lev = tfb.init_lev_exp(g, source, unreached)
        model = lev.numpy().copy()
        for it in range(64):
            cnt = kernels.bfs_level_plain(lev, g.row_offsets,
                                          g.csc_src_indices, g.col_indices,
                                          it, unreached)
            assert push_level(g, model, it, unreached) == int(cnt), it
            assert np.array_equal(model[starts_of(g)],
                                  lev.numpy()[starts_of(g)]), it
            if int(cnt) == 0:
                break
        assert it >= 2


@pytest.mark.parametrize("variant", ["fused", "fused8"])
@pytest.mark.parametrize("name", ["chord_cycle", "cycles300"])
def test_fused_bfs_on_degree_balanced_directed_graphs(directed, name,
                                                      variant):
    """bfs.run fused/fused8 on a directed graph with a symmetric layout:
    against cpu_reference from every source of the chord cycle and a few
    of cycles300, and against JAX's fused BFS (its router plans built)."""
    gj, g, csr = directed[name]
    sources = range(g.n_vertices) if g.n_vertices < 10 else (0, 7, 151)
    for s in sources:
        r = tbfs.run(g, s, variant=variant, max_iterations=64, warmup=False)
        want = tbfs.cpu_reference(csr, s)
        assert np.array_equal(r.distances.numpy(), want), s
        rj = jbfs.run(gj, s, variant="fused", compute_predecessors=False,
                      warmup=False)
        assert np.array_equal(r.distances.numpy(), np.asarray(rj.distances))
        assert r.iterations == rj.iterations
        pred = r.predecessors.numpy()
        reached = (want > 0) & (want != INT32_MAX)
        assert np.all(want[pred[reached]] + 1 == want[reached])


def test_level_matches_pallas_pipeline_int32(rmat12, monkeypatch):
    monkeypatch.setattr(jfb, "_INTERPRET", True)
    gj, g = rmat12
    lev_j, cnt_j = jfb.fused_superstep2(gj, jfb.init_lev_exp(gj, 7), 0)
    lev, cnt = tfb.fused_superstep(g, tfb.init_lev_exp(g, 7), 0)
    starts = starts_of(g)
    assert int(cnt) == int(cnt_j[0, 0]) > 0
    assert np.array_equal(lev.numpy()[starts], np.asarray(lev_j)[starts])


def test_level_matches_pallas_pipeline_int8(rmat12, monkeypatch):
    monkeypatch.setattr(jfb, "_INTERPRET", True)
    gj, g = rmat12
    fp = jfb.pack_flags(gj.csc_seg_flags, gj.route_fwd.length)
    lev_j, cnt_j = jfb.fused_superstep2(
        gj, jfb.init_lev_exp(gj, 7, jfb.UNREACHED_E), 0, swar=True, fp=fp)
    lev, cnt = tfb.fused_superstep(
        g, tfb.init_lev_exp(g, 7, tfb.UNREACHED_E), 0,
        unreached=tfb.UNREACHED_E)
    starts = starts_of(g)
    assert lev.dtype == torch.int8
    assert int(cnt) == int(cnt_j[0, 0]) > 0
    assert np.array_equal(lev.numpy()[starts].astype(np.int32),
                          np.asarray(lev_j)[starts])


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,source", [("rmat10", 0), ("grid24", 0)])
def test_collapse_and_predecessors_match_jax(graphs, name, source, form):
    gj, g = graphs[name]
    unreached = FORMS[form]
    lev_j = jax_levels(gj, source)[0][-1]
    dist_j = np.asarray(_jax_collapse(gj, lev_j, source))
    lev = np.where(lev_j == INT32_MAX, unreached, lev_j)
    lev = torch.from_numpy(lev.astype(np.int8 if form == "int8"
                                      else np.int32))
    dist = tfb.collapse_lev_exp(g, lev, source, unreached)
    assert dist.dtype == torch.int32
    assert np.array_equal(dist.numpy(), dist_j)
    pred = tbfs.predecessors_from_distances(g, dist)
    assert np.array_equal(pred.numpy(), np.asarray(_jax_pred(gj, dist_j)))


def test_collapse_isolated_source():
    from essentials_tpu.formats.coo import Coo
    # mirrored edges, vertex 0 isolated: its segment is empty
    rows = np.array([1, 2, 2, 3], np.int32)
    coo = Coo(8, 8, rows, np.array([2, 1, 3, 2], np.int32),
              np.ones(4, np.float32))
    gj, g = both_graphs(coo)
    lev = tfb.init_lev_exp(g, 0)
    assert torch.all(lev == tfb.UNREACHED)
    dist = tfb.collapse_lev_exp(g, lev, 0)
    assert np.array_equal(dist.numpy(),
                          np.asarray(_jax_collapse(gj, np.asarray(lev), 0)))
    assert dist[0] == 0 and torch.all(dist[1:] == tfb.UNREACHED)


# ---------------------------------------------------------------- wrappers --

def small_graph():
    return both_graphs(jgen.grid_2d(5))[1]


def test_wrappers_take_plain_version_on_cpu():
    g = small_graph()
    kernels.reset_launches()
    lev = tfb.init_lev_exp(g, 0)
    ref = lev.clone()
    cnt = kernels.bfs_level(lev, g.row_offsets, g.csc_src_indices,
                            g.col_indices, 0, tfb.UNREACHED)
    cnt_p = kernels.bfs_level_plain(ref, g.row_offsets, g.csc_src_indices,
                                    g.col_indices, 0, tfb.UNREACHED)
    assert torch.equal(lev, ref) and torch.equal(cnt, cnt_p)
    dist = kernels.collapse_levels(lev, g.row_offsets, 0, tfb.UNREACHED)
    kernels.bfs_predecessors(dist, g.csc_offsets, g.csc_src_indices,
                             g.n_edges)
    assert all(n == 0 for n in kernels.launches.values())


@pytest.mark.parametrize("call", ["level", "collapse", "pred", "broadcast",
                                  "fill_update", "route_or"])
def test_wrappers_raise_on_other_devices(call):
    g = small_graph().to("meta")
    lev = torch.empty(g.n_edges_padded, dtype=torch.int32, device="meta")
    dist = torch.empty(g.n_vertices_padded, dtype=torch.int32, device="meta")
    flags = g.csc_seg_flags
    with pytest.raises(EssentialsError):
        if call == "level":
            kernels.bfs_level(lev, g.row_offsets, g.csc_src_indices,
                              g.col_indices, 0, tfb.UNREACHED)
        elif call == "collapse":
            kernels.collapse_levels(lev, g.row_offsets, 0, tfb.UNREACHED)
        elif call == "pred":
            kernels.bfs_predecessors(dist, g.csc_offsets, g.csc_src_indices,
                                     g.n_edges)
        elif call == "broadcast":
            tfb.segment_broadcast_total(lev, flags)
        elif call == "fill_update":
            tfb.suffix_fill_update(lev, flags, lev, 1)
        else:
            tfb.fused_route_or(g, lev, 0)


def test_bfs_level_rejects_bad_arguments(monkeypatch):
    g = small_graph()
    lev8 = tfb.init_lev_exp(g, 0, tfb.UNREACHED_E)
    off, src, col = g.row_offsets, g.csc_src_indices, g.col_indices
    with pytest.raises(EssentialsError):      # it + 1 would hit the sentinel
        kernels.bfs_level(lev8, off, src, col, 126, tfb.UNREACHED_E)
    with pytest.raises(EssentialsError):      # no int64 form
        kernels.bfs_level(lev8.long(), off, src, col, 0, tfb.UNREACHED)
    with pytest.raises(EssentialsError):      # csc_src of the wrong length
        kernels.bfs_level(lev8, off, src[:-1], col, 0, tfb.UNREACHED_E)
    with pytest.raises(EssentialsError):      # col of the wrong length
        kernels.bfs_level(lev8, off, src, col[:-1], 0, tfb.UNREACHED_E)
    with pytest.raises(EssentialsError):      # col of the wrong type
        kernels.bfs_level(lev8, off, src, col.long(), 0, tfb.UNREACHED_E)
    monkeypatch.setattr(kernels.bfs, "bfs_level_form", lambda: "sideways")
    with pytest.raises(EssentialsError):      # no such form
        kernels.bfs_level(lev8, off, src, col, 0, tfb.UNREACHED_E)


# ------------------------------------------- segment fills and route OR --

def seeded_flags(n: int, seed: int, last_starts: bool) -> np.ndarray:
    """Start flags with flags[0] unset; the last position starts a segment
    of its own or (last_starts False) carries no end flag after it."""
    rng = np.random.default_rng(seed)
    f = rng.random(n) < 0.05
    f[0] = False
    f[-1] = last_starts
    return f


@pytest.mark.parametrize("last_starts", [False, True])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n", [1000, 1 << 14])
def test_segment_broadcast_total_matches_jax(n, dtype, last_starts):
    rng = np.random.default_rng(n)
    s = (rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
         if dtype == "int32" else rng.standard_normal(n).astype(np.float32))
    f = seeded_flags(n, n + 1, last_starts)
    ref = np.asarray(jfb.segment_broadcast_total(s, f))
    kernels.reset_launches()
    out = tfb.segment_broadcast_total(torch.from_numpy(s), torch.from_numpy(f))
    assert kernels.launches["segment_broadcast_total"] == 0   # plain on CPU
    assert out.dtype == torch.from_numpy(s).dtype
    assert out.numpy().tobytes() == ref.tobytes()
    # every position holds its segment's last value
    ends = np.flatnonzero(np.append(f[1:], True))
    assert np.array_equal(out.numpy()[ends], s[ends])


@pytest.mark.parametrize("last_starts", [False, True])
def test_suffix_fill_update_matches_jax(last_starts):
    n = 5000
    rng = np.random.default_rng(3)
    s = rng.integers(0, 3, n).astype(np.int32) * (rng.random(n) < 0.3)
    lev = np.where(rng.random(n) < 0.6, INT32_MAX,
                   rng.integers(0, 4, n)).astype(np.int32)
    f = seeded_flags(n, 4, last_starts)
    lev_j, any_j = jfb.suffix_fill_update(s, f, lev, 5)
    lev_t, any_t = tfb.suffix_fill_update(
        torch.from_numpy(s), torch.from_numpy(f), torch.from_numpy(lev), 5)
    assert lev_t.dtype == torch.int32 and any_t.shape == (1,)
    assert np.array_equal(lev_t.numpy(), np.asarray(lev_j))
    assert int(any_t) == int(np.asarray(any_j)[0, 0]) == 1
    # nothing unreached left to reach: the flag stays 0
    _, any_t = tfb.suffix_fill_update(torch.from_numpy(s), torch.from_numpy(f),
                                      lev_t, 6)
    assert int(any_t) == 0


@pytest.mark.parametrize("it", [0, 2])
def test_fused_route_or_matches_jax(rmat12, it):
    gj, g = rmat12
    rng = np.random.default_rng(it)
    lev = rng.integers(0, 4, g.n_edges_padded).astype(np.int32)
    ref = np.asarray(jax.jit(jfb.fused_route_or)(gj, lev, it))
    out = tfb.fused_route_or(g, torch.from_numpy(lev), it)
    assert out.dtype == torch.int32 and ref.shape == out.shape
    assert np.array_equal(out.numpy(), ref)
    assert 0 < int(out.sum()) < g.n_edges_padded


@pytest.mark.parametrize("name,source", [("rmat10", 0), ("grid24", 0)])
def test_five_pass_level_matches_bfs_level(graphs, name, source):
    gj, g = graphs[name]
    starts = starts_of(g)
    lev = tfb.init_lev_exp(g, source)
    full = lev.clone()             # init_lev_exp fills whole segments
    levs = jax_levels(gj, source)[0]
    for it in range(64):
        cnt = kernels.bfs_level(lev, g.row_offsets, g.csc_src_indices,
                                g.col_indices, it, tfb.UNREACHED)
        full, any_ = tfb.five_pass_superstep(g, full, it)
        assert np.array_equal(full.numpy(), levs[it])
        assert np.array_equal(full.numpy()[starts], lev.numpy()[starts]), it
        assert int(any_) == int(cnt > 0), it
        if int(cnt) == 0:
            break
    assert it > 2
